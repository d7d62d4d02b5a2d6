"""Port parity — dispatch and ops.

Selection rules of repro_torch.kernels.dispatch (device -> backend,
env-var pin, fold counts) and bit-exact parity of both registered
backends with the reference's oracles across fields, code dimensions
and odd stream sizes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import no_cuda, npy, rand, t  # noqa: F401 (fixture)

from repro.kernels import dispatch as rdispatch
from repro.kernels import ref as rref
from repro_torch.core import gf as tgf
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.circulant_encode import circulant_encode
from repro_torch.kernels.gf_matmul import gf_matmul

BACKENDS = ["torch-int32", "cuda"]   # `cuda` on CPU tensors: plain versions
STREAMS = [1, 37, 257, 640]


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("p", [2, 5, 257])
@pytest.mark.parametrize("k", [2, 8])
def test_matmul_parity(backend, p, k):
    be = dispatch.get(backend)
    for s in STREAMS:
        a = rand((2 * k, 2 * k), p, seed=k + s)
        b = rand((2 * k, s), p, seed=k * s + 1)
        np.testing.assert_array_equal(
            npy(be.matmul(t(a), t(b), p)),
            npy(rref.gf_matmul_ref(jnp.asarray(a), jnp.asarray(b), p)),
            err_msg=f"{backend} p={p} k={k} s={s}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("p", [2, 5, 257])
@pytest.mark.parametrize("k", [2, 8])
def test_circulant_parity(backend, p, k):
    be = dispatch.get(backend)
    rng = np.random.default_rng(p * k)
    c = tuple(int(x) for x in rng.integers(1, p, size=k))
    for s in STREAMS:
        data = rand((2 * k, s), p, seed=p + k + s)
        np.testing.assert_array_equal(
            npy(be.circulant_encode(t(data), c, p)),
            npy(rref.circulant_encode_ref(jnp.asarray(data), c, p)),
            err_msg=f"{backend} p={p} k={k} s={s}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_axpy_parity(backend):
    be = dispatch.get(backend)
    for p in (2, 5, 257, 46337):
        y, x = rand((199,), p, 0), rand((199,), p, 1)
        alpha = int(rand((), p, 2))
        np.testing.assert_array_equal(
            npy(be.axpy(t(y), alpha, t(x), p)),
            npy(rref.gf_axpy_ref(jnp.asarray(y), alpha, jnp.asarray(x), p)))


def test_int32_envelope_boundary_p_too_large():
    """p > 46341: a single product overflows int32 — everything rejects."""
    p = 65537
    a, b = t(rand((2, 4), p, 0)), t(rand((4, 8), p, 1))
    for name in BACKENDS:
        be = dispatch.get(name)
        with pytest.raises(ValueError):
            be.matmul(a, b, p)
        with pytest.raises(ValueError):
            be.axpy(a[0], 3, a[1], p)
    with pytest.raises(ValueError):
        dispatch.select(p, 2, "cpu")
    with pytest.raises(ValueError):
        dispatch.fold_count("cuda", p, 8)
    with pytest.raises(ValueError):
        tgf.matmul(a, b, p)


# -------------------------------------------------------------- selection
def test_cpu_device_selects_plain_backend():
    for p in (2, 5, 257, 4099, 46337):
        for k in (None, 2, 8, 256):
            assert dispatch.select(p, k, "cpu").name == "torch-int32"
            assert dispatch.select(p, k, torch.device("cpu")).name == \
                "torch-int32"


def test_cuda_device_selects_kernels_without_launching(monkeypatch):
    """The automatic rule never hands the plain backend to a CUDA device,
    and choosing launches nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    before = (gf_matmul.launches, circulant_encode.launches)
    for p in (2, 257, 4099, 46337):
        for k in (None, 2, 8, 256):
            be = dispatch.select(p, k, "cuda")
            assert be.name == "cuda"
            assert be.matmul is gf_matmul
    assert dispatch.get_backend(p=257, device="cuda:0").name == "cuda"
    assert (gf_matmul.launches, circulant_encode.launches) == before


def test_default_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.select(257, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.gf_matmul(np.eye(2, dtype=np.int32), np.ones((2, 3), np.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.circulant_encode(np.ones((4, 3), np.int32), (1, 2))


def test_env_override(monkeypatch):
    monkeypatch.setenv(dispatch.ENV_VAR, "cuda")
    assert dispatch.select(257, 8, "cpu").name == "cuda"
    monkeypatch.setenv(dispatch.ENV_VAR, "no-such-backend")
    with pytest.raises(ValueError, match="cuda.*torch-int32"):
        dispatch.select(257, 8, "cpu")
    assert dispatch.ENV_VAR != rdispatch.ENV_VAR    # the port's own pin


def test_set_default_backend_override():
    try:
        dispatch.set_default_backend("cuda")
        assert dispatch.select(257, 8, "cpu").name == "cuda"
    finally:
        dispatch.set_default_backend(None)
    assert dispatch.select(257, 8, "cpu").name == "torch-int32"
    with pytest.raises(KeyError):
        dispatch.set_default_backend("bogus")
    assert dispatch.registered_backends() == ["cuda", "torch-int32"]


@pytest.mark.parametrize("p", [2, 257, 4099, 46337])
@pytest.mark.parametrize("k", [1, 8, 512, 32767, 32768, 100_000])
def test_fold_count_follows_int32_rule(p, k):
    want = rdispatch.fold_count("jnp-int32", p, k)
    for name in BACKENDS:
        assert dispatch.fold_count(name, p, k) == want


def test_fold_count_accounting():
    assert dispatch.int32_lazy_terms(257) == 32767
    assert dispatch.fold_count("cuda", 257, 512) == 1
    assert dispatch.fold_count("cuda", 257, 100_000) == 4
    assert dispatch.fold_count("cuda", 46337, 16) == 16   # fold every term
    with pytest.raises(KeyError):
        dispatch.fold_count("pallas", 257, 8)


# ------------------------------------------------------------- integration
def test_msr_code_uses_dispatch_and_agrees():
    spec = CodeSpec.make(3, 257)
    auto = DoubleCirculantMSR(spec, device="cpu")
    assert auto.backend_name == "torch-int32"
    pinned = DoubleCirculantMSR(spec, backend="cuda", device="cpu")
    assert pinned.backend_name == "cuda"
    data = rand((6, 333), 257, seed=5)
    np.testing.assert_array_equal(npy(auto.encode(data)),
                                  npy(pinned.encode(data)))
    custom = DoubleCirculantMSR(spec, matmul=tgf.matmul, device="cpu")
    assert custom.backend_name == "custom"
    np.testing.assert_array_equal(npy(auto.encode(data)),
                                  npy(custom.encode(data)))


def test_ops_backend_pinning_and_tensor_device():
    a, b = rand((4, 8), 257, 0), rand((8, 129), 257, 1)
    want = (a.astype(np.int64) @ b.astype(np.int64)) % 257
    for backend in BACKENDS:
        got = ops.gf_matmul(a, b, 257, backend=backend, device="cpu")
        assert got.device.type == "cpu" and got.dtype == torch.int32
        np.testing.assert_array_equal(npy(got), want)
    # a tensor argument carries its device: no device= needed
    np.testing.assert_array_equal(npy(ops.gf_matmul(t(a), t(b), 257)), want)
    mm = ops.msr_matmul_backend(257, device="cpu")
    np.testing.assert_array_equal(npy(mm(a, b)), want)
    y, x = rand((50,), 257, 3), rand((50,), 257, 4)
    np.testing.assert_array_equal(
        npy(ops.gf_axpy(y, 9, x, 257, device="cpu")),
        (y.astype(np.int64) + 9 * x) % 257)
