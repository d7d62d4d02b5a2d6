"""Port parity — the two kernel modules.

repro_torch.kernels.gf_matmul / circulant_encode against the reference's
Pallas kernels in interpret mode and its jnp oracles (repro.kernels.ref),
exactly.  On this host the wrappers get CPU tensors and run their plain
versions; the CUDA kernels themselves are held to the same plain versions
by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import npy, rand, t

from repro.kernels import circulant_encode as rce
from repro.kernels import gf_matmul as rgm
from repro.kernels import ref as rref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.circulant_encode import circulant_encode
from repro_torch.kernels.gf_matmul import gf_matmul


def int64_matmul(a, b, p):
    return (a.astype(np.int64) @ b.astype(np.int64)) % p


# --------------------------------------------------------------- gf_matmul
@pytest.mark.parametrize("p", [5, 257])
@pytest.mark.parametrize("m,k,s", [
    (4, 4, 128), (8, 8, 512), (6, 6, 1000),       # unaligned stream
    (16, 16, 4096), (3, 300, 640),                # k > fold depth
    (1, 7, 130), (128, 128, 256), (2, 8, 4099),
])
def test_gf_matmul_matches_reference_oracle(p, m, k, s):
    a = rand((m, k), p, seed=m * k + s)
    b = rand((k, s), p, seed=m + k + s)
    got = npy(gf_matmul(t(a), t(b), p))
    np.testing.assert_array_equal(got, npy(rref.gf_matmul_ref(
        jnp.asarray(a), jnp.asarray(b), p)))
    np.testing.assert_array_equal(got, int64_matmul(a, b, p))


@pytest.mark.parametrize("p,m,k,s", [
    (257, 6, 6, 1000), (257, 3, 300, 640), (257, 1, 7, 130), (5, 16, 16, 520),
])
def test_gf_matmul_matches_pallas_interpret(p, m, k, s):
    a = rand((m, k), p, seed=s)
    b = rand((k, s), p, seed=s + 1)
    np.testing.assert_array_equal(
        npy(gf_matmul(t(a), t(b), p)),
        npy(rgm.gf_matmul(a, b, p, interpret=True)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.int16])
def test_gf_matmul_input_dtypes(dtype):
    p = 257
    a = rand((4, 8), p, 0).astype(dtype)
    b = rand((8, 256), p, 1).astype(dtype)
    got = npy(ops.gf_matmul(a, b, p, device="cpu"))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, int64_matmul(a, b, p))
    np.testing.assert_array_equal(got, npy(rgm.gf_matmul(
        a.astype(np.int32), b.astype(np.int32), p, interpret=True)))


@pytest.mark.parametrize("p", [257, 46337])
def test_gf_matmul_worst_case_magnitudes(p):
    """All-(p-1) entries across fold boundaries stay exact — at p = 46337
    the int32 schedule folds after every single term."""
    for k in (127, 128, 129, 255, 256, 300):
        a = np.full((2, k), p - 1, np.int32)
        b = np.full((k, 384), p - 1, np.int32)
        got = npy(gf_matmul(t(a), t(b), p))
        np.testing.assert_array_equal(got, int64_matmul(a, b, p),
                                      err_msg=f"k={k}")
        np.testing.assert_array_equal(got, npy(rref.gf_matmul_ref(
            jnp.asarray(a), jnp.asarray(b), p)))


def test_gf_matmul_reduces_unreduced_inputs_like_reference():
    p = 257
    rng = np.random.default_rng(3)
    a = rng.integers(-1000, 1000, (3, 5)).astype(np.int32)
    b = rng.integers(-1000, 1000, (5, 40)).astype(np.int32)
    np.testing.assert_array_equal(npy(gf_matmul(t(a), t(b), p)),
                                  npy(rref.gf_matmul_ref(a, b, p)))


@pytest.mark.parametrize("shared", [True, False])
def test_gf_matmul_batched(shared):
    p, f, m, k, s = 257, 3, 2, 8, 777
    b = rand((f, k, s), p, 11)
    a = rand((m, k), p, 12) if shared else rand((f, m, k), p, 13)
    got = npy(gf_matmul(t(a), t(b), p))
    assert got.shape == (f, m, s)
    for i in range(f):
        ai = a if shared else a[i]
        np.testing.assert_array_equal(got[i], npy(rref.gf_matmul_ref(
            jnp.asarray(ai), jnp.asarray(b[i]), p)))


def test_gf_matmul_p_bounds():
    a, b = rand((2, 4), 46337, 0), rand((4, 8), 46337, 1)
    np.testing.assert_array_equal(npy(gf_matmul(t(a), t(b), 46337)),
                                  int64_matmul(a, b, 46337))
    with pytest.raises(ValueError, match="46341"):
        gf_matmul(t(a), t(b), 65537)
    with pytest.raises(ValueError):
        rref.gf_matmul_ref(jnp.asarray(a), jnp.asarray(b), 65537)


def test_gf_matmul_wrapper_rejects_bad_arguments():
    a, b = t(rand((2, 4), 257, 0)), t(rand((4, 8), 257, 1))
    with pytest.raises(TypeError, match="int32"):
        gf_matmul(a.long(), b, 257)
    with pytest.raises(TypeError):
        gf_matmul(np.zeros((2, 4), np.int32), b, 257)
    with pytest.raises(ValueError, match="contiguous"):
        gf_matmul(a, t(rand((8, 4), 257, 2)).T, 257)
    with pytest.raises(ValueError, match="contraction"):
        gf_matmul(a, t(rand((5, 8), 257, 3)), 257)
    with pytest.raises(ValueError, match="batch"):
        gf_matmul(t(rand((3, 2, 4), 257, 4)), t(rand((2, 4, 8), 257, 5)), 257)
    with pytest.raises(ValueError):
        gf_matmul(t(rand((3, 2, 4), 257, 4)), b, 257)
    with pytest.raises(ValueError, match="on cuda or cpu"):
        gf_matmul(a.to("meta"), b.to("meta"), 257)


def test_cpu_tensors_never_launch():
    before = (gf_matmul.launches, circulant_encode.launches)
    gf_matmul(t(rand((2, 4), 257, 0)), t(rand((4, 8), 257, 1)), 257)
    circulant_encode(t(rand((4, 8), 257, 2)), (1, 2), 257)
    assert (gf_matmul.launches, circulant_encode.launches) == before


# --------------------------------------------------------- circulant_encode
@pytest.mark.parametrize("p", [5, 257])
@pytest.mark.parametrize("k,s", [(1, 128), (2, 512), (3, 1000), (8, 4096),
                                 (16, 384), (64, 256)])
def test_circulant_encode_matches_reference_oracle(p, k, s):
    rng = np.random.default_rng(k + s)
    c = tuple(int(x) for x in rng.integers(1, p, size=k))
    data = rand((2 * k, s), p, seed=k * s)
    np.testing.assert_array_equal(
        npy(circulant_encode(t(data), c, p)),
        npy(rref.circulant_encode_ref(jnp.asarray(data), c, p)))


@pytest.mark.parametrize("p,k,s", [(257, 2, 512), (257, 3, 1000),
                                   (5, 8, 700), (257, 8, 4099)])
def test_circulant_encode_matches_pallas_interpret(p, k, s):
    c = tuple(int(x) for x in np.random.default_rng(s).integers(1, p, size=k))
    data = rand((2 * k, s), p, seed=s)
    np.testing.assert_array_equal(
        npy(circulant_encode(t(data), c, p)),
        npy(rce.circulant_encode(data, c, p, interpret=True)))


def test_circulant_encode_matches_dense_mt():
    from repro_torch.core.circulant import CodeSpec
    for k, p in [(2, 257), (3, 5), (5, 257)]:
        spec = CodeSpec.make(k, p)
        data = rand((2 * k, 700), p, seed=k)
        dense = int64_matmul(spec.matrix_m().T, data, p)
        np.testing.assert_array_equal(
            npy(circulant_encode(t(data), spec.c, p)), dense)


@pytest.mark.parametrize("p", [257, 46337])
def test_circulant_encode_worst_case_fold(p):
    from repro.core.circulant import circulant_matrix
    k = 130
    c = tuple([p - 1] * k)
    data = np.full((2 * k, 256), p - 1, np.int32)
    np.testing.assert_array_equal(
        npy(circulant_encode(t(data), c, p)),
        int64_matmul(circulant_matrix(c, p).T, data, p))


def test_circulant_encode_rejections_match_reference():
    data = t(np.zeros((4, 128), np.int32))
    with pytest.raises(ValueError, match="nonzero"):
        circulant_encode(data, (1, 0), 257)
    with pytest.raises(ValueError, match="nonzero"):
        rce.circulant_encode(np.zeros((4, 128), np.int32), (1, 257), 257)
    with pytest.raises(ValueError, match="nonzero"):
        circulant_encode(data, (1, 257), 257)      # 0 mod p
    with pytest.raises(ValueError, match="2k"):
        circulant_encode(data, (1, 2, 3), 257)
    with pytest.raises(ValueError, match="46341"):
        circulant_encode(data, (1, 2), 65537)
    with pytest.raises(TypeError, match="int32"):
        circulant_encode(data.long(), (1, 2), 257)
    with pytest.raises(ValueError, match="nonzero"):
        ops.circulant_encode(np.zeros((4, 8), np.int32), (0, 1), 257,
                             device="cpu")


# ------------------------------------------------------------------ build
def test_build_paths_are_content_keyed():
    for name in _build.SOURCES:
        so = _build.library_path(name)
        assert so.parent == _build.BUILD_DIR
        assert so.name.startswith(name + "-") and so.suffix == ".so"
        assert so == _build.library_path(name)
        assert (_build.CSRC / f"{name}.cu").exists()
