"""Port parity — field, envelope and circulant construction.

repro_torch.kernels.envelope, repro_torch.core.gf and
repro_torch.core.circulant against repro's, on seeded inputs, exactly.
"""
import numpy as np
import pytest
import torch
from _torch_parity import no_cuda, npy, rand  # noqa: F401 (fixture)

from repro.core import circulant as rc
from repro.core import gf as rgf
from repro.kernels import envelope as renv
from repro_torch.core import circulant as tc
from repro_torch.core import gf as tgf
from repro_torch.exec import staging as tstaging
from repro_torch.kernels import envelope as tenv

PRIMES = [2, 3, 5, 7, 257, 46337]


# ---------------------------------------------------------------- envelope
def test_envelope_constants_match():
    assert tenv.LAZY_F32_CHUNKS == renv.LAZY_F32_CHUNKS == 127
    assert tenv.INT32_MAX_P == renv.INT32_MAX_P == 46341


@pytest.mark.parametrize("p", [2, 5, 257, 4097, 4099, 46337, 46341, 46349])
def test_envelope_terms_match(p):
    assert tenv.int32_lazy_terms(p) == renv.int32_lazy_terms(p)
    assert tenv.f32_exact_terms(p) == renv.f32_exact_terms(p)
    if renv.int32_lazy_terms(p) < 1:
        with pytest.raises(ValueError):
            tenv.require_int32_envelope(p)
    else:
        tenv.require_int32_envelope(p)


# ------------------------------------------------------------ element ops
@pytest.mark.parametrize("p", PRIMES)
def test_elementwise_ops_match(p):
    rng = np.random.default_rng(p)
    x = rng.integers(-10_000, 10_000, size=257).astype(np.int32)
    y = rng.integers(-10_000, 10_000, size=257).astype(np.int32)
    for name in ("add", "sub", "mul"):
        got = getattr(tgf, name)(torch.from_numpy(x), torch.from_numpy(y), p)
        want = getattr(rgf, name)(x, y, p)
        np.testing.assert_array_equal(npy(got), npy(want), err_msg=name)
    np.testing.assert_array_equal(npy(tgf.neg(torch.from_numpy(x), p)),
                                  npy(rgf.neg(x, p)))
    assert npy(tgf.sub(torch.from_numpy(x), torch.from_numpy(y), p)).min() >= 0


@pytest.mark.parametrize("p", [5, 7, 257])
def test_pow_and_inverse_match(p):
    xs = np.arange(0, 3 * p, dtype=np.int32)
    for e in (0, 1, 2, 5, 40):
        np.testing.assert_array_equal(
            npy(tgf.pow_(torch.from_numpy(xs), e, p)), npy(rgf.pow_(xs, e, p)))
    nz = xs[xs % p != 0]
    inv = npy(tgf.inv(torch.from_numpy(nz), p))
    np.testing.assert_array_equal(inv, npy(rgf.inv(nz, p)))
    np.testing.assert_array_equal((nz.astype(np.int64) * inv) % p, 1)


def test_scalar_ops_on_explicit_cpu_device():
    assert int(tgf.add(200, 100, 257, device="cpu")) == 43
    assert int(tgf.neg(1, 257, device="cpu")) == 256


def test_element_op_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgf.add(1, 2, 257)


@pytest.mark.parametrize("p", [5, 257])
@pytest.mark.parametrize("shape", [(3, 4, 5), (8, 128, 16), (1, 300, 2)])
def test_matmul_matches_reference(p, shape):
    m, k, n = shape
    a, b = rand((m, k), p, m * k), rand((k, n), p, k * n)
    np.testing.assert_array_equal(npy(tgf.matmul(a, b, p, device="cpu")),
                                  npy(rgf.matmul(a, b, p)))


# ------------------------------------------------------ host linear algebra
@pytest.mark.parametrize("p", [5, 257])
@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_gauss_inverse_det_solve_match(p, n):
    rng = np.random.default_rng(n + p)
    for _ in range(5):
        m = rng.integers(0, p, size=(n, n))
        assert tgf.gauss_det(m, p) == rgf.gauss_det(m, p)
        if rgf.gauss_det(m, p) == 0:
            with pytest.raises(ValueError):
                tgf.gauss_inverse(m, p)
            continue
        inv = tgf.gauss_inverse(m, p)
        assert inv.dtype == np.int32
        np.testing.assert_array_equal(inv, rgf.gauss_inverse(m, p))
        rhs = rng.integers(0, p, size=(n, 3))
        np.testing.assert_array_equal(tgf.solve(m, rhs, p),
                                      rgf.solve(m, rhs, p))


@pytest.mark.parametrize("shape", [(2, 5), (3, 3), (4, 7), (6, 4)])
def test_nullspace_matches(shape):
    p = 257
    rng = np.random.default_rng(sum(shape))
    m = rng.integers(0, p, size=shape)
    m[-1] = (m[0] * 3) % p                       # force a dependent row
    got = tgf.nullspace(m, p)
    np.testing.assert_array_equal(got, rgf.nullspace(m, p))
    np.testing.assert_array_equal((m.astype(np.int64) @ got) % p, 0)


# ----------------------------------------------------------------- packing
@pytest.mark.parametrize("size", [0, 1, 255, 4096, 10_001])
def test_bytes_symbols_match(size):
    payload = np.random.default_rng(size).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()
    sym = tgf.bytes_to_symbols(payload)
    np.testing.assert_array_equal(sym, rgf.bytes_to_symbols(payload))
    assert tgf.symbols_to_bytes(sym) == payload
    out = np.full(size + 7, -1, np.int32)
    tgf.bytes_to_symbols_into(payload, out)
    np.testing.assert_array_equal(out, rgf.bytes_to_symbols_into(
        payload, np.full(size + 7, -1, np.int32)))
    with pytest.raises(ValueError):
        tgf.bytes_to_symbols(payload, 251)


def test_pack257_byte_identical_including_256():
    sym = rand((5, 333), 257, 3)
    sym[0, :7] = 256                           # the value that needs hi
    sym[3, -1] = 256
    low_t, hi_t = tgf.pack257(sym)
    low_r, hi_r = rgf.pack257(sym)
    assert low_t.tobytes() == low_r.tobytes()
    assert hi_t.tobytes() == hi_r.tobytes()
    np.testing.assert_array_equal(tgf.unpack257(low_t, hi_t, sym.shape), sym)
    assert tgf.packed_nbytes(sym) == rgf.packed_nbytes(sym)
    lows_t, his_t = tgf.pack257_rows(sym)
    lows_r, his_r = rgf.pack257_rows(sym)
    assert lows_t.tobytes() == lows_r.tobytes()
    assert [h.tobytes() for h in his_t] == [h.tobytes() for h in his_r]
    out = np.empty(sym.shape, np.uint8)
    tgf.pack257_rows(sym, out=out)
    assert out.tobytes() == lows_r.tobytes()
    np.testing.assert_array_equal(tgf.unpack257_rows(lows_t, his_t), sym)
    back = np.empty(sym.shape, np.int32)
    tgf.unpack257_rows(lows_t, his_t, out=back)
    np.testing.assert_array_equal(back, sym)
    with pytest.raises(ValueError):
        tgf.pack257(np.asarray([257]))


def test_pack_stage_clock_records():
    tstaging.reset_stage_times()
    tgf.pack257_rows(rand((2, 64), 257, 0))
    assert tstaging.stage_calls()["pack"] == 1
    assert tstaging.stage_times()["pack"] >= 0.0


# -------------------------------------------------------------- circulant
@pytest.mark.parametrize("k,p", [(1, 257), (2, 257), (3, 257), (4, 257),
                                 (5, 257), (8, 257), (2, 5), (3, 5), (3, 7),
                                 (4, 7), (2, 2)])
def test_codespec_same_coefficients_and_matrices(k, p):
    want = rc.CodeSpec.make(k, p)
    got = tc.CodeSpec.make(k, p)
    assert got.c == want.c
    assert (got.n, got.d) == (want.n, want.d)
    np.testing.assert_array_equal(got.matrix_m(), want.matrix_m())
    np.testing.assert_array_equal(got.matrix_a(), want.matrix_a())


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_find_coefficients_same_search(seed):
    for k, p in ((2, 5), (3, 5), (3, 7), (4, 7), (5, 257)):
        np.testing.assert_array_equal(tc.find_coefficients(k, p, seed=seed),
                                      rc.find_coefficients(k, p, seed=seed))


def test_codespec_given_coefficients_and_validation():
    c = rc.CodeSpec.make(8, 257).c
    assert tc.CodeSpec.make(8, 257, c=c).c == c
    with pytest.raises(ValueError):
        tc.CodeSpec.make(2, 5, c=[1, 0])
    assert tc.CodeSpec.make(3, 5, c=[1, 1, 2]).c == (1, 1, 2)


def test_condition6_and_field_size_match():
    for c, p in (([1, 1], 2), ([1, 1, 2], 5), ([0, 1], 5), ([1, 2, 3], 7)):
        assert tc.check_condition6(c, p) == rc.check_condition6(c, p)
    assert tc.min_field_size(2) == rc.min_field_size(2) == 2
    assert tc.min_field_size(3) == rc.min_field_size(3)
    for k in (2, 3, 5):
        n = 2 * k
        for i in range(1, n + 1):
            assert tc.redundancy_support(i, n) == rc.redundancy_support(i, n)
            assert tc.node_columns(i, n) == rc.node_columns(i, n)
    for s in ((1, 2), (2, 4), (1, 3)):
        assert tc.submatrix_condition_det([3, 4], s, 257) == \
            rc.submatrix_condition_det([3, 4], s, 257)
