"""Port parity -- GF(2^8) (``repro_torch.core.gf256``) against the
reference's ``repro.core.gf256``: every case of tests/test_gf256.py as a
twin on the port's side (on the CPU), then the tables and ``mul`` /
``inv`` / ``matmul`` / ``gauss_inverse`` bit-identical to the reference's
on seeded numpy inputs.  Tolerance: none."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import gf256 as rgf
from repro_torch.core import gf256

CPU = dict(device="cpu")


# --------------------------------------- tests/test_gf256.py, twinned
@given(st.integers(0, 255), st.integers(0, 255), st.integers(0, 255))
@settings(max_examples=80, deadline=None)
def test_field_axioms(a, b, c):
    def m(x, y):
        return gf256.mul(x, y, **CPU)

    def add(x, y):
        return gf256.add(x, y, **CPU)
    assert int(add(a, b)) == a ^ b
    assert int(m(m(a, b), c)) == int(m(a, m(b, c)))
    assert int(m(a, add(b, c))) == int(add(m(a, b), m(a, c)))
    assert int(m(a, 1)) == a


def test_known_aes_products():
    assert int(gf256.mul(0x57, 0x83, **CPU)) == 0xC1
    assert int(gf256.mul(0x02, 0x80, **CPU)) == 0x1B
    assert int(gf256.mul(0x53, 0xCA, **CPU)) == 0x01   # inverse pair


@given(st.integers(1, 255))
@settings(max_examples=60, deadline=None)
def test_inverse(a):
    assert int(gf256.mul(a, gf256.inv(a, **CPU))) == 1


def test_matmul_against_scalar_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (5, 7)).astype(np.int32)
    b = rng.integers(0, 256, (7, 9)).astype(np.int32)
    got = gf256.matmul(a, b, **CPU).numpy()
    want = np.zeros((5, 9), np.int32)
    for i in range(5):
        for j in range(9):
            acc = 0
            for t in range(7):
                acc ^= int(gf256.mul(int(a[i, t]), int(b[t, j]), **CPU))
            want[i, j] = acc
    np.testing.assert_array_equal(got, want)


def test_gauss_inverse_roundtrip():
    rng = np.random.default_rng(1)
    for _ in range(3):
        m = rng.integers(0, 256, (6, 6)).astype(np.int32)
        try:
            inv = gf256.gauss_inverse(m)
        except ValueError:
            continue
        eye = gf256.matmul(torch.from_numpy(m), torch.from_numpy(inv))
        np.testing.assert_array_equal(eye.numpy(), np.eye(6, dtype=np.int32))


def test_mds_code_over_gf256():
    rng = np.random.default_rng(2)
    k, s = 4, 64
    data = rng.integers(0, 256, (k, s)).astype(np.int32)
    g = rng.integers(0, 256, (k, k)).astype(np.int32)
    while True:
        try:
            ginv = gf256.gauss_inverse(g)
            break
        except ValueError:
            g = rng.integers(0, 256, (k, k)).astype(np.int32)
    coded = gf256.matmul(torch.from_numpy(g), torch.from_numpy(data))
    back = gf256.matmul(torch.from_numpy(ginv), coded)
    np.testing.assert_array_equal(back.numpy(), data)


# ------------------------------------------------ parity with the reference
def test_tables_equal_reference():
    for mine, theirs in zip(gf256._tables(), rgf._tables()):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)


def test_mul_inv_add_exhaustive_equal_reference():
    x = np.arange(256, dtype=np.int32)
    a, b = np.meshgrid(x, x, indexing="ij")
    got = gf256.mul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(rgf.mul(a, b)))
    np.testing.assert_array_equal(gf256.inv(x, **CPU).numpy(),
                                  np.asarray(rgf.inv(x)))
    np.testing.assert_array_equal(gf256.add(a, b, **CPU).numpy(),
                                  np.asarray(rgf.add(a, b)))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 2, 3), (5, 7, 9),
                                   (8, 16, 33), (3, 31, 64), (16, 16, 257)])
def test_matmul_equal_reference(m, k, n):
    rng = np.random.default_rng(1000 + 31 * m + k + n)
    a = rng.integers(0, 256, (m, k)).astype(np.int32)
    b = rng.integers(0, 256, (k, n)).astype(np.int32)
    got = gf256.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rgf.matmul(a, b)))


@pytest.mark.parametrize("seed", range(4))
def test_gauss_inverse_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 3, 6, 9):
        m = rng.integers(0, 256, (n, n)).astype(np.int32)
        try:
            want = rgf.gauss_inverse(m)
        except ValueError:
            with pytest.raises(ValueError):
                gf256.gauss_inverse(m)
            continue
        np.testing.assert_array_equal(gf256.gauss_inverse(m), want)


def test_singular_raises_like_reference():
    m = np.array([[1, 2], [1, 2]], np.int32)
    with pytest.raises(ValueError):
        rgf.gauss_inverse(m)
    with pytest.raises(ValueError):
        gf256.gauss_inverse(m)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert gf256.mul(3, 5).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            gf256.mul(3, 5)
