"""Port parity — the slice end to end (encode -> regenerate -> any-k decode).

repro_torch.core.msr / repair against repro.core.msr / repair at
k in {2, 3, 4, 8}: encode, every node regenerated singly and batched,
reconstruction from k-subsets, one-matmul multi-failure repair, file
round trips, and shares crossing between the packages in both directions
— all bit-exact.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
from _torch_parity import no_cuda, npy, rand  # noqa: F401 (fixture)

from repro.core import msr as rmsr
from repro.core import repair as rrepair
from repro.core.circulant import CodeSpec as RSpec
from repro_torch.core import gf as tgf
from repro_torch.core import msr as tmsr
from repro_torch.core import repair as trepair
from repro_torch.core.circulant import CodeSpec

P = 257
KS = (2, 3, 4, 8)


def pair(k, p=P, c=None):
    """(reference code, port code on the CPU) for one spec."""
    return (rmsr.DoubleCirculantMSR(RSpec.make(k, p, c=c)),
            tmsr.DoubleCirculantMSR(CodeSpec.make(k, p, c=c), device="cpu"))


def helpers(code, data, red, nodes):
    plans = [code.repair_plan(i) for i in nodes]
    return (np.stack([red[pl.prev_node - 1] for pl in plans]),
            np.stack([data[list(pl.data_indices)] for pl in plans]))


# ------------------------------------------------------------------ encode
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("s", [1, 48, 333])
def test_encode_matches(k, s):
    rc, tc = pair(k)
    data = rand((2 * k, s), P, k * s)
    got = tc.encode(data)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(npy(got), npy(rc.encode(data)))
    np.testing.assert_array_equal(npy(tc.encode_planned(data).host()),
                                  npy(rc.encode(data)))


def test_encode_rejects_wrong_block_count():
    _, tc = pair(3)
    with pytest.raises(ValueError, match="data blocks"):
        tc.encode(np.zeros((5, 4), np.int32))


def test_paper_examples():
    """[4,2] (Fig. 3) and [6,3] over F_5 with the matrix-A coefficients."""
    _, tc = pair(2, c=[1, 1])
    a = np.arange(4, dtype=np.int32).reshape(4, 1) + 10
    assert npy(tc.encode(a))[:, 0].tolist() == [23, 25, 23, 21]
    _, tc = pair(3, p=5, c=[1, 1, 2])
    a = np.arange(6, dtype=np.int32).reshape(6, 1)
    r = npy(tc.encode(a))[:, 0]
    for i in range(1, 7):
        assert r[i - 1] == sum(tc.spec.c[u - 1] * ((i - 3 - u) % 6)
                               for u in range(1, 4)) % 5


# -------------------------------------------------------------- regenerate
@pytest.mark.parametrize("k", KS)
def test_regenerate_every_node_singly(k):
    rc, tc = pair(k)
    n = 2 * k
    data = rand((n, 37), P, k)
    red = npy(rc.encode(data))
    for i in range(1, n + 1):
        assert dataclasses.asdict(tc.repair_plan(i)) == \
            dataclasses.asdict(rc.repair_plan(i))
        r_prev, nxt = helpers(rc, data, red, [i])
        a_f, r_f = tc.regenerate(i, r_prev[0], nxt[0])
        a_u, r_u = tc.regenerate_reference(i, r_prev[0], nxt[0])
        a_r, r_r = rc.regenerate(i, r_prev[0], nxt[0])
        for got in (a_f, a_u):
            np.testing.assert_array_equal(npy(got), npy(a_r))
        for got in (r_f, r_u):
            np.testing.assert_array_equal(npy(got), npy(r_r))
        np.testing.assert_array_equal(npy(a_f), data[i - 1])
        np.testing.assert_array_equal(npy(r_f), red[i - 1])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("tile", [None, 7, 48])
def test_regenerate_batch_matches(k, tile):
    rc, tc = pair(k)
    n = 2 * k
    data = rand((n, 48), P, k + 100)
    red = npy(rc.encode(data))
    nodes = list(range(1, n + 1))
    r_prevs, nxt = helpers(rc, data, red, nodes)
    got = npy(tc.regenerate_batch(nodes, r_prevs, nxt, tile_symbols=tile))
    assert got.shape == (n, 2, 48)
    np.testing.assert_array_equal(got, npy(rc.regenerate_batch(
        nodes, r_prevs, nxt, tile_symbols=tile)))
    np.testing.assert_array_equal(got[:, 0], data)
    np.testing.assert_array_equal(got[:, 1], red)


def test_regenerate_validation():
    rc, tc = pair(2)
    data = rand((4, 16), P, 3)
    red = npy(rc.encode(data))
    r_prevs, nxt = helpers(rc, data, red, [2, 4])
    with pytest.raises(ValueError):
        tc.regenerate_batch([2], r_prevs, nxt)
    with pytest.raises(ValueError, match="helper"):
        tc.regenerate(1, r_prevs[0], nxt[0][:1])
    with pytest.raises(ValueError):
        tc.repair_plan(5)


def test_repair_matrix_matches_and_is_node_invariant():
    for k in KS:
        rc, tc = pair(k)
        r = trepair.build_repair_matrix(tc.spec)
        assert r.dtype == np.int32 and r.shape == (2, k + 1)
        np.testing.assert_array_equal(r, rrepair.build_repair_matrix(rc.spec))
        for i in (1, 2 * k):
            np.testing.assert_array_equal(tc.repair.repair_matrix(i), r)
    with pytest.raises(ValueError):
        tc.repair.repair_matrix(2 * k + 1)


def test_custom_matmul_routes_every_field_op():
    calls = []

    def mm(a, b, p):
        calls.append(tuple(a.shape))
        return tgf.matmul(a, b, p)

    spec = CodeSpec.make(3, P)
    code = tmsr.DoubleCirculantMSR(spec, matmul=mm, device="cpu")
    data = rand((6, 32), P, 1)
    red = npy(code.encode(data))
    assert calls == [(6, 6)]                 # dense M^T encode
    r_prev, nxt = helpers(code, data, red, [2])
    calls.clear()
    a_new, r_new = code.regenerate(2, r_prev[0], nxt[0])
    np.testing.assert_array_equal(npy(a_new), data[1])
    np.testing.assert_array_equal(npy(r_new), red[1])
    assert calls == [(2, spec.k + 1)]        # ONE stacked product


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("k,p,c", [(2, 257, None), (3, 257, None),
                                   (2, 257, [1, 1]), (3, 5, [1, 1, 2])])
def test_reconstruct_every_k_subset(k, p, c):
    rc, tc = pair(k, p, c)
    n = 2 * k
    data = rand((n, 7), p, k)
    red = npy(rc.encode(data))
    for s in itertools.combinations(range(1, n + 1), k):
        idx = [i - 1 for i in s]
        got = npy(tc.reconstruct(list(s), data[idx], red[idx]))
        np.testing.assert_array_equal(got, data, err_msg=str(s))
        np.testing.assert_array_equal(
            got, npy(rc.reconstruct(list(s), data[idx], red[idx])))


@pytest.mark.parametrize("k", [4, 8])
def test_reconstruct_seeded_subsets(k):
    rc, tc = pair(k)
    n = 2 * k
    rng = np.random.default_rng(k)
    data = rand((n, 64), P, k)
    red = npy(rc.encode(data))
    for _ in range(6):
        s = [int(x) + 1 for x in rng.choice(n, size=k, replace=False)]
        idx = [i - 1 for i in s]                   # unsorted: cache canonicalizes
        got = npy(tc.reconstruct(s, data[idx], red[idx]))
        np.testing.assert_array_equal(got, data, err_msg=str(s))
        np.testing.assert_array_equal(
            tc.repair.decode_matrix(sorted(s)),
            rc.repair.decode_matrix(sorted(s)))
    with pytest.raises(ValueError):
        tc.reconstruct([1] * k, data[:k], red[:k])


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("n_failed", [1, 2, 4])
def test_reconstruct_with_repair_matches(k, n_failed):
    rc, tc = pair(k)
    n = 2 * k
    data = rand((n, 40), P, n_failed)
    red = npy(rc.encode(data))
    failed = list(range(1, n_failed + 1))
    use = [i for i in range(1, n + 1) if i not in failed][:k]
    idx = [i - 1 for i in use]
    np.testing.assert_array_equal(tc.repair.decode_repair_matrix(use, failed),
                                  rc.repair.decode_repair_matrix(use, failed))
    got_data, got_red = tc.reconstruct_with_repair(use, data[idx], red[idx],
                                                   failed)
    np.testing.assert_array_equal(npy(got_data), data)
    np.testing.assert_array_equal(npy(got_red),
                                  red[[f - 1 for f in failed]])


def test_repeated_reconstruct_single_gauss_inverse(monkeypatch):
    calls = []
    real = tgf.gauss_inverse
    monkeypatch.setattr(tgf, "gauss_inverse",
                        lambda m, p: (calls.append(1), real(m, p))[1])
    _, tc = pair(4)
    data = rand((8, 24), P, 5)
    red = npy(tc.encode(data))

    def rec(ids):
        idx = [i - 1 for i in ids]
        np.testing.assert_array_equal(
            npy(tc.reconstruct(ids, data[idx], red[idx])), data)

    rec([1, 3, 5, 7])
    rec([1, 3, 5, 7])
    rec([7, 1, 5, 3])          # same subset, other order: still cached
    assert len(calls) == 1
    info = tc.repair.decode_cache.cache_info()
    assert (info.hits, info.misses, info.size) == (2, 1, 1)
    rec([2, 4, 6, 8])
    assert len(calls) == 2


def test_decode_cache_lru_and_family_stats():
    spec = CodeSpec.make(2, P)
    code = tmsr.DoubleCirculantMSR(spec, inverse_cache_size=2, device="cpu")
    cache = code.repair.decode_cache
    cache.inverse((1, 2))
    cache.inverse((1, 3))
    cache.inverse((1, 2))
    cache.inverse((1, 4))      # evicts (1, 3)
    assert cache.cache_info().size == 2
    misses = cache.cache_info().misses
    cache.inverse((1, 3))
    assert cache.cache_info().misses == misses + 1
    with pytest.raises(ValueError):
        cache.inverse((2, 1))
    assert cache.family == rrepair.DecodeInverseCache(
        RSpec.make(2, P)).family
    assert trepair.decode_cache_stats()[cache.family].misses >= 4
    gm = trepair.DecodeInverseCache(matrix_fn=lambda s: np.eye(2), k=2, p=P)
    np.testing.assert_array_equal(gm.inverse((1, 2)), np.eye(2))
    assert gm.family == "generator-matrix"
    with pytest.raises(ValueError):
        trepair.DecodeInverseCache(spec, matrix_fn=lambda s: s)


# ------------------------------------------------------------- accounting
def test_msr_point_accounting_and_support():
    for k in (2, 3, 8):
        rc, tc = pair(k)
        for s in (1, 100):
            assert tc.alpha_symbols(s) == rc.alpha_symbols(s) == 2 * s
            assert tc.gamma_regenerate_symbols(s) == \
                rc.gamma_regenerate_symbols(s)
            assert tc.gamma_reconstruct_symbols(s) == \
                rc.gamma_reconstruct_symbols(s)
        assert tc.verify_support()
    data = rand((16, 5), P, 0)
    np.testing.assert_array_equal(npy(tc.systematic_read(data)), data)
    assert [tuple(npy(x) for x in nd) for nd in tc.node_storage(data)][0][0] \
        .tolist() == data[0].tolist()


# -------------------------------------------------------------- file level
@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("size", [1, 17, 2000])
def test_file_round_trip(k, size):
    payload = np.random.default_rng(size + k).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()
    spec = CodeSpec.make(k, P)
    enc = tmsr.encode_file(payload, spec, device="cpu")
    renc = rmsr.encode_file(payload, RSpec.make(k, P))
    np.testing.assert_array_equal(npy(enc.data), renc.data)
    np.testing.assert_array_equal(npy(enc.red), renc.red)
    assert enc.orig_len == renc.orig_len
    rng = np.random.default_rng(size)
    s = sorted(int(x) + 1 for x in rng.choice(2 * k, size=k, replace=False))
    assert tmsr.reconstruct_file(enc, s) == payload
    a, r = enc.node(1)
    np.testing.assert_array_equal(npy(a), renc.node(1)[0])


def test_empty_file_round_trip():
    spec = CodeSpec.make(2, P)
    enc = tmsr.encode_file(b"", spec, device="cpu")
    assert tuple(enc.data.shape) == (4, 0)
    assert tmsr.reconstruct_file(enc, [1, 2]) == b""


# ------------------------------------------------------ cross-package shares
@pytest.mark.parametrize("k", KS)
def test_reference_shares_regenerate_and_decode_in_port(k):
    rc, tc = pair(k)
    n = 2 * k
    data = rand((n, 65), P, 40 + k)
    red = npy(rc.encode(data))
    d_t, r_t = tmsr.shares_from_numpy(data, red, device="cpu")
    nodes = [1, n]
    plans = [tc.repair_plan(i) for i in nodes]
    out = tc.regenerate_batch(
        nodes, r_t[torch.as_tensor([pl.prev_node - 1 for pl in plans])],
        d_t[torch.as_tensor([list(pl.data_indices) for pl in plans])])
    for j, i in enumerate(nodes):
        np.testing.assert_array_equal(npy(out[j, 0]), data[i - 1])
        np.testing.assert_array_equal(npy(out[j, 1]), red[i - 1])
    use = list(range(2, 2 + k))
    idx = [i - 1 for i in use]
    np.testing.assert_array_equal(npy(tc.reconstruct(use, d_t[idx],
                                                     r_t[idx])), data)


@pytest.mark.parametrize("k", KS)
def test_port_shares_regenerate_and_decode_in_reference(k):
    rc, tc = pair(k)
    n = 2 * k
    data = rand((n, 65), P, 60 + k)
    red = npy(tc.encode(data))
    nodes = [2, n - 1]
    r_prevs, nxt = helpers(rc, data, red, nodes)
    out = npy(rc.regenerate_batch(nodes, r_prevs, nxt))
    for j, i in enumerate(nodes):
        np.testing.assert_array_equal(out[j, 0], data[i - 1])
        np.testing.assert_array_equal(out[j, 1], red[i - 1])
    use = list(range(n - k + 1, n + 1))
    idx = [i - 1 for i in use]
    np.testing.assert_array_equal(
        npy(rc.reconstruct(use, data[idx], red[idx])), data)


# ------------------------------------------------------------------ device
def test_entry_points_without_device_raise_without_cuda(no_cuda):
    spec = CodeSpec.make(2, P)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmsr.DoubleCirculantMSR(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmsr.encode_file(b"abc", spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmsr.shares_from_numpy(np.zeros((4, 1), np.int32),
                               np.zeros((4, 1), np.int32))


def test_tensor_inputs_keep_their_device():
    _, tc = pair(2)
    data = torch.from_numpy(rand((4, 9), P, 2))
    assert tc.encode(data).device == data.device
