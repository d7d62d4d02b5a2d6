"""Port parity — code families (mirrors tests/test_codes.py).

repro_torch.codes against repro.codes, family by family: the same
``CodeClass.to_meta()`` and keys, the same product-matrix generator,
generators g and newcomer matrices, the same shares from
``encode_shares``, and bit-identical ``reconstruct`` from every k-subset,
``regenerate`` of every node at the cut-set bound, restricted-helper
repair, ``share_rows`` and the batched ``regenerate_many_planned``.  The
JAX side runs on the CPU with ``jnp-int32`` auto-selected.  Tolerance
zero.
"""
import itertools

import numpy as np
import pytest

from repro.codes import CodeClass as RClass
from repro.codes import make_code as rmake
from repro.core.circulant import CodeSpec as RSpec
from repro.codes import default_code_class as rdefault
from repro_torch.codes import (FAMILY_DOUBLE_CIRCULANT,
                               FAMILY_PRODUCT_MATRIX, CodeClass,
                               default_code_class, families, generic_share_crc,
                               is_one_hot, make_code)
from repro_torch.codes import base as tbase
from repro.codes import base as rbase
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.repair import decode_cache_stats

S = 7

GRID = [
    (FAMILY_DOUBLE_CIRCULANT, 4, 2, 3),
    (FAMILY_DOUBLE_CIRCULANT, 6, 3, 4),
    (FAMILY_PRODUCT_MATRIX, 4, 2, 2),     # d = 2k-2 floor
    (FAMILY_PRODUCT_MATRIX, 5, 2, 3),     # d < n-1
    (FAMILY_PRODUCT_MATRIX, 6, 3, 4),     # d < n-1
    (FAMILY_PRODUCT_MATRIX, 7, 3, 5),
    (FAMILY_PRODUCT_MATRIX, 16, 8, 14),   # the store's conversion target
]
_IDS = [f"{f}-n{n}k{k}d{d}" for f, n, k, d in GRID]
_CODES: dict = {}


def codes(g):
    """(port code on the CPU, reference code), built once per class."""
    if g not in _CODES:
        _CODES[g] = (make_code(CodeClass(*g), device="cpu"),
                     rmake(RClass(*g)))
    return _CODES[g]


def payload(code, g, seed=0):
    rng = np.random.default_rng(seed * 1000 + g[1] * 10 + g[3])
    return rng.integers(0, 257, (code.data_blocks, S),
                        dtype=np.int64).astype(np.int32)


def stacked(code, shares, subset):
    return np.stack([shares[j - 1][b] for j, b in
                     code.helper_block_ids(subset)])


# ---------------------------------------------------------------- registry
def test_registry_and_meta_match():
    from repro.codes import families as rfamilies
    assert families() == rfamilies()
    for g in GRID:
        cc, rc = CodeClass(*g), RClass(*g)
        assert cc.to_meta() == rc.to_meta() and cc.key() == rc.key()
        assert CodeClass.from_meta(rc.to_meta()) == cc
    spec, rspec = CodeSpec.make(3, 257), RSpec.make(3, 257)
    assert default_code_class(spec).to_meta() == rdefault(rspec).to_meta()
    with pytest.raises(ValueError):
        CodeClass("x", n=4, k=4, d=4)
    with pytest.raises(ValueError):
        CodeClass("x", n=4, k=2, d=4)
    with pytest.raises(KeyError, match="unknown code family"):
        make_code(CodeClass("no-such-family", n=4, k=2, d=3), device="cpu")
    with pytest.raises(ValueError):
        make_code(CodeClass(FAMILY_DOUBLE_CIRCULANT, 6, 2, 3), device="cpu")
    with pytest.raises(ValueError):
        make_code(CodeClass(FAMILY_PRODUCT_MATRIX, 8, 4, 5), device="cpu")
    # a 2-shard mesh (on ["cpu"] * 2) builds and encodes as unsharded
    from repro_torch.sharding.mesh import StreamMesh
    mesh2 = StreamMesh(2, devices=["cpu"] * 2)
    meshed = make_code(CodeClass(*GRID[2]), device="cpu", mesh=mesh2)
    plain = make_code(CodeClass(*GRID[2]), device="cpu")
    assert meshed.mesh is mesh2
    assert meshed.planner.mesh.key() == mesh2.key()
    assert plain.mesh is None and meshed.planner is not plain.planner
    flat = np.random.default_rng(3).integers(
        0, 256, size=(plain.data_blocks, 1001)).astype(np.int32)
    np.testing.assert_array_equal(meshed.encode_derived_planned(flat).host(),
                                  plain.encode_derived_planned(flat).host())


def test_helpers_match():
    for row in ([[0, 1]], [[1, 0, 0]], [[2, 0]], [[1, 1]], [[0, 0]]):
        assert is_one_hot(np.array(row)) == rbase.is_one_hot(np.array(row))
    blocks = [np.arange(40, dtype=np.int32) % 257,
              np.full(40, 256, np.int32)]
    assert generic_share_crc(blocks) == rbase.generic_share_crc(blocks)


# ------------------------------------------------ generators and geometry
@pytest.mark.parametrize("g", [g for g in GRID
                               if g[0] == FAMILY_PRODUCT_MATRIX], ids=str)
def test_product_matrix_construction_identical(g):
    t, r = codes(g)
    assert (t.alpha, t.B, t.derived_rows) == (r.alpha, r.B, r.derived_rows)
    np.testing.assert_array_equal(t.gens, r.gens)
    np.testing.assert_array_equal(t.lams, r.lams)
    np.testing.assert_array_equal(t.psi, r.psi)
    np.testing.assert_array_equal(t.G, r.G)
    for f in (1, g[1]):
        for pool in (None, [j for j in range(1, g[1] + 1) if j != f][::-1]):
            plan = t.repair_plan(f, available=pool)
            rplan = r.repair_plan(f, available=pool)
            assert plan.helpers == rplan.helpers
            for a, b in zip(plan.send_matrices, rplan.send_matrices):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(t.newcomer_matrix(plan),
                                          r.newcomer_matrix(rplan))


@pytest.mark.parametrize("g", GRID, ids=_IDS)
def test_geometry_and_encode_shares_identical(g):
    t, r = codes(g)
    assert (t.share_blocks, t.data_blocks, t.derived_rows) == \
        (r.share_blocks, r.data_blocks, r.derived_rows)
    assert [t.data_location(m) for m in range(t.data_blocks)] == \
        [r.data_location(m) for m in range(r.data_blocks)]
    assert (t.alpha_symbols(S), t.gamma_regenerate_symbols(S),
            t.gamma_reconstruct_symbols(S), t.storage_overhead(),
            t.supports_batched_regen()) == \
        (r.alpha_symbols(S), r.gamma_regenerate_symbols(S),
         r.gamma_reconstruct_symbols(S), r.storage_overhead(),
         r.supports_batched_regen())
    data = payload(t, g)
    shares = t.encode_shares(data)
    np.testing.assert_array_equal(shares, r.encode_shares(data))
    for j in range(g[1]):
        assert t.share_crc_blocks(list(shares[j])) == \
            r.share_crc_blocks(list(shares[j]))
    with pytest.raises(ValueError):
        t.encode_shares(data[:-1])


# ------------------------------------------------------------- decoding
@pytest.mark.parametrize("g", GRID[:6], ids=_IDS[:6])
def test_reconstruct_every_k_subset_identical(g):
    t, r = codes(g)
    data = payload(t, g, seed=1)
    shares = t.encode_shares(data)
    for subset in itertools.combinations(range(1, g[1] + 1), g[2]):
        dl = stacked(t, shares, subset)
        assert t.helper_block_ids(subset) == r.helper_block_ids(subset)
        np.testing.assert_array_equal(t.decode_rows(subset, [0, 1]),
                                      r.decode_rows(subset, [0, 1]))
        got = t.reconstruct(subset, dl)
        np.testing.assert_array_equal(got, r.reconstruct(subset, dl))
        np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("g", GRID, ids=_IDS)
def test_share_rows_identical(g):
    t, r = codes(g)
    data = payload(t, g, seed=5)
    shares = t.encode_shares(data)
    lost = [1, g[1]]
    use = tuple(range(2, 2 + g[2]))
    mat = t.share_rows(use, lost)
    np.testing.assert_array_equal(mat, r.share_rows(use, lost))
    out = t.apply_planned(mat, stacked(t, shares, use)).host()
    q = t.share_blocks
    for i, f in enumerate(lost):
        np.testing.assert_array_equal(out[i * q:(i + 1) * q], shares[f - 1])


# ---------------------------------------------------------- regeneration
@pytest.mark.parametrize("g", GRID, ids=_IDS)
def test_regenerate_every_node_identical(g):
    t, r = codes(g)
    data = payload(t, g, seed=2)
    shares = t.encode_shares(data)
    plans, sends_all = [], []
    for f in range(1, g[1] + 1):
        plan, rplan = t.repair_plan(f), r.repair_plan(f)
        assert plan.helpers == rplan.helpers and plan.d == g[3]
        sends = np.stack([t.helper_send(sm, shares[h - 1])
                          for h, sm in zip(plan.helpers,
                                           plan.send_matrices)])
        np.testing.assert_array_equal(sends, np.stack([
            r.helper_send(sm, shares[h - 1])
            for h, sm in zip(rplan.helpers, rplan.send_matrices)]))
        assert sends.size == t.gamma_regenerate_symbols(S)
        np.testing.assert_array_equal(t.newcomer_matrix(plan),
                                      r.newcomer_matrix(rplan))
        got = t.regenerate(plan, sends)
        np.testing.assert_array_equal(got, r.regenerate(rplan, sends))
        np.testing.assert_array_equal(got, shares[f - 1])
        plans.append(plan)
        sends_all.append(sends)
    batch = t.regenerate_many_planned(plans, np.stack(sends_all)).host()
    np.testing.assert_array_equal(
        batch, r.regenerate_many_planned(
            [r.repair_plan(f) for f in range(1, g[1] + 1)],
            np.stack(sends_all)).host())
    np.testing.assert_array_equal(batch, shares)
    with pytest.raises(ValueError):
        t.regenerate_many_planned(plans, np.stack(sends_all)[:-1])


@pytest.mark.parametrize("g", [g for g in GRID[:6]
                               if g[0] == FAMILY_PRODUCT_MATRIX
                               and g[3] < g[1] - 1], ids=str)
def test_restricted_helpers_identical(g):
    t, r = codes(g)
    shares = t.encode_shares(payload(t, g, seed=3))
    others = [j for j in range(1, g[1] + 1) if j != 1]
    for pool in itertools.combinations(others, g[3]):
        plan, rplan = t.repair_plan(1, pool), r.repair_plan(1, pool)
        assert plan.helpers == rplan.helpers
        sends = np.stack([t.helper_send(sm, shares[h - 1])
                          for h, sm in zip(plan.helpers,
                                           plan.send_matrices)])
        np.testing.assert_array_equal(t.regenerate(plan, sends), shares[0])


def test_double_circulant_plans_match_and_need_embedded_helpers():
    t, r = codes(GRID[0])
    plan = t.repair_plan(1)
    assert plan.helpers == r.repair_plan(1).helpers
    pool = tuple(j for j in range(2, 5) if j != plan.helpers[0])
    assert t.repair_plan(1, available=pool) is None
    with pytest.raises(ValueError, match="embedded helper order"):
        t.newcomer_matrix(tbase.CodeRepairPlan(1, plan.helpers[::-1],
                                               plan.send_matrices, 3))
    for g in GRID:
        tc, rc = codes(g)
        pool = tuple(range(2, 2 + g[3] - 1))
        assert tc.repair_plan(1, available=pool) is None
        assert rc.repair_plan(1, available=pool) is None


def test_overlapping_parameters_use_distinct_cache_families():
    dc, _ = codes(GRID[0])
    pm, _ = codes(GRID[2])
    for code, g in ((dc, GRID[0]), (pm, GRID[2])):
        data = payload(code, g, seed=7)
        shares = code.encode_shares(data)
        for subset in itertools.combinations(range(1, 5), 2):
            np.testing.assert_array_equal(
                code.reconstruct(subset, stacked(code, shares, subset)),
                data)
    stats = decode_cache_stats()
    dc_fams = [f for f in stats if f.startswith("double-circulant[n4,k2")]
    assert dc_fams and pm.family_key() in stats
    assert pm.family_key() not in dc_fams
    assert stats[pm.family_key()].misses > 0
