"""Port parity — placement (racks, rotation, tree <-> bytes/blocks) and the
baselines.

repro_torch.core.placement and repro_torch.core.baselines against
repro.core.placement / repro.core.baselines: the same layouts and
rotations, the same bytes, leaf metas and blocks for the same tree —
including a dict whose keys are not in sorted order and a bfloat16 leaf —
the same RS generator and codewords, and the same cost formulas.
Tolerance zero.
"""
from collections import OrderedDict, namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import npy, rand

from repro.core import baselines as rbase
from repro.core import placement as rplace
from repro_torch.core import baselines as tbase
from repro_torch.core import placement as tplace

P = 257
Pair = namedtuple("Pair", ["x", "y"])


# ------------------------------------------------------------------ racks
@pytest.mark.parametrize("n_nodes,n_racks", [(4, 2), (12, 2), (12, 3),
                                             (20, 2), (7, 3), (5, 5)])
def test_layouts_and_rotation_match(n_nodes, n_racks):
    t = tplace.rack_layout(n_nodes, n_racks)
    r = rplace.rack_layout(n_nodes, n_racks)
    assert (t.n_nodes, t.racks, t.n_racks, t.max_rack_size) == \
        (r.n_nodes, r.racks, r.n_racks, r.max_rack_size)
    for k in range(1, n_nodes):
        assert t.survives_rack_loss(k) == r.survives_rack_loss(k)
    for rack in range(n_racks):
        assert t.nodes_in(rack) == r.nodes_in(rack)
    for node in range(1, n_nodes + 1):
        assert t.rack_of(node) == r.rack_of(node)
    for n_shares in range(1, n_nodes + 1):
        for stripe in range(2 * n_nodes + 1):
            pl = tplace.rotate_placement(t, n_shares, stripe)
            assert pl == rplace.rotate_placement(r, n_shares, stripe)
            assert tplace.max_shares_per_rack(t, pl) == \
                rplace.max_shares_per_rack(r, pl)


def test_layout_errors():
    with pytest.raises(ValueError):
        tplace.rack_layout(4, 0)
    with pytest.raises(ValueError):
        tplace.RackLayout(3, (0, 1))
    lay = tplace.rack_layout(4, 2)
    with pytest.raises(ValueError):
        lay.rack_of(5)
    with pytest.raises(ValueError):
        tplace.rotate_placement(lay, 5, 0)
    assert tplace.max_shares_per_rack(lay, ()) == 0


# ------------------------------------------------------------------ trees
def _trees():
    """(port tree, reference tree) pairs holding the same values."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, (7,)).astype(np.int32)
    u8 = rng.integers(0, 256, (2, 2, 3)).astype(np.uint8)
    bf = rng.standard_normal((4, 3)).astype(np.float32)
    bf_t = torch.from_numpy(bf).to(torch.bfloat16)
    bf_j = jnp.asarray(bf, dtype=jnp.bfloat16)
    assert np.array_equal(bf_t.view(torch.int16).numpy(),
                          np.asarray(bf_j).view(np.int16))
    unsorted = {"zeta": torch.from_numpy(f32), "alpha": torch.from_numpy(i32),
                "mid": {"b": torch.from_numpy(u8), "a": bf_t}}
    unsorted_j = {"zeta": f32, "alpha": i32, "mid": {"b": u8, "a": bf_j}}
    nested = [torch.from_numpy(i32), (torch.from_numpy(u8),), None,
              OrderedDict([("q", torch.from_numpy(f32)), ("p", 3)]),
              Pair(torch.from_numpy(i32[:2]), {"y": 2.5, "x": True})]
    nested_j = [i32, (u8,), None, OrderedDict([("q", f32), ("p", 3)]),
                Pair(i32[:2], {"y": 2.5, "x": True})]
    return [("unsorted_dict", unsorted, unsorted_j),
            ("nested", nested, nested_j),
            ("bf16_leaf", bf_t, bf_j),
            ("numpy_leaves", {"b": f32, "a": u8}, {"b": f32, "a": u8}),
            ("empty", {}, {})]


@pytest.mark.parametrize("name", [t[0] for t in _trees()])
def test_tree_bytes_identical(name):
    _, tree, rtree = next(t for t in _trees() if t[0] == name)
    payload, treedef, metas = tplace.pytree_to_bytes(tree)
    rpayload, rtreedef, rmetas = rplace.pytree_to_bytes(rtree)
    assert payload == rpayload
    assert metas == rmetas
    assert str(treedef) == str(rtreedef)
    assert treedef.num_leaves == rtreedef.num_leaves


def test_unsorted_dict_and_bf16_leaf_bytes():
    """The two cases a naive port gets wrong: insertion order (torch's
    pytree) instead of sorted keys, and a bfloat16 leaf numpy cannot
    hold."""
    _, tree, rtree = _trees()[0]
    payload, _, metas = tplace.pytree_to_bytes(tree)
    assert [m["dtype"] for m in metas] == ["int32", "bfloat16", "uint8",
                                           "float32"]
    assert payload == rplace.pytree_to_bytes(rtree)[0]
    leaves = tplace.bytes_to_leaves(payload, metas)
    assert leaves[1].dtype == torch.bfloat16
    assert torch.equal(leaves[1], tree["mid"]["a"])
    rleaves = rplace.bytes_to_leaves(payload, metas)
    for got, want in zip(leaves, rleaves):
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("name", ["unsorted_dict", "nested"])
def test_tree_blocks_identical_and_roundtrip(n, name):
    _, tree, rtree = next(t for t in _trees() if t[0] == name)
    blocks, treedef, spec = tplace.pytree_to_blocks(tree, n, P)
    rblocks, _, rspec = rplace.pytree_to_blocks(rtree, n, P)
    np.testing.assert_array_equal(blocks, rblocks)
    assert (spec.leaves, spec.total_bytes, spec.n_blocks,
            spec.block_symbols, spec.treedef_repr) == \
        (rspec.leaves, rspec.total_bytes, rspec.n_blocks,
         rspec.block_symbols, rspec.treedef_repr)
    assert tplace.TreeSpec.from_json(spec.to_json()) == spec
    back = tplace.blocks_to_pytree(rblocks, treedef, spec)
    flat_back, td_back = tplace.tree_flatten(back)
    flat, td = tplace.tree_flatten(tree)
    assert td_back == td
    for got, want in zip(flat_back, flat):
        want = want if isinstance(want, torch.Tensor) \
            else torch.as_tensor(np.asarray(want))
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_treedef_unflatten_rebuilds_containers():
    tree = {"b": [1, (2, None)], "a": OrderedDict([("z", 3), ("y", 4)]),
            "c": Pair(5, 6)}
    leaves, td = tplace.tree_flatten(tree)
    assert leaves == [3, 4, 1, 2, 5, 6]
    back = td.unflatten(leaves)
    assert back == tree and isinstance(back["a"], OrderedDict) and \
        isinstance(back["c"], Pair)
    with pytest.raises(ValueError):
        td.unflatten(leaves[:-1])
    with pytest.raises(ValueError):
        td.unflatten(leaves + [7])


# --------------------------------------------------------------- baselines
@pytest.mark.parametrize("n,k", [(4, 2), (6, 3), (16, 8), (9, 4)])
def test_rs_code_matches(n, k):
    t = tbase.RSCode(n, k, P, device="cpu")
    r = rbase.RSCode(n, k, P)
    np.testing.assert_array_equal(t.g, r.g)
    data = rand((k, 37), P, n)
    cw = t.encode(data)
    np.testing.assert_array_equal(npy(cw), np.asarray(r.encode(data)))
    ids = list(range(n - k + 1, n + 1))
    got = t.reconstruct(ids, npy(cw)[[i - 1 for i in ids]])
    np.testing.assert_array_equal(npy(got), data)
    for fs in (1000, 4096):
        assert t.repair_symbols(fs) == r.repair_symbols(fs)
        assert t.storage_per_node_symbols(fs) == \
            r.storage_per_node_symbols(fs)
        assert t.total_storage_symbols(fs) == r.total_storage_symbols(fs)
    with pytest.raises(ValueError):
        tbase.RSCode(P, 2, P, device="cpu")


def test_cost_formulas_match():
    rep_t, rep_r = tbase.ReplicationScheme(3), rbase.ReplicationScheme(3)
    for fs in (1, 999):
        assert (rep_t.storage_per_node_symbols(fs),
                rep_t.total_storage_symbols(fs), rep_t.repair_symbols(fs),
                rep_t.max_failures()) == \
            (rep_r.storage_per_node_symbols(fs),
             rep_r.total_storage_symbols(fs), rep_r.repair_symbols(fs),
             rep_r.max_failures())
    for k in (2, 4, 8):
        for s in (1, 4099):
            assert tbase.solve_based_msr_repair_cost(k, s).__dict__ == \
                rbase.solve_based_msr_repair_cost(k, s).__dict__
            assert tbase.embedded_repair_cost(k, s).__dict__ == \
                rbase.embedded_repair_cost(k, s).__dict__
            for f in (1, 3):
                assert tbase.rs_scenario_repair_symbols(k, s, f) == \
                    rbase.rs_scenario_repair_symbols(k, s, f)
