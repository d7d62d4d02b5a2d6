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
from _torch_parity import no_cuda, npy, rand  # noqa: F401 (fixture)

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
    leaves = tplace.bytes_to_leaves(payload, metas, device="cpu")
    assert leaves[1].dtype == torch.bfloat16
    assert torch.equal(leaves[1], tree["mid"]["a"])
    rleaves = rplace.bytes_to_leaves(payload, metas)
    for got, want in zip(leaves, rleaves):
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)



def test_tree_reads_default_to_the_card(no_cuda):
    """Without a device the leaves go to the card, like every other entry
    point of the port: on a host without CUDA the call raises instead of
    landing on the CPU."""
    _, tree, _ = _trees()[0]
    payload, treedef, metas = tplace.pytree_to_bytes(tree)
    blocks, _, spec = tplace.pytree_to_blocks(tree, 4, P)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplace.bytes_to_leaves(payload, metas)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplace.blocks_to_pytree(blocks, treedef, spec)

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
    back = tplace.blocks_to_pytree(rblocks, treedef, spec, device="cpu")
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


# ------------------------------- leaves torch has no native tensor for
def _odd_tree():
    """A byte-swapped int32 leaf, a string leaf and a plain float32 leaf,
    as numpy (what either package writes for them)."""
    return {"be": (np.arange(6).reshape(2, 3) * 70001 - 9).astype(">i4"),
            "s": np.array(["ab", "c", "de"], dtype="<U2"),
            "w": np.random.default_rng(3).standard_normal(5).astype(
                np.float32)}


def _assert_odd_leaves(got: dict) -> None:
    """The port's read of ``_odd_tree``: the swapped leaf a native int32
    tensor of equal values, the string leaf the reference's numpy array."""
    want = _odd_tree()
    assert isinstance(got["be"], torch.Tensor) and got["be"].dtype == \
        torch.int32
    np.testing.assert_array_equal(got["be"].numpy(), want["be"])
    assert isinstance(got["s"], np.ndarray) and got["s"].dtype == \
        np.dtype("<U2")
    np.testing.assert_array_equal(got["s"], want["s"])
    assert torch.equal(got["w"], torch.from_numpy(want["w"]))


def test_swapped_and_string_leaves_read_back():
    tree = _odd_tree()
    payload, _, metas = tplace.pytree_to_bytes(tree)
    rpayload, _, rmetas = rplace.pytree_to_bytes(tree)
    assert (payload, metas) == (rpayload, rmetas)
    assert [m["dtype"] for m in metas] == [">i4", "<U2", "float32"]
    leaves = tplace.bytes_to_leaves(payload, metas, device="cpu")
    _assert_odd_leaves(dict(zip(("be", "s", "w"), leaves)))
    for got, want in zip(rplace.bytes_to_leaves(payload, metas),
                         tree.values()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("failed", [(), (2,)])
def test_reference_written_store_and_checkpoint_with_odd_leaves(tmp_path,
                                                                 failed):
    """A store and a checkpoint the reference wrote from a tree with a
    ``>i4`` and a ``<U2`` leaf, read by the port (healthy, and with a
    node lost)."""
    import dataclasses

    import repro.checkpoint.msr_checkpoint as rck
    import repro.store as rstore
    import repro_torch.checkpoint.msr_checkpoint as tck
    import repro_torch.store as tstore
    from repro.core.circulant import CodeSpec as RSpec
    from repro_torch.core.circulant import CodeSpec as TSpec
    ref = rstore.CodedObjectStore(RSpec.make(2, P), n_nodes=6,
                                  stripe_symbols=16)
    ref.put_pytree("t", _odd_tree())
    stats = [{**{f.name: getattr(st, f.name)
                 for f in dataclasses.fields(st)},
              "code_class": st.code_class.to_meta()}
             for st in (ref.stat(k) for k in ref.keys())]
    port = tstore.store_from_numpy(TSpec.make(2, P), ref._shares, stats,
                                   n_nodes=6, stripe_symbols=16,
                                   device="cpu")
    for v in failed:
        port.fail_node(v)
    _assert_odd_leaves(port.get_pytree("t"))

    rck.MSRCheckpointer(tmp_path, RSpec.make(3, P)).save(1, _odd_tree())
    ck = tck.MSRCheckpointer(tmp_path, TSpec.make(3, P), device="cpu")
    for f in failed:
        for path in ck._node_files(1, f):
            path.unlink()
    template = {"be": torch.zeros((2, 3), dtype=torch.int32),
                "s": _odd_tree()["s"], "w": torch.zeros(5)}
    got, rep = ck.restore(template, 1, failed_nodes=failed)
    assert rep.path == ("regenerate" if failed else "systematic")
    _assert_odd_leaves(got)


def test_port_written_odd_leaves_read_by_both(tmp_path):
    """The port's put and save of the same tree: its own read returns it,
    and the reference restores the port's checkpoint to the same values
    and dtypes."""
    import repro.checkpoint.msr_checkpoint as rck
    import repro_torch.checkpoint.msr_checkpoint as tck
    import repro_torch.store as tstore
    from repro.core.circulant import CodeSpec as RSpec
    from repro_torch.core.circulant import CodeSpec as TSpec
    st = tstore.CodedObjectStore(TSpec.make(2, P), n_nodes=6,
                                 stripe_symbols=16, device="cpu")
    st.put_pytree("t", _odd_tree())
    st.fail_node(3)
    _assert_odd_leaves(st.get_pytree("t"))

    tck.MSRCheckpointer(tmp_path, TSpec.make(3, P), device="cpu").save(
        1, _odd_tree())
    got, _ = rck.MSRCheckpointer(tmp_path, RSpec.make(3, P)).restore(
        _odd_tree(), 1, failed_nodes=(4,))
    for key, want in _odd_tree().items():
        assert got[key].dtype == want.dtype
        np.testing.assert_array_equal(got[key], want)


def test_object_leaves_rejected_before_any_share(tmp_path):
    """A leaf whose bytes are pointers is refused by the put and the save
    before anything is stored: no object, no share, no step directory."""
    import repro_torch.checkpoint.msr_checkpoint as tck
    import repro_torch.store as tstore
    from repro_torch.core.circulant import CodeSpec as TSpec
    tree = {"o": np.array([object(), 1], dtype=object), "w": np.zeros(3)}
    with pytest.raises(ValueError, match="object dtype"):
        tplace.pytree_to_bytes(tree)
    st = tstore.CodedObjectStore(TSpec.make(2, P), n_nodes=6,
                                 stripe_symbols=16, device="cpu")
    with pytest.raises(ValueError, match="object dtype"):
        st.put_pytree("t", tree)
    assert st.keys() == [] and all(not held for held in st._shares)
    ck = tck.MSRCheckpointer(tmp_path, TSpec.make(3, P), device="cpu")
    with pytest.raises(ValueError, match="object dtype"):
        ck.save(1, tree)
    assert ck.steps() == [] and sorted(tmp_path.iterdir()) == []


# ------------------------------------------- keywords kept for the callers
def test_matmul_precision_and_planner_donate_change_nothing():
    from repro.core import gf as rgf
    from repro_torch.core import gf as tgf
    from repro_torch.exec import plan as tplan
    from repro_torch.kernels import dispatch
    a, b = rand((3, 5), P, 1), rand((5, 40), P, 2)
    want = npy(rgf.matmul(a, b, P, precision="highest"))
    for prec in (None, "highest", "default"):
        np.testing.assert_array_equal(
            npy(tgf.matmul(a, b, P, precision=prec, device="cpu")), want)
    be = dispatch.get("torch-int32")
    outs = []
    for donate in (None, False, True):
        pc = tplan.PlanCache(be, P, bucket_min=32, donate=donate,
                             device="cpu")
        assert pc.donate is bool(donate)
        blocks = torch.from_numpy(b.copy())
        outs.append(pc.matmul(torch.from_numpy(a), blocks).host())
        assert torch.equal(blocks, torch.from_numpy(b))   # never consumed
    for got in outs:
        np.testing.assert_array_equal(npy(got), want)
    d = tplan.get_planner(be, P, donate=True, device="cpu")
    assert d.donate and d is tplan.get_planner(be, P, donate=True,
                                               device="cpu")
    assert not tplan.get_planner(be, P, device="cpu").donate
