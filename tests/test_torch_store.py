"""Port parity — the coded object store and its repair scheduler (mirrors
what tests/test_store.py, tests/test_convert.py and the store cases of
tests/test_staging.py check).

Every test drives the SAME script through a store of each package —
repro_torch.store on the CPU and repro.store with ``jnp-int32``
auto-selected — and holds the port to the reference exactly: shares on
every node, CRC ledgers, placement, ``GetResult``, ``DrainReport``,
``ConvertReceipt``, the metrics and retry summaries, the scheduler's
queue, and the exceptions raised.  Also: a store written by the reference
read, degraded and repaired by the port (``store_from_numpy``), and the
store known-answer digest ``chip_smoke.py`` checks on the card, computed
here with the reference.
"""
import dataclasses
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.codes as rcodes
import repro.io as rio
import repro.store as rstore
import repro_torch.codes as tcodes
import repro_torch.io as tio
import repro_torch.store as tstore
from repro.core.circulant import CodeSpec as RSpec
from repro_torch.core.circulant import CodeSpec as TSpec

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

PORT = SimpleNamespace(name="port", CodeSpec=TSpec, store=tstore, io=tio,
                       codes=tcodes, kw={"device": "cpu"})
REF = SimpleNamespace(name="ref", CodeSpec=RSpec, store=rstore, io=rio,
                      codes=rcodes, kw={})


def norm(x):
    """A comparable, package-neutral form of a store result."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":
            x = x.view(np.int16)
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (rcodes.CodeClass, tcodes.CodeClass)):
        return ("cc", norm(x.to_meta()))
    if isinstance(x, BaseException):
        # a give-up names its elapsed wall time, which no two runs share
        return ("exc", type(x).__name__,
                re.sub(r" in \d+\.\d+s", " in <t>s", str(x)))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x)
            if f.name != "meta") + (
            ("meta", norm({k: v for k, v in x.meta.items()
                           if k != "treedef"})) if hasattr(x, "meta")
            else ())
    if isinstance(x, dict):
        return ("dict", tuple(sorted((repr(k), norm(v))
                                     for k, v in x.items())))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if hasattr(x, "_asdict"):
        return norm(x._asdict())
    return x


def state(store, sched=None):
    """Everything a store holds that the two packages must agree on."""
    out = {"shares": [{kt: [s[0]] + [np.asarray(b) for b in s[1:]]
                       for kt, s in held.items()} for held in store._shares],
           "stats": {k: store.stat(k) for k in store.keys()},
           "placement": {k: [store.placement_of(k, t)
                             for t in range(store.stat(k).n_stripes)]
                         for k in store.keys()},
           "metrics": store.metrics.summary(),
           "retry": store.retry_stats.summary(),
           "next_stripe": store._next_stripe,
           "node_state": list(store.state),
           "lost": store.total_lost_shares()}
    if sched is not None:
        out["queue"] = (sched.peek_order(), sched.pending(),
                        sched.pending_converts())
    return norm(out)


class Twin:
    """One store per package, built alike; ``run`` applies a script to
    both and asserts equal results and equal state."""

    def __init__(self, k=2, n_nodes=None, stripe_symbols=16, sched=True,
                 faults=None, **kw):
        self.sides = []
        for pkg in (PORT, REF):
            extra = dict(kw)
            if faults is not None:
                extra["faults"], extra["retry"] = faults(pkg.io)
            st = pkg.store.CodedObjectStore(
                pkg.CodeSpec.make(k, 257), n_nodes=n_nodes,
                stripe_symbols=stripe_symbols, **extra, **pkg.kw)
            sc = None
            if sched:
                sc = pkg.store.RepairScheduler(st)
                st.subscribe(sc.on_event)
            self.sides.append((pkg, st, sc))

    def run(self, script):
        outs = []
        for pkg, st, sc in self.sides:
            try:
                out = script(pkg, st, sc)
            except Exception as e:                  # noqa: BLE001
                out = e
            outs.append((norm(out), state(st, sc)))
        (got, got_state), (want, want_state) = outs
        assert got == want
        assert got_state == want_state
        return [o for o, _ in outs]

    @property
    def port(self):
        return self.sides[0][1]


def blob(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def put_some(sizes=(0, 5, 200, 999), seed=0):
    def script(pkg, st, sc):
        return [st.put(f"o{i}", blob(n, seed + i))
                for i, n in enumerate(sizes)]
    return script


def get_all(pkg, st, sc):
    return {k: st.get_ext(k) for k in st.keys()}


def lose(*nodes, replace=True):
    def script(pkg, st, sc):
        for v in nodes:
            st.fail_node(v)
        gets = get_all(pkg, st, sc)
        if replace:
            for v in nodes:
                st.replace_node(v)
        return gets
    return script


def drain(budget=None):
    return lambda pkg, st, sc: sc.drain_all(budget)


# ---------------------------------------------------------- put / get path
@pytest.mark.parametrize("k,n_nodes,s", [(2, None, 16), (2, 12, 64),
                                         (4, 12, 33), (4, None, 1)])
def test_put_get_stat_delete(k, n_nodes, s):
    tw = Twin(k=k, n_nodes=n_nodes, stripe_symbols=s)
    tw.run(put_some())
    tw.run(get_all)
    arr = np.random.default_rng(1).standard_normal((17, 3)).astype(
        np.float32)
    tw.run(lambda pkg, st, sc: (st.put("arr", arr, meta={"m": 1}),
                                st.get("arr")))
    tw.run(lambda pkg, st, sc: st.put("o1", blob(77, 9)))     # overwrite
    tw.run(lambda pkg, st, sc: (st.delete("o2"), st.keys()))
    for op in ("get", "stat", "delete"):
        tw.run(lambda pkg, st, sc: getattr(st, op)("ghost"))
    tw.run(lambda pkg, st, sc: st.put("x", 3.5))               # TypeError
    tw.run(lambda pkg, st, sc: (st.verify(), st.audit()))


@pytest.mark.parametrize("losses", [1, 2, 3])
def test_degraded_get_every_loss_count(losses):
    tw = Twin(k=3, stripe_symbols=16)
    tw.run(put_some((500, 1, 3000)))
    tw.run(lose(*range(1, losses + 1), replace=False))
    tw.run(lambda pkg, st, sc: st.fail_node(6))
    tw.run(get_all)             # beyond budget when losses == 3: data loss


def test_degraded_get_batches_one_decode_per_pattern():
    tw = Twin(k=4, n_nodes=12, stripe_symbols=32)
    tw.run(put_some((20000, 333)))
    outs = tw.run(lose(3, 8, replace=False))
    st = tw.port
    from repro_torch.kernels import dispatch
    assert st.code.backend_name == "torch-int32"
    assert dispatch.select(257, 4, "cpu").name == "torch-int32"
    assert outs[0] == outs[1]


# ------------------------------------------------------------ scheduler
def test_single_loss_drain_coalesces_and_matches():
    tw = Twin(k=4, n_nodes=12, stripe_symbols=32, repair_tile_tasks=4)
    tw.run(put_some((9000, 500, 5)))
    tw.run(lose(5))
    reps = tw.run(drain())
    assert dict(reps[0][1:])["batch_calls"] >= 2
    tw.run(lambda pkg, st, sc: st.verify())


def test_multi_loss_priorities_budget_and_ticks():
    tw = Twin(k=3, n_nodes=9, stripe_symbols=16)
    tw.run(put_some((3000, 700)))
    tw.run(lambda pkg, st, sc: (st.fail_node(2), sc.peek_order()))
    tw.run(lambda pkg, st, sc: (st.fail_node(4), sc.peek_order()))
    tw.run(lambda pkg, st, sc: (st.replace_node(2), st.replace_node(4)))
    tw.run(lambda pkg, st, sc: sc.drain(budget_symbols=100))
    tw.run(lambda pkg, st, sc: sc.drain(budget_symbols=0))
    tw.run(drain(budget=300))
    tw.run(lambda pkg, st, sc: (st.verify(), sc.budget_symbols_per_tick()))


def test_lost_at_birth_reprotected_and_unrecoverable_dropped():
    tw = Twin(k=2, n_nodes=6, stripe_symbols=16)
    tw.run(lambda pkg, st, sc: st.fail_node(1))
    tw.run(put_some((400, 50)))
    tw.run(lambda pkg, st, sc: st.replace_node(1))
    tw.run(drain())
    for v in (2, 3, 4):
        tw.run(lambda pkg, st, sc: st.fail_node(v))
    tw.run(lambda pkg, st, sc: [st.replace_node(v) for v in (2, 3, 4)])
    tw.run(drain())                   # stripes past the budget are dropped
    tw.run(lambda pkg, st, sc: (sc.enqueue_scan(), sc.pending()))


def test_restart_scan_and_delete_purge():
    tw = Twin(k=2, n_nodes=8, stripe_symbols=16)
    tw.run(put_some((1500, 1500)))
    tw.run(lambda pkg, st, sc: st.fail_node(1))
    tw.run(lambda pkg, st, sc: (st.delete("o0"), sc.peek_order()))
    tw.run(lambda pkg, st, sc: (st.replace_node(1), sc.drain(5000)))
    # a fresh scheduler after a "crash": the scan rebuilds the queue
    for pkg, st, sc in tw.sides:
        st.fail_node(3)
    tw.run(lambda pkg, st, sc: (st.replace_node(3),
                                pkg.store.RepairScheduler(st).enqueue_scan()))
    tw.run(lambda pkg, st, sc: sc.enqueue_scan())
    tw.run(drain())


# ------------------------------------------------------------ conversion
def test_convert_round_trip_and_scheduler_queue():
    tw = Twin(k=4, n_nodes=10, stripe_symbols=16)
    tw.run(put_some((5000, 64)))

    def pm(pkg):
        return pkg.codes.CodeClass("product-matrix", 8, 4, 6)

    tw.run(lambda pkg, st, sc: st.convert("o0", pm(pkg)))
    tw.run(lambda pkg, st, sc: st.convert("o0", pm(pkg)))       # no-op
    tw.run(get_all)
    tw.run(lose(2))                       # PM + DC repairs in one drain
    tw.run(drain())
    tw.run(lose(1, 5, 9))                 # PM multi-loss decodes
    tw.run(drain())
    tw.run(lambda pkg, st, sc: (st.verify(), st.class_of("o0")))
    tw.run(lambda pkg, st, sc: st.convert(
        "o0", pkg.codes.default_code_class(st.spec)))          # back
    tw.run(lambda pkg, st, sc: (sc.enqueue_convert("o1", pm(pkg)),
                                sc.enqueue_convert("gone", pm(pkg)),
                                sc.pending_converts()))
    tw.run(drain())
    tw.run(lambda pkg, st, sc: st.convert("o1", pkg.codes.CodeClass(
        "no-such-family", 8, 4, 5)))


def test_convert_from_degraded_source_and_array_meta():
    tw = Twin(k=2, n_nodes=6, stripe_symbols=8)
    arr = np.arange(100, dtype=np.int16).reshape(10, 10)
    tw.run(lambda pkg, st, sc: st.put("a", arr, meta={"tag": "x"}))
    tw.run(lambda pkg, st, sc: st.fail_node(2))
    tw.run(lambda pkg, st, sc: st.convert(
        "a", pkg.codes.CodeClass("product-matrix", 4, 2, 3)))
    tw.run(lambda pkg, st, sc: (st.get("a"), st.stat("a").meta["tag"]))


# ------------------------------------------------- integrity and faults
def test_crc_ledger_scrub_audit_and_gc():
    tw = Twin(k=2, n_nodes=6, stripe_symbols=16)
    tw.run(put_some((300, 40)))

    def rot(pkg, st, sc):
        pl = st.placement_of("o0", 0)
        st._shares[pl[0] - 1][("o0", 0)][1][3] ^= 0x55
        st._shares[0][("zombie", 0)] = [1, np.zeros(16, np.int32),
                                        np.zeros(16, np.int32)]
        return (st.share_intact(pl[0], "o0", 0), st.scrub_node(pl[0]),
                st.audit(), st.verify())

    tw.run(rot)
    tw.run(lambda pkg, st, sc: (st.gc_orphans(), st.audit(),
                                st.share_intact(1, "o1", 0),
                                st.drop_share(2, "o1", 0),
                                st.drop_share(2, "o1", 0)))
    tw.run(lambda pkg, st, sc: (sc.enqueue_scan(), sc.drain_all(),
                                st.verify()))


def test_rotten_helper_refused_then_requeued():
    tw = Twin(k=2, n_nodes=6, stripe_symbols=16)
    tw.run(put_some((60,)))

    def rot_and_drain(pkg, st, sc):
        pl = st.placement_of("o0", 0)
        st.fail_node(pl[0])
        st._shares[pl[1] - 1][("o0", 0)][1][0] ^= 0x55
        return st.get_ext("o0")

    tw.run(rot_and_drain)                  # ShareIntegrityError
    tw.run(lambda pkg, st, sc: sc.drain(budget_symbols=10_000_000))
    tw.run(lambda pkg, st, sc: (
        st.drop_share(st.placement_of("o0", 0)[1], "o0", 0),
        sc.drain_all(), st.get("o0")))


def _faults(rules, max_attempts=2):
    def make(io):
        inj = io.FaultInjector(seed=3, sleep=lambda s: None)
        for rule in rules:
            inj.add(**rule)
        return inj, io.fast_retry(max_attempts=max_attempts)
    return make


@pytest.mark.parametrize("rules,attempts", [
    ([{"op": "write", "match": "node:03", "kind": "transient"}], 2),
    ([{"op": "write", "match": "node:02", "kind": "transient",
       "times": 2}], 4),
    ([{"op": "read", "kind": "transient", "prob": 0.3}], 3),
    ([{"op": "read", "kind": "corrupt", "prob": 0.2}], 3),
    ([{"op": "read", "kind": "latency", "latency_s": 0.0, "prob": 0.5},
      {"op": "write", "kind": "transient", "prob": 0.1}], 4)])
def test_injected_faults_and_give_ups(rules, attempts):
    # depth 1: share reads and writes run in program order, so both
    # packages consume the seeded fault stream in the same order (at
    # depth 2 the pool's threads interleave them)
    tw = Twin(k=2, n_nodes=4, stripe_symbols=16, pipeline_depth=1,
              faults=_faults(rules, attempts))
    tw.run(put_some((900, 33)))
    tw.run(lose(2, replace=False))
    tw.run(lambda pkg, st, sc: st.replace_node(2))
    tw.run(lambda pkg, st, sc: sc.drain(budget_symbols=10_000_000))


# ----------------------------------------- staging, depth, pytree, sizes
@pytest.mark.parametrize("depth,staging", [(1, True), (2, False),
                                           (3, True)])
def test_pipeline_depth_and_staging_paths(depth, staging):
    tw = Twin(k=4, n_nodes=11, stripe_symbols=24, pipeline_depth=depth,
              put_tile_stripes=3, repair_tile_tasks=5)
    # the port keeps only the zero-copy path; the reference's copying
    # baseline must land on the same shares and ledgers
    tw.sides[1][1].staging_enabled = staging
    pool = tw.port.code.planner.staging       # shared by the process
    held = pool.stats().in_use
    tw.run(put_some((7000, 1000, 2)))
    tw.run(lose(4))
    tw.run(drain())
    tw.run(lose(1, 6, 7))
    tw.run(drain())
    assert pool.stats().in_use == held     # every staged buffer released
    assert tw.port.pipeline.depth == depth


def test_pytree_objects_share_the_reference_layout():
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    trees = {"port": {"w": torch.from_numpy(w),
                      "b": torch.from_numpy(b).to(torch.bfloat16),
                      "ids": [torch.arange(4, dtype=torch.int32)]},
             "ref": {"w": w, "b": jnp.asarray(b, jnp.bfloat16),
                     "ids": [np.arange(4, dtype=np.int32)]}}
    tw = Twin(k=2, n_nodes=6, stripe_symbols=16)
    tw.run(lambda pkg, st, sc: st.put_pytree("t", trees[pkg.name]))
    tw.run(lambda pkg, st, sc: st.stat("t").meta["leaves"])
    tw.run(lose(1, replace=False))
    got = {}

    def read_back(pkg, st, sc):
        got[pkg.name] = st.get_pytree("t")
        return got[pkg.name]

    tw.run(read_back)                          # the same leaves, degraded
    port = got["port"]
    assert list(port) == ["b", "ids", "w"]
    assert port["b"].dtype == torch.bfloat16 and \
        torch.equal(port["b"], trees["port"]["b"])
    assert torch.equal(port["w"], trees["port"]["w"])
    assert torch.equal(port["ids"][0], trees["port"]["ids"][0])
    tw.run(lambda pkg, st, sc: st.put("raw", b"x"))
    tw.run(lambda pkg, st, sc: st.get_pytree("raw"))          # TypeError


def test_production_width_odd_stripe():
    tw = Twin(k=8, n_nodes=20, stripe_symbols=1031)
    tw.run(put_some((70000, 16 * 1031, 9)))
    tw.run(lose(3))
    tw.run(drain())
    tw.run(lambda pkg, st, sc: [st.fail_node(v)
                                for v in st.layout.nodes_in(0)])
    tw.run(get_all)
    tw.run(lambda pkg, st, sc: [st.replace_node(v)
                                for v in st.layout.nodes_in(0)])
    tw.run(drain())
    tw.run(lambda pkg, st, sc: st.verify())


def test_store_validation():
    with pytest.raises(NotImplementedError):
        tstore.CodedObjectStore(TSpec.make(2, 257), mesh=2, device="cpu")
    with pytest.raises(ValueError):
        tstore.CodedObjectStore(TSpec.make(2, 257), n_nodes=3,
                                device="cpu")
    for n_nodes in range(4, 13):
        assert tstore.CodedObjectStore._default_racks(
            TSpec.make(2, 257), n_nodes) == \
            rstore.CodedObjectStore._default_racks(RSpec.make(2, 257),
                                                   n_nodes)


# ------------------------------------------- state written by the reference
def test_reference_written_store_read_degraded_and_repaired_by_port():
    spec = RSpec.make(4, 257)
    ref = rstore.CodedObjectStore(spec, n_nodes=11, stripe_symbols=40)
    objs = {f"k{i}": blob(n, i) for i, n in enumerate((4000, 1, 900))}
    for key, v in objs.items():
        ref.put(key, v)
    ref.put("arr", np.arange(12, dtype=np.int64).reshape(3, 4))
    ref.convert("k2", rcodes.CodeClass("product-matrix", 8, 4, 6))
    stats = [{**{f.name: getattr(st, f.name)
                 for f in dataclasses.fields(st)},
              "code_class": st.code_class.to_meta()}
             for st in (ref.stat(k) for k in ref.keys())]
    port = tstore.store_from_numpy(
        TSpec.make(4, 257), ref._shares, stats, n_nodes=11,
        n_racks=ref.layout.n_racks, stripe_symbols=40, device="cpu")
    assert norm(port._shares) == norm(ref._shares)
    assert norm([port.stat(k) for k in port.keys()]) == \
        norm([ref.stat(k) for k in ref.keys()])
    for key, v in objs.items():
        assert port.get(key) == v
    np.testing.assert_array_equal(port.get("arr"), ref.get("arr"))
    assert port.class_of("k2").to_meta() == ref.class_of("k2").to_meta()
    assert port.verify() and port.audit().clean
    # degrade and repair on both, from the same state
    scheds = []
    for st in (port, ref):
        sc = (tstore if st is port else rstore).RepairScheduler(st)
        st.subscribe(sc.on_event)
        scheds.append(sc)
        for v in (2, 7):
            st.fail_node(v)
    assert norm([port.get_ext(k) for k in objs]) == \
        norm([ref.get_ext(k) for k in objs])
    for st in (port, ref):
        for v in (2, 7):
            st.replace_node(v)
    assert norm(scheds[0].drain_all()) == norm(scheds[1].drain_all())
    assert norm(port._shares) == norm(ref._shares)
    assert port._next_stripe == ref._next_stripe
    port.put("new", b"after")
    assert port.get("new") == b"after"
    with pytest.raises(ValueError):
        tstore.store_from_numpy(TSpec.make(4, 257), ref._shares[:-1], stats,
                                n_nodes=11, stripe_symbols=40, device="cpu")


# ---------------------------------------------------- store known answer
def test_store_known_answer_digest_pinned():
    """The digest chip_smoke.py holds the card's store to is the
    reference's, and the port on the CPU reproduces it."""
    want = chip_smoke.store_rehearsal(RSpec, rstore.CodedObjectStore,
                                      rstore.RepairScheduler,
                                      rcodes.CodeClass)
    assert want == chip_smoke.KA_STORE_SHA256
    assert chip_smoke.store_rehearsal(
        TSpec, tstore.CodedObjectStore, tstore.RepairScheduler,
        tcodes.CodeClass, device="cpu") == want
