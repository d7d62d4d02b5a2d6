"""Coded object store under fire, end to end (the port of
``examples/store_demo.py``).

A [2k, k] MSR object store on a physical ring larger than the code --
put-heavy traffic, then read-heavy traffic, then a whole rack dies while
a store-backed checkpoint is live.  Reads keep serving bit-exactly
through the outage (systematic fast path where shares survive, ONE
cached-inverse decode matmul per failure pattern for the rest), the
background scheduler queues every affected stripe with priority =
remaining redundancy, a second failure mid-drain makes the newly
at-risk stripes jump the queue, and the bandwidth-throttled drain
rebuilds everything for a fraction of the classical-RS re-download
baseline.  On the card every put window is one ``circulant_encode``
launch and every repair or degraded decode one ``gf_matmul`` launch.

    PYTHONPATH=src python -m repro_torch.examples.store_demo [--k 4] [--objects 6] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.msr_checkpoint import MSRCheckpointer
from repro_torch.core.circulant import CodeSpec
from repro_torch.device import resolve_device
from repro_torch.store import CodedObjectStore, DrainReport, RepairScheduler


def check_reads(store, objs, label):
    t0 = time.perf_counter()
    degraded = 0
    for key, ref in objs.items():
        res = store.get_ext(key)
        assert res.obj == ref, f"get({key}) not bit-exact"
        degraded += res.degraded_stripes
    dt = time.perf_counter() - t0
    mb = sum(len(v) for v in objs.values()) / 2**20
    print(f"[{label}] {len(objs)} objects BIT-EXACT in {dt:.3f}s "
          f"({mb/dt:.1f} MB/s, {degraded} degraded stripe reads)")
    return degraded


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=4, help="MSR code dimension")
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--object-kb", type=int, default=96)
    ap.add_argument("--stripe-symbols", type=int, default=1 << 10)
    ap.add_argument("--extra-nodes", type=int, default=4)
    ap.add_argument("--budget-stripes", type=int, default=2,
                    help="repair budget per tick, in full-decode stripes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    spec = CodeSpec.make(args.k, 257)
    n_nodes = spec.n + args.extra_nodes
    store = CodedObjectStore(spec, n_nodes=n_nodes, n_racks=4,
                             stripe_symbols=args.stripe_symbols,
                             device=resolve_device(args.device))
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)     # failures feed the repair queue
    print(f"[{spec.n},{spec.k}] MSR store over GF({spec.p}): "
          f"{n_nodes} nodes / {store.layout.n_racks} racks, "
          f"S={store.S} symbols, backend={store.code.backend_name}")

    # ---- put-heavy phase: odd sizes, multi-stripe objects, a pytree
    rng = np.random.default_rng(0)
    objs = {}
    t0 = time.perf_counter()
    for i in range(args.objects):
        size = args.object_kb * 1024 + 131 * i + (i % 3)   # never round
        key = f"obj{i:02d}"
        objs[key] = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        store.put(key, objs[key])
    put_dt = time.perf_counter() - t0
    total_mb = sum(len(v) for v in objs.values()) / 2**20
    stripes = sum(store.stat(k).n_stripes for k in objs)
    print(f"[put] {len(objs)} objects, {total_mb:.2f} MB in {stripes} "
          f"stripes: {total_mb/put_dt:.1f} MB/s")

    # a live store-backed checkpoint rides on the same ring (§10.4)
    state = {"w": np.arange(4096, dtype=np.float32).reshape(64, 64),
             "step": np.int32(7)}
    ck = MSRCheckpointer(None, store=store, leaf_group_bytes=8192)
    ck.save(7, state)

    # ---- read-heavy phase (healthy: all systematic)
    check_reads(store, objs, "read")
    assert store.metrics.reads_degraded == 0

    # ---- a whole rack dies
    victims = store.layout.nodes_in(0)
    for v in victims:
        store.fail_node(v)
    order = sched.peek_order()
    rems = [rem for _, _, rem in order]
    print(f"[failure] rack 0 ({list(victims)}) lost; repair queue: "
          f"{sched.pending()} stripes, remaining-redundancy "
          f"{min(rems)}..{max(rems)}")

    deg = check_reads(store, objs, "degraded")
    assert deg > 0, "rack loss must force degraded stripe reads"
    restored, rep = ck.restore(state)
    assert torch.equal(restored["w"].cpu(), torch.from_numpy(state["w"]))
    print(f"[checkpoint] store-backed restore BIT-EXACT through the "
          f"outage ({rep.bytes_read} bytes read)")

    # ---- drain under a bandwidth budget; a second failure mid-drain
    budget = args.budget_stripes * 2 * spec.k * store.S
    first = sched.drain(budget_symbols=budget)
    survivor = next(v for v in store.up_nodes()
                    if store.layout.rack_of(v) != 0)
    store.fail_node(survivor)
    order = sched.peek_order()
    min_rem = min(rem for _, _, rem in order)
    at_risk = [(key, t) for key, t, rem in order if rem == min_rem]
    others = [(key, t) for key, t, rem in order if rem != min_rem]
    # prove the at-risk stripes are REPAIRED first, not just queued
    # first: one throttled tick sized for m at-risk repairs must heal m
    # of them while every lower-priority stripe stays lost
    m = min(args.budget_stripes, len(at_risk))
    tick = sched.drain(budget_symbols=m * 2 * spec.k * store.S)
    healed = [kt for kt in at_risk if not store.lost_code_nodes(*kt)]
    assert len(healed) >= m, "at-risk stripes must be repaired first"
    assert all(store.lost_code_nodes(*kt) for kt in others), \
        "no lower-priority stripe may jump the at-risk set"
    print(f"[failure] node {survivor} died mid-drain: {len(at_risk)} "
          f"stripes dropped to remaining-redundancy {min_rem}; next tick "
          f"healed {len(healed)} of them while {len(others)} safer stripes "
          f"waited — scheduler repairs at-risk stripes first")

    rest = sched.drain_all(budget_symbols=budget)
    total = DrainReport(ticks=2 + rest.ticks)
    for part in (first, tick, rest):
        total.merge(part)
    moved, baseline = total.symbols_moved, total.rs_baseline_symbols
    ratio = moved / baseline
    print(f"[scheduler] drained {total.repaired_stripes} stripe repairs "
          f"in {total.ticks} ticks @ {budget} sym/tick "
          f"({total.batch_calls} coalesced batch + "
          f"{total.decode_calls} decode dispatches, "
          f"{total.drain_time_s:.3f}s simulated)")
    print(f"[scheduler] repair traffic {moved/2**20:.2f} Mi symbols vs "
          f"RS re-download {baseline/2**20:.2f} Mi — ratio {ratio:.3f}")
    assert ratio < 1.0, "MSR repair must beat the RS baseline"
    assert sched.pending() == 0 and total.unrecoverable == 0

    # ---- healed: bit-exact and fully systematic again
    assert store.verify(), "post-repair shares must equal a fresh encode"
    before = store.metrics.reads_degraded
    check_reads(store, objs, "healed")
    assert store.metrics.reads_degraded == before, "healed reads degrade"
    m = store.metrics.summary()
    print(f"[healed] store whole; availability={m['availability']}, "
          f"reads {m['reads']['systematic']} systematic / "
          f"{m['reads']['degraded']} degraded / {m['reads']['failed']} failed")


if __name__ == "__main__":
    main()
