#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

Run from the root of a checkout:

    python3 chip_smoke.py [--payload-mib 1024] [--store-mib 1024]

It builds the port's Hopper kernels from ``src/repro_torch/csrc`` into
``build/kernels/`` and runs six phases, each printing one JSON line:

1. device   the card (nvidia-smi name and power limit), torch and CUDA;
2. build    both kernels, one nvcc per source, started together;
3. kernels  each kernel against its plain torch version on the card,
            exact equality (tolerance 0: GF arithmetic is exact), at the
            listed shapes, over gf_matmul's grid of m, k, stream lengths
            (aligned, unaligned, s < 4), 1-4 row sources, batching, p and
            unreduced or negative inputs, and at the main path's and the
            store path's shapes (store_matmul_shapes);
            plus the exhaustive check of the kernel's Barrett fold over
            every uint32 value at p in {5, 257, 46337};
4. main     the port's main path at the repo's production width, [16, 8]
            over GF(257), on a 1 GiB payload made from a seed: encode,
            single and batched regenerate (each exactly one gf_matmul
            launch, with no temporaries beyond its output), any-k decode
            (twice: the second must hit the decode cache), one-matmul
            multi-failure repair (no concatenated copy of the download),
            the planned ops with zero new plan compiles on a repeat, and a
            known-answer check against digests of the JAX reference; the
            peak device memory of each op;
5. times    CUDA-event times (warm-up excluded, inputs on the card) of
            each kernel (``ms``: median of single calls on an idle card;
            ``ms_back_to_back``: calls launched back to back), its
            wrapper's host time per call, its plain version and one
            float32 torch.matmul + torch.remainder as a yardstick (for
            circulant_encode over the dense encode matrix), beside the
            least time the card could take and the share of it reached
            in ``ms``; host<->device copy rates;
6. store    the coded object store at [16, 8] over GF(257) on 20 nodes
            with 64 KiB blocks, 16 objects of 64 MiB (1 GiB) plus an
            array and a tree of card tensors: put (one encode launch per
            window), healthy get (no launch), node 3 lost (degraded get,
            coalesced repair: one launch per window), rack 0 lost
            (degraded get, one launch per multi-loss decode), verify and
            audit, a repeat put with zero new plan compiles, conversion
            to product-matrix (16, 8, 14) and its batched repair, then a
            known-answer digest of a small store workload against the JAX
            reference's.  Each step reports wall ms, MB/s, launches, plan
            stats, peak device memory, the staging pool and the
            page-locked host bytes; put, the
            rack-0 degraded get and drain run once more under
            torch.profiler for device time by name and the device-busy
            share.  ``--store-mib N`` cuts only this payload.

Then a ``kernels`` JSON line (launches on the main and the store path), the ``nvidia-smi`` name/power-limit line,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero.  Without CUDA, or run outside a checkout, it
exits non-zero before printing any result.  The script imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
P = 257
K = 8                                   # [16, 8]: CODE_16_8_F257

# Digests of the JAX reference's output (repro.core.msr.encode_file and
# RepairEngine.apply of decode_repair_matrix on CPU) for the known-answer
# input of known_answer() below — the cross-package anchor on the card.
KA_RED_SHA256 = \
    "07ba6cd2ac1b0edfdffd7faa39975fe120d14b8a34c90113377cdb4eb9e1ae55"
KA_DECODE_REPAIR_SHA256 = \
    "ad2973ad89358dfaf2c9ee9f0259cbc9a7e2f3b6c6b213b9869e7f0036d1cfda"
# Digest of the JAX reference's store_rehearsal() record (repro.store on
# CPU): shares, CRC ledgers, drain reports and convert receipt.
KA_STORE_SHA256 = \
    "8a19c2bfc2a920b5463f3426b5e046a8e36129763c242aef7a29481202246d25"

# Published peak device-memory rates (NVIDIA data sheets), by card name.
MEM_PEAK = (("H100 PCIe", 2.0e12, "H100 PCIe data sheet 2.0 TB/s"),
            ("H100 NVL", 3.9e12, "H100 NVL data sheet 3.9 TB/s"),
            ("H100", 3.35e12, "H100 SXM data sheet 3.35 TB/s"))
# Integer lanes run on the CUDA cores; the data sheet's float32 rate
# outside the tensor cores (67 TFLOP/s, H100 SXM) bounds them from above.
OPS_PEAK = (67e12, "H100 SXM float32 non-tensor 67 TFLOP/s")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def warm(fn, calls: int, seconds: float) -> None:
    """Run ``fn()`` at least ``calls`` times and for at least ``seconds``
    of synchronised work: after the smoke's host-side gaps (frees,
    allocations, checks) a short kernel's first ~30 launches ran 5-15%
    slower than the rest, so short kernels warm by time, not by count."""
    import torch
    t_end = time.perf_counter() + seconds
    n = 0
    while n < calls or time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
        n += 1


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of one ``fn()`` each, started
    on an idle device, after ``warmup`` calls: the host's launch work
    counts too.  The method of every ``ms`` since the first slice."""
    import torch
    warm(fn, warmup, 0.0)
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def time_back_to_back_ms(fn, reps: int, warmup: int, warm_s: float,
                         ) -> float:
    """Device time of one call of ``fn()``: CUDA events around ``reps``
    calls launched back to back, over ``reps``, after a warm-up of at
    least ``warmup`` calls and ``warm_s`` seconds.  The host's work
    between launches hides behind the device's."""
    import torch
    warm(fn, warmup, warm_s)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def host_us(fn, reps: int) -> float:
    """Host time of one ``fn()`` in microseconds: ``reps`` calls queued
    without a synchronise between them, so each returns once it has
    launched."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def bound(nbytes: float, ops: float, mem_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / mem_rate * 1e3
    t_ops = ops / OPS_PEAK[0] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases
def gf_matmul_grid(torch, gfm, ref, rnd, cmp, p: int) -> None:
    """gf_matmul over m x k at modulus p, each case on its own mix of
    stream length, row-source split, batching and input range."""
    streams = (1, 3, 4, 1000, 1027, 4096, 5003, 66000)
    cases = [(m, k) for m in (1, 2, 3, 16, 17, 18, 24, 32, 33, 64, 65)
             for k in (1, 9, 16, 257, 300)]
    for i, (m, k) in enumerate(cases):
        s = streams[i % len(streams)]
        nsrc = min(k, 1 + i % 4)
        cuts = [1] * (nsrc - 1) + [k - (nsrc - 1)]    # uneven: 1, .., rest
        if nsrc > 1 and i % 2:
            cuts = cuts[::-1]
        # unbatched / one a for the batch / one a per element, each with
        # its own input range: reduced, unreduced, any int32
        batch = (None, 3, 3)[i % 3]
        lo, hi = ((-2 ** 31, 2 ** 31 - 1), (0, p), (0, 4 * p))[i % 3]
        lead = () if batch is None else (batch,)
        srcs = []
        for j, r in enumerate(cuts):
            if (i + j) % 5 == 4:    # a base 4 bytes past a 16-byte boundary
                flat = rnd((1 + r * s * (batch or 1),), p, lo, hi)
                srcs.append(flat[1:].view(lead + (r, s)))
            else:
                srcs.append(rnd(lead + (r, s), p, lo, hi))
        a = rnd(((batch,) if i % 3 == 2 else ()) + (m, k), p, lo, hi)
        shapes = [tuple(x.shape) for x in srcs]
        cmp("gf_matmul", gfm(a, tuple(srcs), p),
            ref.gf_matmul_ref(a, torch.cat(srcs, dim=-2), p),
            f"p={p} a{tuple(a.shape)} sources {shapes} range [{lo}, {hi})")


def phase_kernels(torch, gfm, circ, ref, fold_mismatches, s_main: int,
                  store_obj_bytes: int) -> dict:
    """Each kernel vs its plain version, exact; returns max |diff| per
    kernel.  These launches are outside the main path's count."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    diffs = {"gf_matmul": 0, "circulant_encode": 0}
    cases = 0

    def rnd(shape, p, lo=0, hi=None):
        return torch.randint(lo, p if hi is None else hi, shape,
                             generator=gen, dtype=torch.int32, device=dev)

    def cmp(name, got, want, what):
        nonlocal cases
        d = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        require(got.shape == want.shape and d == 0,
                f"{name} vs plain at {what}: max |diff| {d}")
        diffs[name] = max(diffs[name], d)
        cases += 1

    s_odd = (1 << 20) + 3
    folds = {}
    for p in (5, 257, 46337):
        folds[p] = fold_mismatches(p)
        require(folds[p] == 0, f"Barrett fold exact for every uint32 at p={p}"
                f" ({folds[p]} mismatches)")
        gf_matmul_grid(torch, gfm, ref, rnd, cmp, p)
        for m, k, s in ((2, 8, s_odd), (16, 16, 1 << 20), (3, 300, 640),
                        (128, 128, 256), (1, 7, 130)):
            a, b = rnd((m, k), p), rnd((k, s), p)
            cmp("gf_matmul", gfm(a, b, p), ref.gf_matmul_ref(a, b, p),
                f"p={p} ({m},{k})@({k},{s})")
        for k in (127, 128, 129, 300):
            a = torch.full((2, k), p - 1, dtype=torch.int32, device=dev)
            b = torch.full((k, 384), p - 1, dtype=torch.int32, device=dev)
            cmp("gf_matmul", gfm(a, b, p), ref.gf_matmul_ref(a, b, p),
                f"p={p} all-(p-1) k={k}")
        b = rnd((4, 8, 4099), p)
        for a in (rnd((2, 8), p), rnd((4, 2, 8), p)):
            cmp("gf_matmul", gfm(a, b, p), ref.gf_matmul_ref(a, b, p),
                f"p={p} batched a{tuple(a.shape)}")
        for k in (1, 2, 3, 8, 16, 64, 130):
            c = rnd((k,), p - 1).add_(1).tolist()
            for s in (4096, 1001):
                d = rnd((2 * k, s), p)
                cmp("circulant_encode", circ(d, c, p),
                    ref.circulant_encode_ref(d, c, p),
                    f"p={p} k={k} s={s}")
        d = torch.full((260, 257), p - 1, dtype=torch.int32, device=dev)
        cmp("circulant_encode", circ(d, [p - 1] * 130, p),
            ref.circulant_encode_ref(d, [p - 1] * 130, p),
            f"p={p} all-(p-1) k=130")
    # the main path's own shapes, p = 257
    from repro_torch.core.circulant import CodeSpec
    spec = CodeSpec.make(K, P)
    n = spec.n
    d = rnd((n, s_main), P)
    cmp("circulant_encode", circ(d, spec.c, P),
        ref.circulant_encode_ref(d, spec.c, P), f"main ({n},{s_main})")
    del d
    for a_shape, src_shapes in main_matmul_shapes(n, s_main):
        a = rnd(a_shape, P)
        srcs = tuple(rnd(x, P) for x in src_shapes)
        cmp("gf_matmul", gfm(a, srcs, P), ref.gf_matmul_ref(a, srcs, P),
            f"main a{a_shape} sources {src_shapes}")
        del a, srcs
    # the store path's own shapes (phase store)
    for s in (STORE_STRIPE, STORE_PUT_TILE * STORE_STRIPE):
        d = rnd((n, s), P)
        cmp("circulant_encode", circ(d, spec.c, P),
            ref.circulant_encode_ref(d, spec.c, P), f"store put ({n},{s})")
        del d
    for what, a_shape, src_shapes in store_matmul_shapes(store_obj_bytes):
        a = rnd(a_shape, P)
        srcs = tuple(rnd(x, P) for x in src_shapes)
        cmp("gf_matmul", gfm(a, srcs, P), ref.gf_matmul_ref(a, srcs, P),
            f"store {what} a{a_shape} sources {src_shapes}")
        del a, srcs
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"diffs": diffs, "cases": cases, "fold_mismatches": folds}


def main_matmul_shapes(n: int, s: int) -> list:
    """gf_matmul's operands on the main path, in the row-source form its
    callers hand it: decode and decode+repair (two failed nodes) over the
    k data and k redundancy downloads, regenerate of 1 and 4 nodes over
    r_prev beside the k helper rows."""
    return [((n, n), ((K, s), (K, s))),
            ((n + 2, n), ((K, s), (K, s))),
            ((2, K + 1), ((1, s), (K, s))),
            ((2, K + 1), ((4, 1, s), (4, K, s)))]


def store_matmul_shapes(obj_bytes: int) -> list:
    """gf_matmul's operands on the store path (phase store), in the form
    the store hands them over, at STORE_STRIPE symbols per block:
    degraded-get decodes of 1..k lost data rows over one staged (2k, g*S)
    download of g stripes, multi-loss decode+repair of one stripe with
    1..k nodes lost (rack 0 takes 6-8 of a stripe's 16), the coalesced
    single-loss repair over (r_prev, next_data) in a full and a ragged
    window, and the product-matrix (16, 8, 14) class of the converted
    object: its encode window, one repair window's helper sends (one
    (1, q) matrix per helper) and its newcomer products (one (q, d)
    matrix per stripe)."""
    s, n = STORE_STRIPE, 2 * K
    d = PM_CLASS[3]
    q = d - K + 1                                   # 7 blocks per node
    t_pm = -(-obj_bytes // (K * q * s))             # stripes of the object
    f_pm = min(t_pm, STORE_REPAIR_TILE)
    return ([("degraded get", (m, n), ((n, (1 + m % 4) * s),))
             for m in range(1, K + 1)]
            + [("multi-loss repair", (n + f, n), ((n, s),))
               for f in (1, 6, 7, 8)]
            + [("coalesced repair", (2, K + 1), ((f, 1, s), (f, K, s)))
               for f in (STORE_REPAIR_TILE, 13)]
            + [("product-matrix encode", (K * q, K * q), ((K * q, t_pm * s),)),
               ("product-matrix helper sends", (d * f_pm, 1, q),
                ((d * f_pm, q, s),)),
               ("product-matrix repair", (f_pm, q, d), ((f_pm, d, s),))])


def known_answer(torch, msr_mod, spec) -> None:
    """Encode and decode+repair a small seeded input on the card and hold
    the digests to the JAX reference's."""
    import numpy as np
    payload = np.random.default_rng(1).integers(
        0, 256, size=16 * 4099 - 5, dtype=np.uint8).tobytes()
    code = msr_mod.DoubleCirculantMSR(spec)
    enc = msr_mod.encode_file(payload, spec, code)
    red = enc.red.cpu().numpy().astype("<i4")
    require(hashlib.sha256(red.tobytes()).hexdigest() == KA_RED_SHA256,
            "known-answer encode digest vs the JAX reference")
    use, failed = (1, 3, 4, 6, 8, 10, 11, 15), (2, 9)
    idx = torch.as_tensor([i - 1 for i in use], device="cuda")
    mat = code.repair.decode_repair_matrix(use, failed)
    out = code.repair.apply(mat, torch.cat([enc.data[idx], enc.red[idx]]))
    got = out.cpu().numpy().astype("<i4")
    require(hashlib.sha256(got.tobytes()).hexdigest()
            == KA_DECODE_REPAIR_SHA256,
            "known-answer decode+repair digest vs the JAX reference")
    require(msr_mod.reconstruct_file(enc, list(use), code) == payload,
            "known-answer any-k decode")


def phase_main(torch, np, msr_mod, plan_mod, gfm, circ, payload_bytes: int,
               ) -> dict:
    """The main path at [16, 8] over GF(257); counters set to 0 just
    before and read just after."""
    from repro_torch.core.circulant import CodeSpec
    spec = CodeSpec.make(K, P)
    n = spec.n
    payload = np.random.default_rng(0).integers(
        0, 256, size=payload_bytes, dtype=np.uint8).tobytes()
    secs: dict = {}
    peak: dict = {}           # per op: peak device bytes over the bytes held
    slack = 4 << 20           # allocator rounding of the large blocks

    def clock(name, fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        top = torch.cuda.max_memory_allocated()
        peak[name] = {"max_memory_allocated": top, "over_base": top - base}
        return out

    def one_launch(name, fn):
        """fn() must be exactly one gf_matmul launch and nothing else that
        counts: no epilogue, no second product."""
        n0 = gfm.launches
        out = fn()
        require(gfm.launches == n0 + 1,
                f"{name} is one gf_matmul launch ({gfm.launches - n0})")
        return out

    def require_peak(name, nbytes, what):
        require(peak[name]["over_base"] <= nbytes + slack,
                f"{name} peaks at {peak[name]['over_base']} B over its "
                f"inputs, more than {nbytes} B ({what})")

    gfm.launches = 0
    circ.launches = 0
    code = msr_mod.DoubleCirculantMSR(spec)
    require(code.backend_name == "cuda", f"backend {code.backend_name}")
    enc = clock("encode_file", lambda: msr_mod.encode_file(payload, spec,
                                                           code))
    s = enc.data.shape[1]
    require(tuple(enc.red.shape) == (n, s) and enc.red.dtype == torch.int32,
            "encode shape")
    require(int(enc.red.max()) < P and int(enc.red.min()) >= 0,
            "redundancy symbols in [0, p)")

    def helpers(nodes):
        plans = [code.repair_plan(i) for i in nodes]
        r_prevs = enc.red[torch.as_tensor([pl.prev_node - 1 for pl in plans],
                                          device="cuda")]
        nxt = enc.data[torch.as_tensor([list(pl.data_indices)
                                        for pl in plans], device="cuda")]
        return r_prevs, nxt

    # node 3 dies: regenerated from d = k+1 determined helpers; every
    # regenerate is one launch whose only allocation is its output
    r1, n1 = helpers([3])
    for name in ("regenerate_1", "regenerate_1_again"):
        pair = clock(name, lambda: one_launch(
            name, lambda: code.regenerate_batch([3], r1, n1)))
        require(torch.equal(pair[0, 0], enc.data[2])
                and torch.equal(pair[0, 1], enc.red[2]),
                "regenerated node 3 is bit-exact")
        require_peak(name, pair.numel() * 4, "its output")
        del pair
    a3, r3 = clock("regenerate_single", lambda: one_launch(
        "regenerate_single", lambda: code.regenerate(3, r1[0], n1[0])))
    require(torch.equal(a3, enc.data[2]) and torch.equal(r3, enc.red[2]),
            "single-node regenerate of node 3 is bit-exact")
    require_peak("regenerate_single", 2 * a3.numel() * 4, "its output")
    del a3, r3
    nodes4 = [3, 7, 11, 16]
    r4, n4 = helpers(nodes4)
    for name in ("regenerate_4", "regenerate_4_again"):
        pairs = clock(name, lambda: one_launch(
            name, lambda: code.regenerate_batch(nodes4, r4, n4)))
        for j, i in enumerate(nodes4):
            require(torch.equal(pairs[j, 0], enc.data[i - 1])
                    and torch.equal(pairs[j, 1], enc.red[i - 1]),
                    f"batched regenerate node {i} bit-exact")
        require_peak(name, pairs.numel() * 4, "its output")
        del pairs
    del n4, r4

    # any-k decode from a seeded random k-subset, twice
    subset = sorted(int(x) + 1 for x in
                    np.random.default_rng(1).choice(n, size=K, replace=False))
    info0 = code.repair.decode_cache.cache_info()
    got = clock("reconstruct_file", lambda: msr_mod.reconstruct_file(
        enc, subset, code))
    require(got == payload, f"any-k decode from {subset} byte-identical")
    got = clock("reconstruct_file_again", lambda: msr_mod.reconstruct_file(
        enc, subset, code))
    require(got == payload, "second any-k decode byte-identical")
    info1 = code.repair.decode_cache.cache_info()
    require(info1.hits == info0.hits + 1 and info1.misses == info0.misses + 1,
            f"second decode is a cache hit ({info0} -> {info1})")
    del got

    # two nodes lost: data and both redundancy blocks from one matmul
    failed = [2, 9]
    use = [i for i in range(1, n + 1) if i not in failed][:K]
    idx = torch.as_tensor([i - 1 for i in use], device="cuda")
    fidx = torch.as_tensor([f - 1 for f in failed], device="cuda")
    for name in ("reconstruct_with_repair", "reconstruct_with_repair_again"):
        dat, red = clock(name, lambda: code.reconstruct_with_repair(
            use, enc.data[idx], enc.red[idx], failed))
        require(torch.equal(dat, enc.data)
                and torch.equal(red, enc.red[fidx]),
                "multi-failure repair bit-exact")
        # the smoke's two helper gathers and the (n + F, S) output; a
        # concatenated download would add 2k * S * 4 bytes
        require_peak(name, (2 * K + n + len(failed)) * s * 4,
                     "the helper gathers and the output: no concatenated "
                     "download")
        del dat, red

    # the planned path, then a repeat that must compile nothing new
    dl = torch.cat([enc.data[idx], enc.red[idx]])
    mat = code.repair.decode_matrix(tuple(use))
    red_h = enc.red.cpu().numpy()
    data_h = enc.data.cpu().numpy()

    def planned():
        out = {"encode": code.encode_planned(enc.data).host(),
               "regen": one_launch(
                   "regenerate_batch_planned",
                   lambda: code.repair.regenerate_batch_planned(
                       [3], r1, n1)).host(),
               "regen_single": one_launch(
                   "regenerate_planned",
                   lambda: code.repair.regenerate_planned(
                       3, r1[0], n1[0])).host(),
               "decode": code.repair.apply_planned(mat, dl).host()}
        require(np.array_equal(out["encode"], red_h), "encode_planned")
        require(np.array_equal(out["regen"][0, 0], data_h[2])
                and np.array_equal(out["regen"][0, 1], red_h[2]),
                "regenerate_batch_planned")
        require(np.array_equal(out["regen_single"][0], data_h[2])
                and np.array_equal(out["regen_single"][1], red_h[2]),
                "regenerate_planned")
        require(np.array_equal(out["decode"], data_h), "apply_planned")

    clock("planned", planned)
    st0 = plan_mod.plan_stats()
    clock("planned_again", planned)
    st1 = plan_mod.plan_stats()
    require(st1.compiles == st0.compiles and st1.misses == st0.misses
            and st1.hits >= st0.hits + 4,
            f"planned repeat compiles nothing new ({st0} -> {st1})")
    launches = {"gf_matmul": gfm.launches,
                "circulant_encode": circ.launches}
    require(all(v > 0 for v in launches.values()),
            f"both kernels ran on the main path: {launches}")
    del enc, dl, r1, n1
    torch.cuda.empty_cache()
    return {"launches": launches, "symbols_per_block": s, "subset": subset,
            "failed": failed, "plan_stats": list(st1), "seconds": secs,
            "peak_bytes": peak}


def phase_times(torch, gfm, circ, ref, s: int, mem_rate: float) -> dict:
    """Kernel, plain and yardstick times at the main path's shapes."""
    from repro_torch.core.circulant import CodeSpec
    spec = CodeSpec.make(K, P)
    n = spec.n
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def rnd(shape):
        return torch.randint(0, P, shape, generator=gen, dtype=torch.int32,
                             device="cuda")

    rows = []

    def row(name, what, shape, kernel, plain, lib, nbytes, ops):
        t_b, by = bound(nbytes, ops, mem_rate)
        ms = time_ms(kernel, 10)
        rows.append({"name": name, "op": what, "shape": shape, "ms": ms,
                     "ms_back_to_back": time_back_to_back_ms(
                         kernel, 20, warmup=10, warm_s=0.1),
                     "host_us": host_us(kernel, 20),
                     "plain_ms": time_ms(plain, 3, warmup=1),
                     "library_ms": time_ms(lib, 10),
                     "bound_ms": t_b, "bound_by": by,
                     "share_of_bound": t_b / ms})

    # encode; yardstick: the dense (n, n) encode matrix over the data in
    # float32 — sums of k products of at most 256^2, exact below 2^24
    d = rnd((n, s))
    enc_f = torch.from_numpy(spec.matrix_m().T.astype("float32")).cuda()
    d_f = d.float()
    lib = lambda: torch.remainder(torch.matmul(enc_f, d_f), P)  # noqa: E731
    require(torch.equal(lib().to(torch.int32), circ(d, spec.c, P)),
            "float32 yardstick agrees at encode")
    row("circulant_encode", None, f"({n},{s})",
        lambda: circ(d, spec.c, P),
        lambda: ref.circulant_encode_ref(d, spec.c, P), lib,
        2 * n * s * 4, 2 * n * K * s)
    del d, d_f
    torch.cuda.empty_cache()
    # gf_matmul at the main path's shapes, in the row-source form its
    # callers use
    for what, (a_shape, src_shapes) in zip(
            ("decode", "decode_repair", "regenerate_F1", "regenerate_F4"),
            main_matmul_shapes(n, s)):
        a = rnd(a_shape)
        srcs = tuple(rnd(x) for x in src_shapes)
        fb = srcs[0].shape[0] if srcs[0].dim() == 3 else 1
        m, k = a_shape
        af, bf = a.float(), torch.cat(srcs, dim=-2).float()
        lib = lambda: torch.remainder(torch.matmul(af, bf), P)  # noqa: E731
        require(torch.equal(lib().to(torch.int32), gfm(a, srcs, P)),
                f"float32 yardstick agrees at {what}")
        row("gf_matmul", what, f"a{a_shape} sources {src_shapes}",
            lambda: gfm(a, srcs, P), lambda: ref.gf_matmul_ref(a, srcs, P),
            lib, (a.numel() + sum(x.numel() for x in srcs) + fb * m * s) * 4,
            2 * fb * m * k * s)
        del a, srcs, af, bf
        torch.cuda.empty_cache()
    # host <-> device copies of 1 GiB, pinned and pageable
    nb = 1 << 30
    host = torch.empty(nb, dtype=torch.uint8).pin_memory()
    pageable = torch.empty(nb, dtype=torch.uint8)
    devbuf = torch.empty(nb, dtype=torch.uint8, device="cuda")
    copies = {
        "h2d_pinned_ms": time_ms(lambda: devbuf.copy_(host, non_blocking=True),
                                 5),
        "d2h_pinned_ms": time_ms(lambda: host.copy_(devbuf, non_blocking=True),
                                 5),
        "h2d_pageable_ms": time_ms(lambda: devbuf.copy_(pageable), 3),
        "d2h_pageable_ms": time_ms(lambda: pageable.copy_(devbuf), 3),
    }
    dev2 = torch.empty_like(devbuf)
    copies["d2d_ms"] = time_ms(lambda: dev2.copy_(devbuf), 5)
    copies["bytes"] = nb
    copies["d2d_gbps"] = 2 * nb / copies["d2d_ms"] / 1e6
    del host, pageable, devbuf, dev2
    torch.cuda.empty_cache()
    return {"rows": rows, "copies": copies}


# --------------------------------------------------------------- store path
STORE_NODES = 20            # bench_store.py's spec.n + 4, default 2 racks
STORE_STRIPE = 1 << 16      # symbols per block: 64 KiB blocks, 1 MiB stripes
STORE_OBJECTS = 16
STORE_PUT_TILE = 64         # the store's default put_tile_stripes
STORE_REPAIR_TILE = 64      # and repair_tile_tasks
PM_CLASS = ("product-matrix", 16, 8, 14)


def store_rehearsal(CodeSpec, Store, Scheduler, CodeClass, **store_kw,
                    ) -> str:
    """The store known-answer workload, on whichever package's classes it
    is handed; returns the sha256 of its canonical JSON record.

    [16, 8] over GF(257) on 20 nodes with 4099-symbol stripes; three
    objects (1 MiB + 17 B, 300 KiB, 5 B) from ``default_rng(0)``; node 3
    fails, is replaced and drained, then rack 0, then ``o0`` converts to
    product-matrix (16, 8, 14), then node 5.  The record holds every
    object's CRC ledger, the three drain reports, the convert receipt and
    the sha256 of every share left, in (phys, key, stripe) order."""
    import dataclasses

    import numpy as np
    store = Store(CodeSpec.make(K, P), n_nodes=STORE_NODES,
                  stripe_symbols=4099, **store_kw)
    sched = Scheduler(store)
    store.subscribe(sched.on_event)
    rng = np.random.default_rng(0)
    objs = {}
    for key, size in (("o0", (1 << 20) + 17), ("o1", 300 << 10), ("o2", 5)):
        objs[key] = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        store.put(key, objs[key])
    drains = []

    def lose(victims):
        for v in victims:
            store.fail_node(v)
        for v in victims:
            store.replace_node(v)
        drains.append(sched.drain_all())

    lose([3])
    lose(list(store.layout.nodes_in(0)))
    receipt = store.convert("o0", CodeClass(*PM_CLASS))
    lose([5])
    for key, payload in objs.items():
        require(store.get(key) == payload, f"rehearsal object {key} reads "
                f"back")
    shares = []
    for phys in range(1, store.n_nodes + 1):
        held = store._shares[phys - 1]
        for key, t in sorted(held):
            share = held[(key, t)]
            h = hashlib.sha256(str(int(share[0])).encode())
            for blk in share[1:]:
                h.update(np.ascontiguousarray(blk, dtype="<i4").tobytes())
            shares.append([phys, key, t, h.hexdigest()])
    doc = {"share_crcs": {k: store.stat(k).share_crcs for k in sorted(objs)},
           "drains": [dataclasses.asdict(r) for r in drains],
           "convert": {"key": receipt.key,
                       "source": receipt.source.to_meta(),
                       "target": receipt.target.to_meta(),
                       "payload_bytes": receipt.payload_bytes,
                       "source_stripes": receipt.source_stripes,
                       "target_stripes": receipt.target_stripes,
                       "degraded_source_stripes":
                           receipt.degraded_source_stripes,
                       "bytes_read": receipt.bytes_read,
                       "latency_s": receipt.latency_s},
           "shares": shares}
    return hashlib.sha256(json.dumps(doc, sort_keys=True, separators=(
        ",", ":")).encode()).hexdigest()


def busy_share(torch, prof, wall_s: float) -> dict:
    """Device time by name and the device-busy share of ``wall_s`` from a
    ``torch.profiler`` run: the device's own events (kernels, copies)
    summed by name from ``key_averages()``, busy time as the union of
    their intervals."""
    on_card = torch.autograd.DeviceType.CUDA
    rows = [{"name": e.key[:90], "count": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in prof.key_averages() if e.device_type == on_card]
    rows.sort(key=lambda r: -r["device_ms"])
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == on_card)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    out = {"by_name": rows[:12],
           "kernel_ms": sum(r["device_ms"] for r in rows
                            if "emcpy" not in r["name"]
                            and "emset" not in r["name"]),
           "copy_ms": sum(r["device_ms"] for r in rows
                          if "emcpy" in r["name"]),
           "device_busy_ms": busy_us / 1e3,
           "wall_ms": wall_s * 1e3,
           "device_busy_share": busy_us / 1e3 / (wall_s * 1e3)}
    if not rows:
        out["note"] = "key_averages() shows no device time"
    return out


def host_pinned(torch) -> dict:
    """Byte counters of torch's page-locked host allocator
    (``torch.cuda.host_memory_stats``, where this torch has it): what the
    staging pools hold, since no result lands in page-locked memory."""
    fn = getattr(torch.cuda, "host_memory_stats", None)
    if fn is None:
        return {"note": "torch.cuda.host_memory_stats is not available"}
    return {k: v for k, v in fn().items() if "bytes" in k}


def phase_store(torch, np, gfm, circ, plan_mod, store_mib: int) -> dict:
    """The coded object store at [16, 8] over GF(257) on 20 nodes: put,
    get, degraded get, coalesced and multi-loss repair, verify, a repeat
    put, conversion to product-matrix and the store known-answer check.
    Kernel counts set to 0 just before and read just after."""
    from repro_torch.codes import CodeClass
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.store import CodedObjectStore, RepairScheduler
    spec = CodeSpec.make(K, P)
    obj_bytes = (store_mib << 20) // STORE_OBJECTS
    rng = np.random.default_rng(0)
    objs = {f"obj{i:02d}": rng.integers(0, 256, size=obj_bytes,
                                        dtype=np.uint8).tobytes()
            for i in range(STORE_OBJECTS)}
    payload = sum(len(v) for v in objs.values())
    arr = rng.standard_normal((1000, 37)).astype(np.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn((300, 7), generator=gen, device="cuda"),
            "b": torch.randn((129,), generator=gen, device="cuda").to(
                torch.bfloat16)}
    store = CodedObjectStore(spec, n_nodes=STORE_NODES,
                             stripe_symbols=STORE_STRIPE)
    require((store.put_tile_stripes, store.repair_tile_tasks)
            == (STORE_PUT_TILE, STORE_REPAIR_TILE), "store window defaults")
    require(store.code.backend_name == "cuda",
            f"store backend {store.code.backend_name}")
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    pool = store.code.planner.staging
    steps: dict = {}
    profiles: dict = {}

    def check_all(what):
        for key, v in objs.items():
            require(store.get(key) == v, f"{what}: {key} byte-identical")
        require(np.array_equal(store.get("array"), arr),
                f"{what}: array object")
        got = store.get_pytree("tree")
        require(list(got) == ["b", "w"] and all(
            got[k].device.type == "cuda" and got[k].dtype == tree[k].dtype
            and torch.equal(got[k], tree[k]) for k in tree),
            f"{what}: tree object on the card, bit-exact")

    def step(name, fn, nbytes=payload):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = {"gf_matmul": gfm.launches, "circulant_encode": circ.launches}
        st0 = plan_mod.plan_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st1 = plan_mod.plan_stats()
        row = {"wall_ms": dt * 1e3, "MBps": nbytes / dt / 1e6,
               "launches": {"gf_matmul": gfm.launches - n0["gf_matmul"],
                            "circulant_encode":
                                circ.launches - n0["circulant_encode"]},
               "plan": {"hits": st1.hits - st0.hits,
                        "misses": st1.misses - st0.misses,
                        "compiles": st1.compiles - st0.compiles},
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "staging": pool.stats()._asdict(),
               "host_pinned": host_pinned(torch)}
        steps[name] = row
        return out, row

    def profiled(name, fn):
        """``fn`` once more under torch.profiler (CPU + CUDA)."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profiles[name] = busy_share(torch, prof, wall)

    def get_all():
        res = {k: store.get_ext(k) for k in objs}
        for k, v in objs.items():
            require(res[k].obj == v, f"{k} byte-identical")
        return {"degraded_stripes": sum(r.degraded_stripes
                                        for r in res.values()),
                "bytes_read": sum(r.bytes_read for r in res.values())}

    def put_all():
        for k, v in objs.items():
            store.put(k, v)

    def drain_row(rep, row):
        """A drain's report on its step row; its rate is repair symbols
        moved (bytes, over GF(257) systematic storage) per second."""
        row.update({"repaired_stripes": rep.repaired_stripes,
                    "repaired_shares": rep.repaired_shares,
                    "batch_calls": rep.batch_calls,
                    "decode_calls": rep.decode_calls,
                    "symbols_moved": rep.symbols_moved,
                    "ratio_vs_rs": rep.ratio_vs_rs,
                    "MBps": rep.symbols_moved / row["wall_ms"] * 1e3 / 1e6})

    gfm.launches = 0
    circ.launches = 0
    # 1. put: one circulant_encode launch per put window
    _, row = step("put", lambda: (put_all(), store.put("array", arr),
                                  store.put_pytree("tree", tree)))
    windows = sum(-(-store.stat(k).n_stripes // store.put_tile_stripes)
                  for k in store.keys())
    require(row["launches"] == {"gf_matmul": 0, "circulant_encode": windows},
            f"put is one encode launch per window ({windows}): "
            f"{row['launches']}")
    row["windows"] = windows
    row["stripes"] = sum(store.stat(k).n_stripes for k in store.keys())
    # 2. healthy get: systematic, no kernel at all
    res, row = step("get", get_all)
    row.update(res)
    require(res["degraded_stripes"] == 0
            and row["launches"] == {"gf_matmul": 0, "circulant_encode": 0},
            f"healthy get launches nothing: {row['launches']}")
    check_all("healthy get")
    # 3. one node lost: degraded get, then the coalesced repair
    store.fail_node(3)
    res, row = step("degraded_get_node3", get_all)
    row.update(res)
    require(res["degraded_stripes"] > 0, "node 3 degrades some stripes")
    store.replace_node(3)
    rep, row = step("drain_node3", sched.drain_all, nbytes=0)
    drain_row(rep, row)
    require(rep.decode_calls == 0 and rep.batch_calls >=
            -(-rep.repaired_stripes // store.repair_tile_tasks)
            and row["launches"] == {"gf_matmul": rep.batch_calls,
                                    "circulant_encode": 0},
            f"node-3 drain is one launch per repair window: {row}")
    check_all("after node 3")
    # 4. rack 0 lost (10 of 20 nodes): multi-loss decodes
    rack0 = list(store.layout.nodes_in(0))

    def fail_rack():
        for v in rack0:
            store.fail_node(v)

    def replace_rack():
        for v in rack0:
            store.replace_node(v)

    fail_rack()
    res, row = step("degraded_get_rack0", get_all)
    row.update(res)
    replace_rack()
    rep, row = step("drain_rack0", sched.drain_all, nbytes=0)
    drain_row(rep, row)
    require(rep.decode_calls > 0 and row["launches"]["gf_matmul"] ==
            rep.decode_calls + rep.batch_calls,
            f"rack-0 drain: one launch per multi-loss decode: {row}")
    check_all("after rack 0")
    # 5. ground truth
    ok, row = step("verify", lambda: (store.verify(), store.audit()))
    require(ok[0] and ok[1].clean, "verify() and a clean audit")
    row["shares_checked"] = ok[1].shares_checked
    # 6. put again at equal size: nothing new to plan
    _, row = step("put_again", put_all)
    require(row["plan"]["compiles"] == 0 and row["plan"]["misses"] == 0,
            f"repeat put compiles nothing new: {row['plan']}")
    # 7. convert one object to product-matrix, lose a node, drain
    pm = CodeClass(*PM_CLASS)
    rec, row = step("convert_pm", lambda: store.convert("obj00", pm),
                    nbytes=obj_bytes)
    row.update({"target_stripes": rec.target_stripes,
                "bytes_read": rec.bytes_read})
    require(store.class_of("obj00") == pm and store.get("obj00") ==
            objs["obj00"], "converted object reads back")
    store.fail_node(7)
    store.replace_node(7)
    n_pm = sum(1 for t in range(store.stat("obj00").n_stripes)
               if 7 in store.placement_of("obj00", t))

    def pm_calls():
        st = plan_mod.plan_stats_by_family().get(pm.key())
        return 0 if st is None else st.hits + st.misses

    c0 = pm_calls()
    rep, row = step("drain_pm_node7", sched.drain_all, nbytes=0)
    drain_row(rep, row)
    # a product-matrix window is two planned launches: every helper send
    # of the window at once, then the newcomer products
    pm_windows, odd = divmod(pm_calls() - c0, 2)
    row.update({"pm_stripes": n_pm, "pm_windows": pm_windows})
    require(n_pm > 0 and not odd and rep.decode_calls == 0
            and pm_windows >= -(-n_pm // store.repair_tile_tasks)
            and row["launches"] == {"gf_matmul": rep.batch_calls + pm_windows,
                                    "circulant_encode": 0},
            f"node-7 drain: one launch per repair window and one more per "
            f"product-matrix window: {row}")
    check_all("after the product-matrix repair")
    launches = {"gf_matmul": gfm.launches, "circulant_encode": circ.launches}
    require(all(v > 0 for v in launches.values()),
            f"both kernels ran on the store path: {launches}")
    # profiled repeats of put, the rack-0 degraded get and its drain
    profiled("put", put_all)
    fail_rack()
    profiled("degraded_get_rack0", get_all)
    replace_rack()
    profiled("drain_rack0", sched.drain_all)
    check_all("after the profiled repeats")
    # 8. the store known answer, on the card
    digest, _ = step("known_answer", lambda: store_rehearsal(
        CodeSpec, CodedObjectStore, RepairScheduler, CodeClass), nbytes=0)
    require(digest == KA_STORE_SHA256,
            f"store known-answer digest {digest} vs the JAX reference")
    store.close()
    return {"launches": launches, "steps": steps, "profiles": profiles,
            "payload_bytes": payload, "objects": len(objs) + 2,
            "in_place_stages": store.code.planner.staged_in_place,
            "known_answer_sha256": digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--payload-mib", type=int, default=1024,
                    help="main-path payload; only the payload is ever cut, "
                         "never k or p (default 1024 = 1 GiB)")
    ap.add_argument("--store-mib", type=int, default=1024,
                    help="store-phase payload over 16 objects; only the "
                         "payload is ever cut (default 1024 = 1 GiB)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import msr as msr_mod
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.exec import plan as plan_mod
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.circulant_encode import circulant_encode as circ
    from repro_torch.kernels.gf_matmul import fold_mismatches
    from repro_torch.kernels.gf_matmul import gf_matmul as gfm

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    mem_rate, mem_src = next(((r, src) for key, r, src in MEM_PEAK
                              if key in name), MEM_PEAK[-1][1:])
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_peak_source": mem_src,
          "ops_peak_source": OPS_PEAK[1]})

    build_s = _build.build_all()
    _build.load("gf_matmul")
    _build.load("circulant_encode")
    regs = [ln.strip() for src in _build.SOURCES
            for ln in _build.build_log(src).splitlines() if "Used" in ln]
    emit({"phase": "build", "seconds": build_s, "ptxas": regs})

    payload_bytes = args.payload_mib << 20
    n = 2 * K
    s_main = -(-payload_bytes // n)
    if args.payload_mib != 1024:
        emit({"phase": "cut", "payload_mib": args.payload_mib,
              "full_payload_mib": 1024})

    t0 = time.perf_counter()
    kern = phase_kernels(torch, gfm, circ, ref, fold_mismatches, s_main,
                         (args.store_mib << 20) // STORE_OBJECTS)
    emit({"phase": "kernels", "ok": True, "cases": kern["cases"],
          "max_abs_diff_vs_plain": kern["diffs"],
          "fold_mismatches": kern["fold_mismatches"],
          "seconds": time.perf_counter() - t0})

    known_answer(torch, msr_mod, CodeSpec.make(K, P))
    emit({"phase": "known_answer", "ok": True,
          "encode_sha256": KA_RED_SHA256,
          "decode_repair_sha256": KA_DECODE_REPAIR_SHA256})

    t0 = time.perf_counter()
    main_res = phase_main(torch, np, msr_mod, plan_mod, gfm, circ,
                          payload_bytes)
    emit({"phase": "main", "ok": True, "code": f"[{n},{K}] GF({P})",
          "payload_bytes": payload_bytes, **main_res,
          "seconds_total": time.perf_counter() - t0})

    t0 = time.perf_counter()
    times = phase_times(torch, gfm, circ, ref, main_res["symbols_per_block"],
                        mem_rate)
    emit({"phase": "times", "card": smi, "rows": times["rows"],
          "copies": times["copies"], "seconds": time.perf_counter() - t0})

    if args.store_mib != 1024:
        emit({"phase": "cut", "store_mib": args.store_mib,
              "full_store_mib": 1024})
    t0 = time.perf_counter()
    store_res = phase_store(torch, np, gfm, circ, plan_mod, args.store_mib)
    emit({"phase": "store", "ok": True, "card": smi,
          "code": f"[{n},{K}] GF({P})", "nodes": STORE_NODES,
          "stripe_symbols": STORE_STRIPE, **store_res,
          "seconds": time.perf_counter() - t0})

    source = {"gf_matmul": ("src/repro_torch/csrc/gf_matmul.cu",
                            "src/repro/kernels/gf_matmul.py:96", "decode"),
              "circulant_encode": ("src/repro_torch/csrc/circulant_encode.cu",
                                   "src/repro/kernels/circulant_encode.py:74",
                                   None)}
    kernels = []
    for kname, (src, replaces, op) in source.items():
        row = next(r for r in times["rows"]
                   if r["name"] == kname and r.get("op") == op)
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_res["launches"][kname]
            + store_res["launches"][kname],
            "launches_by_path": {"main": main_res["launches"][kname],
                                 "store": store_res["launches"][kname]},
            "max_abs_err": kern["diffs"][kname],
            "max_abs_diff_vs_plain": kern["diffs"][kname],
            "ms": row["ms"], "ms_back_to_back": row["ms_back_to_back"],
            "host_us": row["host_us"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "share_of_bound": row["share_of_bound"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
