#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every result.

Run from the root of a checkout:

    python3 chip_smoke.py [--payload-mib 1024] [--store-mib 1024]
                          [--ckpt-mib 512] [--serve-mib 256]

It builds the port's Hopper kernels from ``src/repro_torch/csrc`` into
``build/kernels/`` and runs eighteen phases, each printing one JSON line:

1. device   the card (nvidia-smi name and power limit), torch and CUDA;
2. build    both kernels, one nvcc per source, started together;
3. kernels  each kernel against its plain torch version on the card,
            exact equality (tolerance 0: GF arithmetic is exact), at the
            listed shapes, over gf_matmul's grid of m, k, stream lengths
            (aligned, unaligned, s < 4), 1-4 row sources, batching, p and
            unreduced or negative inputs, and at the main path's, the
            store path's (store_matmul_shapes) and the checkpoint, serve
            and cluster paths' shapes (durability_shapes) and the model
            and families paths' (model_store_shapes for each stored
            parameter tree, demo_shapes), and the shard path's column
            windows (read and written in place through the row pitch);
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
            share.  ``--store-mib N`` cuts only this payload;
7. checkpoint
            the MSR checkpointer at [16, 8] on a 512 MiB training state of
            card tensors in a temporary directory: save (one
            circulant_encode launch per 2^20-symbol tile), write-behind
            save under an in-place update, systematic restore (no launch,
            equal to the state before the update), restore with node 5
            lost (regenerate) and with nodes 2, 9, 14 lost (decode+repair;
            one gf_matmul launch per tile each, pairs rewritten
            bit-exactly), repair_node, scrub clean and after a corrupted
            byte, a store-backed save/restore with a failed node, and the
            checkpoint known-answer digest against the JAX reference's
            files; wall ms, MB/s, launches, the copy of each result tile
            into the pooled buffer (``land_ms``) and peak device memory
            per step, device-busy share of a profiled save and
            reconstruct;
8. serve    the read front end before a fresh [16, 8] store on 20 nodes
            holding 256 MiB in 16 objects, node 3 lost, node 7 slow (hedges
            fire), one rotten share (CRC catch, quarantine): 64 reads over
            4 priorities into a queue of 48 (16 shed as Overloaded), one
            gf_matmul launch per failure pattern, zero corrupt payloads,
            then tick() drains the repairs and the quarantined node is
            scrubbed back in; p50/p99 latency, MB/s, wall ms;
9. cluster  the standard scenarios on the cluster simulator at [16, 8]
            with 2^22 symbols per block (256 MiB of int32 data), every one
            bit-exact, and a CodedReadServer tree round trip with 3 nodes
            down;
10. drills  every crash-consistency drill of the port on the card, at the
            reference's own sizes: passed, bit-exact, zero orphans;
11. shard   the stream-axis mesh: the planner's circulant_encode (16,S),
            decode (16,16), regenerate (2,9) and regenerate_batch F=4 at
            the main path's S over meshes of 1, 2, 4 and 8 shards on one
            card (and over the distinct cards where there are several),
            each bit-equal to the unsharded planner with one launch per
            shard, wall and device ms per mesh; the store and checkpoint
            known answers unsharded and under a mesh of 4 (both timed);
            ring_encode over 16 nodes on the int32 and byte wires equal to
            circulant_encode, 8 blocks a link; int8_ring_mean over four
            float32 rows of qwen3-4b's embedding (151936 x 2560) equal to
            its plain composition (max |diff| 0) and within 10 x the int8
            scale of the true mean;
12. model   qwen3-4b at full width, depth cut to 2 of 36 layers (a "cut"
            line says so), its 3.9 GB of float32 parameters drawn on the
            card from a seed: put into a [16, 8] store on 20 nodes (one
            circulant_encode launch per window), read by
            ServingEngine.from_coded_store (no launch, every leaf equal),
            4 requests of 2048 prompt tokens served greedily for 32 new
            tokens (the prefill takes the flash path), node 3 lost and
            reload_params (gf_matmul launches, leaves equal, the same
            tokens), drain and reload (equal again); the same weights on
            the CPU plain path against the card's logits and the JAX
            reference's known answer (KA_MODEL_LOGITS), both within
            0.125; serve_demo.py's rack kill on the card, bit-exact, and
            its repair.  Wall ms, prefill ms, decode ms a token, tokens/s,
            launches, peak device memory, the host's peak resident size;
13. families
            the registry's other block kinds at their published widths,
            only depth cut ("cut" lines): granite-moe-1b-a400m (MoE, 2 of
            24 layers) and whisper-medium (encoder-decoder, 2 + 2 of 24 +
            24) put into the [16, 8] store (one circulant_encode launch
            per window) and read with node 3 lost (one gf_matmul launch
            per failure pattern, every leaf equal); xlstm-1.3b (8 of 48:
            7 mLSTM + 1 sLSTM) and recurrentgemma-2b (3 of 26: rg, rg,
            la) drawn on the card; 4 requests each (2048 prompt tokens +
            32 greedy through ServingEngine; whisper: 1500 frame
            embeddings and a 256-token prompt + 32 through
            Model.prefill / decode_step), tokens from the read
            parameters equal to the put ones'; card vs CPU logits of a
            1 x 64 prompt and 4 decode steps within 0.125 (an MoE's
            routing held on identical logits; a card/CPU difference is
            allowed only where routing parted at a near-tie, reported);
            each family's known answer (KA_FAMILY_LOGITS).  Put and
            degraded-read ms, warm prefill ms, decode ms a token,
            tokens/s, peak device memory, the host's peak resident size;
14. train   qwen3-4b again (2 of 36 layers, float32 master parameters
            drawn on the card) trained by make_train_step with
            AdamWConfig() for 4 steps of 2 x 2048 batch_at tokens under
            deterministic algorithms: each step's wall ms (the first
            apart), tokens/s, loss and grad_norm (finite), the flash
            forward (twice, remat) and backward in both layers counted per
            step, peak device memory, the busy share of one more profiled
            step; the flash forward and backward alone at the steps' shape
            (bf16, 32 heads, two KV chunks of 1024) on the card and on the
            CPU, within 3e-2; one 1 x 64-token step on the card and on the
            CPU from the same weights, its attention on the flash path as
            the timed steps' (counted), loss within 1e-2 and the grads of
            lm_head, a query projection and a norm scale within 3e-2
            relative L2; then train_tiny_lm.py's crash drill on
            the card ([8, 4], 120 steps, checkpoints every 20, node 2 lost
            at step 80): one repair event, the loss falls, the final state
            bit-exact with an uninterrupted run, one circulant_encode
            launch per save tile and gf_matmul at the repair;
15. parallel
            the model-parallel half of the sharding layer on a (data=2,
            model=2) mesh over the card repeated (four cards where the
            host has them): the same qwen3-4b (2 of 36 layers) trained 3
            steps of 2 x 2048 tokens on state laid out by the policy's
            hybrid specs (heads, FFN and vocab split over model, FSDP
            over data), then under the dp layout (FSDP over all four),
            each against the unsharded step with 2 microbatches on the
            same inputs and initial parameters: loss per step within
            1e-2, step-1 grads within 3e-2 relative L2 per leaf, step ms
            and tokens/s, bytes moved between positions (gathers,
            reduces), bytes per position (device_bytes) against the
            storage the card holds, peak memory; phase model's
            parameters read with node 3 lost, laid out by the hybrid
            specs, serving 4 requests of 2048 prompt + 32 new tokens
            through make_prefill_step / make_decode_step (caches by
            cache_spec) against the unsharded steps (logits within
            0.125, greedy tokens equal where the top-2 margin exceeds
            0.25), prefill ms and decode ms a token; a sharded tiny-LM
            state saved through MSRCheckpointer (circulant_encode),
            files equal to an unsharded save's, restored with node 5
            lost (gf_matmul), re-placed bit-exactly, its next step
            bit-equal to the step without the round trip;
16. parallel_families
            every block kind split over the model axis: the families
            phase's four configs trained and served on the (2, 2) mesh
            against their unsharded steps, and an MoE state checkpointed
            with its experts split;
17. examples
            the reference's quickstart, store_demo and serve_demo through
            their twins (repro_torch.examples) at the reference's default
            sizes on the card: wall seconds, launches by example and
            every invariant of the reference (bit-exact regeneration,
            reads and restores, repair traffic below RS's, tokens equal
            healthy / degraded / healed, availability 1.0); gf256.matmul
            (16, 16) @ (16, 2^20) on the card bit-equal to the CPU's;
18. dryrun  repro_torch.launch.dryrun on the host's CPU (meta device, no
            kernel): the reference's reduced smoke cell on a (4, 2) mesh
            with its invariants, and arctic-480b at full depth on the
            16 x 16 mesh (DRYRUN_CELL), its run_s.

Then a ``done`` line with the smoke's total seconds, a ``kernels`` JSON line (launches by path), the ``nvidia-smi``
name/power-limit line, and last ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero.  Without CUDA, or run outside a checkout, it
exits non-zero before printing any result.  The script imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
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
# Digest of the step directory the JAX reference's MSRCheckpointer writes
# for ckpt_known_state() (ckpt_rehearsal(), repro.checkpoint on CPU).
KA_CKPT_SHA256 = \
    "8ba8e80582dbddd0d56e8489deeec4c9b79b1053569be4930300592486860480"

# Known answer of the model path: last-position logits (every 16th of the
# 512) of the JAX reference's Model.prefill (repro.models on CPU) for
# qwen3-4b .reduced(n_layers=2) on numpy_params(cfg, KA_MODEL_SEED) and
# the prompt ka_model_prompt().  The card must match within KA_MODEL_ATOL:
# the logits are bf16 products (8 significant bits, steps of 2^-6 at
# magnitude 2); XLA on the CPU evaluates chains of bf16 ops in fp32 where
# torch rounds after each op, so the two sit a few steps apart — four
# steps at magnitude 4.
KA_MODEL_ARCH = "qwen3-4b"
KA_MODEL_OVERRIDES = {"n_layers": 2}
KA_MODEL_SEED = 0
KA_MODEL_SLICE = slice(0, None, 16)
KA_MODEL_ATOL = 0.125
KA_MODEL_LOGITS = (
    -0.3984375, -1.1328125, -1.2109375, 0.921875, -0.06103515625,
    0.298828125, 1.3359375, 0.408203125, -0.212890625, -0.03662109375,
    -0.08935546875, 0.000514984130859375, 0.046142578125, 0.3125,
    0.83984375, 1.1640625, -0.41796875, -0.7265625, 0.91015625,
    0.26171875, 0.38671875, 0.197265625, 0.3828125, -0.83203125,
    -0.044189453125, 1.6015625, -0.9765625, 0.0654296875, -0.73828125,
    -0.90625, -0.34375, -1.125)


def ka_model_prompt(np, vocab: int):
    """The known-answer prompt: (1, 16) token ids from default_rng(1)."""
    return np.random.default_rng(1).integers(0, vocab, (1, 16)).astype(
        np.int32)


# Known answers of phase families: the same slice of the JAX reference's
# prefill logits for each new family's .reduced() config (xlstm cut to 9
# layers, as the CPU parity tests hold it: one full cycle and an mLSTM
# remainder) on numpy_params(cfg, KA_MODEL_SEED) and ka_family_batch();
# held within KA_MODEL_ATOL.
KA_FAMILY_OVERRIDES = {"xlstm-1.3b": {"n_layers": 9}}
KA_FAMILY_LOGITS = {
    "granite-moe-1b-a400m": (
        0.546875, -0.328125, 0.1884765625, -0.87109375, -0.54296875,
        0.353515625, 1.46875, -0.58984375, -0.515625, -0.83984375, -1.421875,
        0.271484375, 0.625, -1.578125, -0.5859375, 0.306640625, -1.5703125,
        -0.09521484375, 1.03125, 1.703125, -0.01092529296875, 0.2255859375,
        -0.2490234375, 0.24609375, 1.03125, -0.67578125, 0.26171875, 1.421875,
        -0.177734375, -1.0625, 0.41796875, 0.056396484375
    ),
    "xlstm-1.3b": (
        0.68359375, 0.07958984375, 0.373046875, -0.64453125, -1.3046875,
        1.0234375, 0.96875, -1.3046875, -0.50390625, 0.1279296875, 1.9453125,
        -1.140625, 0.93359375, -0.1640625, 0.99609375, -0.5, 0.298828125,
        0.3984375, 1.4765625, 1.6953125, -0.96484375, 1.3984375, -1.6875,
        1.34375, 0.62109375, 1.6796875, -0.93359375, 0.283203125, 1.6171875,
        0.0074462890625, -0.44140625, -1.8359375
    ),
    "recurrentgemma-2b": (
        1.3046875, 0.03173828125, 0.294921875, -2.09375, -1.1640625,
        0.2216796875, 0.8828125, -0.71875, -1.1015625, -1.875, 0.36328125,
        0.9375, -0.0712890625, -0.373046875, 1.0546875, 1.453125,
        -0.341796875, 0.5390625, 1.421875, 0.08251953125, -0.8984375,
        0.36328125, -1.5, -1.609375, -1.28125, 1.515625, 0.28125, -0.69140625,
        0.30078125, 1.0234375, 0.63671875, 0.016357421875
    ),
    "whisper-medium": (
        -0.50390625, -0.546875, -1.0625, 0.92578125, -1.4453125, 0.376953125,
        0.166015625, 0.294921875, 0.78125, -0.8046875, -0.75, 0.1318359375,
        0.25390625, -0.90234375, -0.50390625, -0.4140625, 0.06982421875,
        -0.96484375, 0.484375, -1.328125, -0.3984375, -0.79296875, -0.734375,
        0.443359375, -0.9609375, 1.0234375, -0.11669921875, -0.94921875,
        0.58984375, -0.400390625, -0.87890625, 0.66796875
    ),
}


def ka_family_batch(np, cfg) -> dict:
    """The known-answer batch of a family: ka_model_prompt()'s tokens,
    and for an encoder-decoder (1, encoder_seq, d) frame embeddings, 0.02
    times standard normals from default_rng(2)."""
    batch = {"tokens": ka_model_prompt(np, cfg.vocab_size)}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = (np.random.default_rng(2).standard_normal(
            (1, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


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


def counted(gfm, circ):
    """Launches of each kernel so far, to diff around a step."""
    return {"gf_matmul": gfm.launches, "circulant_encode": circ.launches}


def launched(gfm, circ, n0: dict) -> dict:
    return {k: v - n0[k] for k, v in counted(gfm, circ).items()}


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
                  store_obj_bytes: int, ckpt_mib: int, model_stripes: list,
                  demo_symbols: int, train_symbols: int) -> dict:
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
    # the shard path's windows (phase shard, mesh of 8): each kernel reads
    # a column window of the main path's operands and writes a window of
    # a larger output through its row pitch; the first and the last
    # shard, at S and at a ragged S - 5, nothing outside written
    for s_total in (s_main, s_main - 5):
        e = -(-s_total // 8)
        for lo in (0, 7 * e):
            hi = min(lo + e, s_total)
            what = f"shard window [{lo},{hi}) of {s_total}"
            d = rnd((n, s_total), P)
            out = torch.full((n, s_total), -1, dtype=torch.int32, device=dev)
            circ(d[:, lo:hi], spec.c, P, out=out[:, lo:hi])
            require(not bool(out[:, :lo].ne(-1).any()
                             or out[:, hi:].ne(-1).any()),
                    f"circulant_encode wrote only its {what}")
            cmp("circulant_encode", out[:, lo:hi],
                ref.circulant_encode_ref(d[:, lo:hi], spec.c, P), what)
            del d, out
            for a_shape, src_shapes in main_matmul_shapes(n, s_total):
                a = rnd(a_shape, P)
                srcs = tuple(rnd(x, P)[..., lo:hi] for x in src_shapes)
                lead = src_shapes[0][:-2] + (a_shape[0], s_total)
                out = torch.full(lead, -1, dtype=torch.int32, device=dev)
                gfm(a, srcs, P, out=out[..., lo:hi])
                require(not bool(out[..., :lo].ne(-1).any()
                                 or out[..., hi:].ne(-1).any()),
                        f"gf_matmul a{a_shape} wrote only its {what}")
                cmp("gf_matmul", out[..., lo:hi],
                    ref.gf_matmul_ref(a, srcs, P),
                    f"a{a_shape} sources {src_shapes}, {what}")
                del a, srcs, out
            torch.cuda.empty_cache()
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
    # the checkpoint, serve and cluster paths' own shapes
    encodes, matmuls = durability_shapes(ckpt_mib)
    for what, s in encodes:
        d = rnd((n, s), P)
        cmp("circulant_encode", circ(d, spec.c, P),
            ref.circulant_encode_ref(d, spec.c, P), f"{what} ({n},{s})")
        del d
    for what, a_shape, src_shapes in matmuls:
        a = rnd(a_shape, P)
        srcs = tuple(rnd(x, P) for x in src_shapes)
        cmp("gf_matmul", gfm(a, srcs, P), ref.gf_matmul_ref(a, srcs, P),
            f"{what} a{a_shape} sources {src_shapes}")
        del a, srcs
    # the model paths' own shapes (phases model and families: one stripe
    # count per stored parameter tree)
    model_matmuls = []
    for stripes in model_stripes:
        encodes, matmuls = model_store_shapes(stripes)
        model_matmuls += matmuls
        for what, s in encodes:
            d = rnd((n, s), P)
            cmp("circulant_encode", circ(d, spec.c, P),
                ref.circulant_encode_ref(d, spec.c, P), f"{what} ({n},{s})")
            del d
    demo = CodeSpec.make(DEMO_K, P)
    d = rnd((demo.n, demo_symbols), P)
    cmp("circulant_encode", circ(d, demo.c, P),
        ref.circulant_encode_ref(d, demo.c, P),
        f"demo encode ({demo.n},{demo_symbols})")
    for what, a_shape, src_shapes in (model_matmuls
                                      + demo_shapes(demo_symbols, demo.k)):
        a = rnd(a_shape, P)
        srcs = tuple(rnd(x, P) for x in src_shapes)
        cmp("gf_matmul", gfm(a, srcs, P), ref.gf_matmul_ref(a, srcs, P),
            f"{what} a{a_shape} sources {src_shapes}")
        del a, srcs
    # the train path's own shapes (phase train's crash drill, [8, 4])
    drill = CodeSpec.make(DRILL_K, P)
    train_encodes, train_matmuls = train_shapes(train_symbols)
    for what, s in train_encodes:
        d = rnd((drill.n, s), P)
        cmp("circulant_encode", circ(d, drill.c, P),
            ref.circulant_encode_ref(d, drill.c, P),
            f"{what} ({drill.n},{s})")
    for what, a_shape, src_shapes in train_matmuls:
        a = rnd(a_shape, P)
        srcs = tuple(rnd(x, P) for x in src_shapes)
        cmp("gf_matmul", gfm(a, srcs, P), ref.gf_matmul_ref(a, srcs, P),
            f"{what} a{a_shape} sources {src_shapes}")
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


def durability_shapes(ckpt_mib: int) -> tuple[list, list]:
    """circulant_encode's (what, s) and gf_matmul's (what, a, sources)
    operands on the checkpoint, serve and cluster paths, in the form
    their callers hand them over: the checkpoint's full and ragged save
    tiles, its regenerate over (r_prev, next_data), its decode+repair of
    3 lost nodes and its batched scrub over one staged tile each; the
    front end's per-pattern decodes of 1..k rows over a pattern's staged
    downloads (one object's 16 stripes); the simulator's encode, one-row
    and bulk decodes over (data, redundancy) row sources, regenerate and
    multi-loss repair at CLUSTER_SYMBOLS, and its batched scrub."""
    geo = ckpt_geometry(ckpt_mib)
    n, t, tail, s = 2 * K, geo["tile"], geo["tail"], CLUSTER_SYMBOLS
    encodes = [("checkpoint save tile", t), ("checkpoint ragged tail", tail),
               ("cluster encode", s)]
    matmuls = ([("checkpoint regenerate", (2, K + 1), ((1, x), (K, x)))
                for x in (t, tail)]
               + [("checkpoint decode+repair", (n + 3, n), ((n, x),))
                  for x in (t, tail)]
               + [("checkpoint scrub", (2, K + 1), ((n, 1, t), (n, K, t)))]
               + [("front end decode", (m, n), ((n, 16 * STORE_STRIPE),))
                  for m in range(1, K + 1)]
               + [("cluster one-row decode", (1, n), ((K, s), (K, s))),
                  ("cluster bulk decode", (3, n), ((K, s), (K, s))),
                  ("cluster regenerate", (2, K + 1), ((1, s), (K, s))),
                  ("cluster scrub", (2, K + 1), ((n, 1, s), (n, K, s)))]
               + [("cluster multi-loss repair", (n + f, n), ((K, s), (K, s)))
                  for f in (2, 5, 8)])
    return encodes, matmuls


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
    launches = counted(gfm, circ)
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


def store_objects(np, store_mib: int) -> tuple:
    """The store phase's STORE_OBJECTS random objects of store_mib MiB in
    all (seed 0), and the generator that made them."""
    obj_bytes = (store_mib << 20) // STORE_OBJECTS
    rng = np.random.default_rng(0)
    return rng, {f"obj{i:02d}": rng.integers(0, 256, size=obj_bytes,
                                             dtype=np.uint8).tobytes()
                 for i in range(STORE_OBJECTS)}


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


# ---------------------------------------------------------- checkpoint path
CKPT_TILE = 4099            # known-answer save tile: two tiles, one ragged
CKPT_COLS = 4096            # columns of the state's weight and moment stacks
CLUSTER_SYMBOLS = 1 << 22   # symbols per block of the cluster phase


def ckpt_geometry(ckpt_mib: int) -> dict:
    """Shapes of the checkpoint phase's state: rows of its (rows,
    CKPT_COLS) bf16 weight and two float32 moment stacks (10 bytes per
    element) plus an int64 step; symbols per block at [16, 8] and the
    save's stream tiles (2^20 symbols, the last one ragged)."""
    from repro_torch.checkpoint.msr_checkpoint import SAVE_TILE_SYMBOLS
    rows = max(1, (ckpt_mib << 20) // 10 // CKPT_COLS)
    nbytes = rows * CKPT_COLS * 10 + 8
    s_block = -(-nbytes // (2 * K))
    tiles = -(-s_block // SAVE_TILE_SYMBOLS)
    return {"rows": rows, "bytes": nbytes, "s_block": s_block,
            "tile": SAVE_TILE_SYMBOLS, "tiles": tiles,
            "tail": s_block - (tiles - 1) * SAVE_TILE_SYMBOLS}


def ckpt_state(torch, geo: dict) -> dict:
    """The checkpoint phase's training state on the card, from a seeded
    torch.Generator: a bf16 weight stack, two float32 moment stacks of
    (geo["rows"], CKPT_COLS) and an int64 step."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def stack(dtype):
        return torch.randn((geo["rows"], CKPT_COLS), generator=gen,
                           device="cuda").to(dtype)

    return {"params": {"w": stack(torch.bfloat16)},
            "opt": {"mu": stack(torch.float32),
                    "nu": stack(torch.float32).abs_(),
                    "step": torch.tensor(1000, dtype=torch.int64,
                                         device="cuda")}}


def ckpt_leaves(state) -> list:
    return [state["params"]["w"], state["opt"]["mu"], state["opt"]["nu"],
            state["opt"]["step"]]


def ckpt_known_state(np) -> dict:
    """The checkpoint known-answer state as numpy: a seeded training-state
    tree (float32 weights and moments, int32 ids, an int64 step)."""
    rng = np.random.default_rng(5)
    return {"params": {"w": rng.standard_normal((96, 129)).astype(np.float32),
                       "b": rng.integers(-2 ** 31, 2 ** 31 - 1, 77,
                                         dtype=np.int64).astype(np.int32)},
            "opt": {"mu": (rng.standard_normal((96, 129)) * 1e-3).astype(
                        np.float32),
                    "step": np.asarray(41, np.int64)}}


def ckpt_digest(step_dir: Path) -> str:
    """sha256 over a step directory: every file's name and bytes, an
    ``.npz`` by its members (its zip container carries the write time)."""
    import zipfile
    h = hashlib.sha256()
    for f in sorted(step_dir.iterdir()):
        h.update(f.name.encode())
        if f.suffix == ".npz":
            with zipfile.ZipFile(f) as z:
                for m in sorted(z.namelist()):
                    h.update(m.encode())
                    h.update(z.read(m))
        else:
            h.update(f.read_bytes())
    return h.hexdigest()


def ckpt_rehearsal(Checkpointer, CodeSpec, root: Path, state,
                   **ckpt_kw) -> str:
    """The checkpoint known-answer workload, on whichever package's
    checkpointer it is handed: save ``state`` (ckpt_known_state(), as
    that package's leaves) at step 3 with [16, 8] over GF(257) and
    CKPT_TILE-symbol tiles under ``root``; returns ckpt_digest() of the
    step directory."""
    ck = Checkpointer(root, CodeSpec.make(K, P), save_tile_symbols=CKPT_TILE,
                      **ckpt_kw)
    ck.save(3, state)
    ck.close()
    return ckpt_digest(Path(root) / "step_000003")


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
    rng, objs = store_objects(np, store_mib)
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
        n0 = counted(gfm, circ)
        st0 = plan_mod.plan_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st1 = plan_mod.plan_stats()
        row = {"wall_ms": dt * 1e3, "MBps": nbytes / dt / 1e6,
               "launches": launched(gfm, circ, n0),
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
    launches = counted(gfm, circ)
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


def phase_checkpoint(torch, np, gfm, circ, ckpt_mib: int) -> dict:
    """The MSR checkpointer at [16, 8] over GF(257) on a training-state
    tree of card tensors (ckpt_mib MiB: a bf16 weight stack, two float32
    moment stacks and an int64 step from a seeded torch.Generator) in a
    temporary directory on local disk: save, write-behind save under an
    in-place update, systematic / regenerate / reconstruct restores,
    repair_node, scrub clean and after a corrupted byte, a store-backed
    save/restore with a failed node, profiled repeats and the checkpoint
    known-answer digest.  Kernel counts set to 0 just before and read
    just after."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import MSRCheckpointer
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.exec import staging
    from repro_torch.store import CodedObjectStore
    spec = CodeSpec.make(K, P)
    n = spec.n
    geo = ckpt_geometry(ckpt_mib)
    state = ckpt_state(torch, geo)
    leaves = ckpt_leaves(state)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    s_block, tiles = geo["s_block"], geo["tiles"]
    require(nbytes == geo["bytes"], "state bytes as ckpt_geometry says")
    root = Path(tempfile.mkdtemp(prefix="msr_ckpt_"))
    steps: dict = {}
    profiles: dict = {}

    def equal(a, b) -> bool:
        return all(torch.equal(x, y)
                   for x, y in zip(ckpt_leaves(a), ckpt_leaves(b)))

    def step(name, fn, nbytes=nbytes):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = counted(gfm, circ)
        land0 = staging.stage_times().get("land", 0.0)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        row = {"wall_ms": dt * 1e3, "MBps": nbytes / dt / 1e6,
               "launches": launched(gfm, circ, n0),
               "land_ms": (staging.stage_times().get("land", 0.0) - land0)
               * 1e3,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        steps[name] = row
        return out, row

    def profiled(name, fn):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profiles[name] = busy_share(torch, prof, wall)

    def unlink(step_no, nodes):
        for f in nodes:
            for path in ck._node_files(step_no, f):
                path.unlink()

    gfm.launches = 0
    circ.launches = 0
    try:
        ck = MSRCheckpointer(root, spec)
        require(ck.code.backend_name == "cuda" and ck.device.type == "cuda",
                f"checkpointer on the card ({ck.code.backend_name})")
        # 1. save: one circulant_encode launch per stream tile
        _, row = step("save", lambda: ck.save(1, state))
        require(row["launches"] == {"gf_matmul": 0,
                                    "circulant_encode": tiles},
                f"save is one encode launch per tile ({tiles}): {row}")
        digest1 = ckpt_digest(ck._step_dir(1))
        # 2. write-behind: every leaf updated in place on the card at once
        before = {"params": {"w": state["params"]["w"].clone()},
                  "opt": {k: v.clone() for k, v in state["opt"].items()}}

        def save_async():
            t0 = time.perf_counter()
            ck.save_async(2, state)
            returned = time.perf_counter() - t0
            state["params"]["w"].add_(1)
            state["opt"]["mu"].mul_(0.9).add_(0.1)
            state["opt"]["nu"].mul_(0.99)
            state["opt"]["step"].add_(1)
            ck.barrier()
            return returned

        returned, row = step("save_async", save_async)
        row["returned_ms"] = returned * 1e3
        require(row["launches"]["circulant_encode"] == tiles,
                f"write-behind save is one encode launch per tile: {row}")
        # 3. systematic restore: the state before the update, bit for bit
        (got, rep), row = step("restore_systematic",
                               lambda: ck.restore(state, 2))
        require(rep.path == "systematic" and equal(got, before)
                and got["params"]["w"].device.type == "cuda",
                "write-behind restore equals the pre-update state")
        require(row["launches"] == {"gf_matmul": 0, "circulant_encode": 0},
                f"systematic restore launches nothing: {row}")
        row["bytes_read"] = rep.bytes_read
        del got
        digest2 = ckpt_digest(ck._step_dir(2))
        # 4. node 5 lost: regenerate, one gf_matmul launch per tile
        unlink(2, [5])
        (got, rep), row = step("restore_regenerate_node5",
                               lambda: ck.restore(before, 2,
                                                  failed_nodes=[5]))
        require(rep.path == "regenerate" and rep.repaired_nodes == (5,)
                and equal(got, before), "regenerate restore bit-exact")
        require(row["launches"] == {"gf_matmul": tiles,
                                    "circulant_encode": 0},
                f"regenerate is one launch per tile ({tiles}): {row}")
        require(ckpt_digest(ck._step_dir(2)) == digest2,
                "node 5's pair rewritten bit-exactly")
        row["bytes_read"] = rep.bytes_read
        del got
        # 5. nodes 2, 9, 14 lost: reconstruct + repair, one launch per tile
        unlink(2, [2, 9, 14])
        (got, rep), row = step("restore_reconstruct_2_9_14",
                               lambda: ck.restore(before, 2,
                                                  failed_nodes=[2, 9, 14]))
        require(rep.path == "reconstruct" and rep.repaired_nodes == (2, 9, 14)
                and equal(got, before), "reconstruct+repair restore bit-exact")
        require(row["launches"] == {"gf_matmul": tiles,
                                    "circulant_encode": 0},
                f"decode+repair is one launch per tile ({tiles}): {row}")
        require(ckpt_digest(ck._step_dir(2)) == digest2,
                "the three lost pairs rewritten bit-exactly")
        row["bytes_read"] = rep.bytes_read
        del got
        # 6. the newcomer protocol alone
        unlink(2, [7])
        gamma, row = step("repair_node7", lambda: ck.repair_node(2, 7))
        require(row["launches"]["gf_matmul"] == tiles
                and ckpt_digest(ck._step_dir(2)) == digest2,
                f"repair_node: one launch per tile, pair bit-exact: {row}")
        row["bytes_read"] = gamma
        # 7. a clean scrub: every pair re-derived, one launch per tile
        rep, row = step("scrub_clean", lambda: ck.scrub(2),
                        nbytes=2 * nbytes)
        require(rep.clean and row["launches"]["gf_matmul"] == tiles,
                f"clean scrub, one batched launch per tile: {row}")
        # 8. one corrupted byte in node 11's data block: the scrub flags
        # that node and exactly the nodes whose regeneration reads it
        victim = 11
        a_path = ck._node_files(2, victim)[0]
        raw = bytearray(a_path.read_bytes())
        raw[-1] ^= 0xFF
        a_path.write_bytes(bytes(raw))
        expect = {victim} | {i for i in range(1, n + 1)
                             if victim - 1 in ck.code.repair_plan(i)
                             .data_indices}
        rep, row = step("scrub_corrupt_node11", lambda: ck.scrub(2),
                        nbytes=2 * nbytes)
        require(set(rep.mismatched_nodes) == expect,
                f"scrub flags node {victim} and the nodes reading its block "
                f"{sorted(expect)}: {rep.mismatched_nodes}")
        row["mismatched_nodes"] = list(rep.mismatched_nodes)
        ck.repair_node(2, victim)
        require(ck.scrub(2).clean and ckpt_digest(ck._step_dir(2))
                == digest2, "node 11 repaired, scrub clean again")
        # profiled repeats: a save and the reconstruct
        profiled("save", lambda: ck.save(3, before))
        profiled("restore_reconstruct",
                 lambda: ck.restore(before, 3, failed_nodes=[2, 9, 14]))
        ck.close()
        require(digest1 != digest2, "steps 1 and 2 hold different states")
        # 9. store-backed: leaf groups as objects, one node failed
        store = CodedObjectStore(spec, n_nodes=STORE_NODES,
                                 stripe_symbols=STORE_STRIPE)
        sck = MSRCheckpointer(None, store=store)

        def store_round():
            sck.save(1, before)
            store.fail_node(3)
            return sck.restore(before, 1)

        (got, rep), row = step("store_backed_node3", store_round)
        require(rep.path == "store" and equal(got, before),
                "store-backed restore with node 3 failed bit-exact")
        require(row["launches"]["circulant_encode"] > 0
                and row["launches"]["gf_matmul"] > 0,
                f"store-backed save encodes, degraded restore decodes: {row}")
        row["bytes_read"] = rep.bytes_read
        del got
        store.close()
        # the known answer, saved from card tensors
        ka_state = ckpt_known_state(np)
        ka_tree = {g: {k: torch.from_numpy(v).cuda() for k, v in d.items()}
                   for g, d in ka_state.items()}
        digest = ckpt_rehearsal(MSRCheckpointer, CodeSpec, root / "ka",
                                ka_tree)
        require(digest == KA_CKPT_SHA256,
                f"checkpoint known-answer digest {digest} vs the JAX "
                f"reference")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = counted(gfm, circ)
    require(all(v > 0 for v in launches.values()),
            f"both kernels ran on the checkpoint path: {launches}")
    del state, before
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps, "profiles": profiles,
            "state_bytes": nbytes, "symbols_per_block": s_block,
            "tile_symbols": geo["tile"], "tiles": tiles,
            "known_answer_sha256": digest}


def phase_serve(torch, np, gfm, circ, serve_mib: int) -> dict:
    """The read front end before a fresh [16, 8] store on 20 nodes, on
    the card: serve_mib MiB in 16 objects, node 3 failed and not yet
    drained, node 7 slowed by a read-latency fault (hedges fire), one
    stored share rotted (the CRC catch quarantines its node); 64 reads
    over 4 priorities into a queue of 48 (16 shed), pump, tick until the
    repairs drain, scrub the quarantined.  Kernel counts set to 0 just
    before and read just after."""
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.io import FaultInjector, fast_retry
    from repro_torch.serve import Overloaded, ReadFrontEnd
    from repro_torch.store import CodedObjectStore, RepairScheduler
    objects, reads, max_queue, slow, rot_node = 16, 64, 48, 7, 12
    obj_bytes = (serve_mib << 20) // objects
    rng = np.random.default_rng(1)
    objs = {f"s{i:02d}": rng.integers(0, 256, size=obj_bytes,
                                      dtype=np.uint8).tobytes()
            for i in range(objects)}
    order = [(f"s{int(rng.integers(0, objects)):02d}", int(rng.integers(0, 4)))
             for _ in range(reads)]
    faults = FaultInjector(seed=0)
    store = CodedObjectStore(CodeSpec.make(K, P), n_nodes=STORE_NODES,
                             stripe_symbols=STORE_STRIPE, faults=faults,
                             retry=fast_retry())
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    gfm.launches = 0
    circ.launches = 0
    t0 = time.perf_counter()
    for key, v in objs.items():
        store.put(key, v)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    store.fail_node(3)
    faults.add(op="read", kind="latency", match=f"node:{slow:02d}",
               latency_s=0.05)
    # rot one stored share of a key read at the top priority (never shed)
    rot_key = next(k for k, pri in order if pri == 3)
    rot_t = next(t for t in range(store.stat(rot_key).n_stripes)
                 if rot_node in store.placement_of(rot_key, t))
    store._shares[rot_node - 1][(rot_key, rot_t)][1][0] ^= 0x55
    fe = ReadFrontEnd(store, scheduler=sched, max_queue=max_queue,
                      default_deadline_s=60.0, hedge_after_s=0.02,
                      quarantine_threshold=2.0)
    try:
        tks = [fe.submit(key, priority=pri) for key, pri in order]
        n0 = counted(gfm, circ)
        t0 = time.perf_counter()
        fe.pump()
        torch.cuda.synchronize()
        pump_s = time.perf_counter() - t0
        pump_launches = launched(gfm, circ, n0)
        served = [tk for tk in tks if tk.error is None]
        shed = [tk for tk in tks if tk.error is not None]
        corrupt = sum(tk.obj != objs[tk.key] for tk in served)
        require(corrupt == 0, f"{corrupt} corrupt payloads served")
        require(all(isinstance(tk.error, Overloaded) for tk in shed)
                and len(shed) == reads - max_queue and len(served) ==
                max_queue, f"shed {len(shed)} of {reads}, all Overloaded")
        m = fe.metrics.summary()
        require(pump_launches == {"gf_matmul": m["decode_dispatches"],
                                  "circulant_encode": 0}
                and m["decode_dispatches"] > 0,
                f"one gf_matmul launch per failure pattern: {pump_launches}"
                f" vs {m['decode_dispatches']}")
        require(m["hedged_fetches"] > 0 and m["crc_rejected"] >= 1
                and rot_node in fe.quarantined_nodes(),
                f"hedges fired and the rotten node is quarantined: {m}")
        faults.clear()                       # the slow node recovers
        n0 = counted(gfm, circ)
        t0 = time.perf_counter()
        ticks = 0
        while sched.pending():
            fe.tick()
            ticks += 1
            require(ticks < 1000, "repair drain stalls")
        scrubs = fe.scrub_quarantined()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        drain_launches = launched(gfm, circ, n0)
        require(store.verify() and store.total_lost_shares() == 0,
                "every stripe re-protected")
        served_bytes = sum(len(tk.obj) for tk in served)
        lat = m["latency"]
        events = [e["what"] for e in fe.events]
    finally:
        fe.close()
        store.close()
    launches = counted(gfm, circ)
    require(all(v > 0 for v in launches.values()),
            f"both kernels ran on the serve path: {launches}")
    return {"launches": launches, "objects": objects, "object_bytes":
            obj_bytes, "put_ms": put_s * 1e3, "pump_ms": pump_s * 1e3,
            "served": len(served), "shed": len(shed),
            "served_MBps": served_bytes / pump_s / 1e6,
            "p50_ms": lat["p50_s"] * 1e3, "p99_ms": lat["p99_s"] * 1e3,
            "pump_launches": pump_launches, "summary": m,
            "drain_ticks": ticks, "drain_ms": drain_s * 1e3,
            "drain_launches": drain_launches, "scrubs": scrubs,
            "events": events}


def phase_cluster(torch, np, gfm, circ, block_symbols: int) -> dict:
    """The standard scenarios on a ClusterSimulator at [16, 8] over
    GF(257) with block_symbols symbols per block (2^22: 256 MiB of int32
    data), then a CodedReadServer round trip of a card-tensor tree with 3
    nodes down.  Kernel counts set to 0 just before and read just
    after."""
    from repro_torch.cluster import ClusterSimulator, events
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.serve.engine import CodedReadServer
    spec = CodeSpec.make(K, P)
    gen = torch.Generator(device="cuda").manual_seed(3)
    data = torch.randint(0, P, (spec.n, block_symbols), generator=gen,
                         dtype=torch.int32, device="cuda")
    gfm.launches = 0
    circ.launches = 0
    reports = []
    for sc in events.standard_scenarios(spec.n, K):
        torch.cuda.synchronize()
        n0 = counted(gfm, circ)
        t0 = time.perf_counter()
        sim = ClusterSimulator(spec, data)
        rep = sim.run(sc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(sim.node_a.device.type == "cuda" and rep.bit_exact,
                f"scenario {sc.name} bit-exact on the card")
        reports.append({"report": rep.to_json(), "wall_ms": dt * 1e3,
                        "launches": launched(gfm, circ, n0)})
        del sim
    gen = torch.Generator(device="cuda").manual_seed(4)
    tree = {"w": torch.randn((1 << 20, 16), generator=gen, device="cuda"),
            "emb": torch.randn((4096, 512), generator=gen,
                               device="cuda").to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int64, device="cuda")}
    n0 = counted(gfm, circ)
    t0 = time.perf_counter()
    srv = CodedReadServer.for_pytree(tree, spec)
    for victim in (2, 9, 14):
        srv.sim.fail_node(victim)
    got = srv.read_state()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(list(got) == ["emb", "step", "w"] and all(
        got[k].device.type == "cuda" and got[k].dtype == tree[k].dtype
        and torch.equal(got[k], tree[k]) for k in tree),
        "CodedReadServer tree round trip with 3 nodes down")
    require(srv.metrics.reads_degraded == 3 and srv.sim.repair_now(),
            "three blocks decoded, then repaired")
    server = {"wall_ms": dt * 1e3, "launches": launched(gfm, circ, n0),
              "reads": srv.metrics.summary()["reads"]}
    del srv, got, data
    torch.cuda.empty_cache()
    launches = counted(gfm, circ)
    require(all(v > 0 for v in launches.values()),
            f"both kernels ran on the cluster path: {launches}")
    return {"launches": launches, "block_symbols": block_symbols,
            "scenarios": reports, "coded_read_server": server}


def phase_drills(torch, gfm, circ) -> dict:
    """Every crash-consistency drill of the port on the card, at the
    reference's own sizes ([6, 3] over GF(257)).  Kernel counts set to 0
    just before and read just after."""
    from repro_torch.cluster import run_drills
    gfm.launches = 0
    circ.launches = 0
    t0 = time.perf_counter()
    results = run_drills()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in results:
        require(r.passed and r.bit_exact and r.orphans == 0,
                f"drill {r.name}: {r.detail}")
    launches = counted(gfm, circ)
    require(all(v > 0 for v in launches.values()),
            f"both kernels ran in the drills: {launches}")
    return {"launches": launches, "seconds": dt,
            "drills": [r.to_json() for r in results]}


# ---------------------------------------------------------------- shard path
SHARD_MESHES = (1, 2, 4, 8)         # shards over [cuda:0] * m
SHARD_STORE_MESH = 4                # use_mesh of the store and checkpoint
RING_MEAN_N = 4                     # int8_ring_mean's ring
RING_MEAN_ROW = (151936, 2560)      # qwen3-4b's largest leaf, the embedding
RING_MEAN_BOUND = 10                # x the int8 scale: the reference test's


def ring_mean_plain(torch, quantize, dequantize, x):
    """int8_ring_mean's algebra as one plain loop over hops on one device:
    the reduce-scatter re-quantized each hop (j -> j+1), then the int8
    all-gather; returns the gathered mean (one row)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    size = flat.shape[1]
    pad = (-size) % n
    chunks = [torch.nn.functional.pad(flat[i], (0, pad)).view(n, -1)
              for i in range(n)]
    accs = [chunks[i][i] for i in range(n)]
    for t in range(n - 1):
        wire = [quantize(a) for a in accs]
        accs = [dequantize(*wire[(i - 1) % n]) + chunks[i][(i - t - 1) % n]
                for i in range(n)]
    done = [quantize(a / torch.full((), n, device=a.device)) for a in accs]
    order = [(c - 1) % n for c in range(n)]
    q = torch.stack([done[j][0] for j in order])
    sc = torch.stack([done[j][1] for j in order])
    return dequantize(q, sc[:, None]).reshape(-1)[:size].view(x.shape[1:])


def shard_at_scale(torch, np, gfm, circ, mesh, store_mib: int,
                   ckpt_mib: int) -> dict:
    """The store phase's workload (its objects, nodes and stripe size) and
    the checkpoint phase's state at full size, on an unsharded twin and
    under ``mesh``, each step run on both sides back to back, the side
    that goes first alternating from step to step: put, put again, the
    rack-0 degraded get and its drain; save, the node-5 regenerate and the
    2/9/14 reconstruct restores.  The sharded side launches m times the
    unsharded side's kernels (asserted), both read back bit-exact, and
    the two saves' step directories are equal."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import MSRCheckpointer
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.sharding.mesh import use_mesh
    from repro_torch.store import CodedObjectStore, RepairScheduler
    spec = CodeSpec.make(K, P)
    m = mesh.size
    rows: dict = {"store": {}, "checkpoint": {}}

    def timed(fn):
        torch.cuda.synchronize()
        n0 = counted(gfm, circ)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, launched(gfm, circ, n0)

    def pair(group, name, mesh_first: bool, fn):
        """``fn(side)`` on both sides, in the order given; the sharded
        side must launch m times what the unsharded side does."""
        order = ("mesh", "unsharded") if mesh_first else \
            ("unsharded", "mesh")
        res, ms, n = {}, {}, {}
        for side in order:
            res[side], ms[side], n[side] = timed(lambda: fn(side))
        require(n["mesh"] == {k: m * v for k, v in n["unsharded"].items()}
                and sum(n["unsharded"].values()) > 0,
                f"{group} {name}: {m} launches under the mesh for each "
                f"unsharded one: {n}")
        rows[group][name] = {"unsharded_ms": ms["unsharded"],
                             "mesh_ms": ms["mesh"],
                             "ratio": ms["mesh"] / ms["unsharded"],
                             "first": order[0],
                             "launches_unsharded": n["unsharded"]}
        return res

    _, objs = store_objects(np, store_mib)
    stores, scheds = {}, {}
    for side, msh in (("unsharded", None), ("mesh", mesh)):
        with use_mesh(msh):
            st = stores[side] = CodedObjectStore(
                spec, n_nodes=STORE_NODES, stripe_symbols=STORE_STRIPE)
        require(st.code.mesh is msh and st.code.backend_name == "cuda",
                f"the {side} store's code on the card")
        scheds[side] = RepairScheduler(st)
        st.subscribe(scheds[side].on_event)

    def put_all(side):
        for k, v in objs.items():
            stores[side].put(k, v)

    def read_back(side):
        return all(stores[side].get(k) == v for k, v in objs.items())

    pair("store", "put", True, put_all)
    pair("store", "put_again", False, put_all)
    rack0 = list(stores["mesh"].layout.nodes_in(0))
    for st in stores.values():
        for v in rack0:
            st.fail_node(v)
    ok = pair("store", "degraded_get_rack0", True, read_back)
    require(all(ok.values()), "degraded gets bit-exact on both sides")
    for st in stores.values():
        for v in rack0:
            st.replace_node(v)
    reps = pair("store", "drain_rack0", False,
                lambda side: scheds[side].drain_all())
    require(reps["mesh"].decode_calls == reps["unsharded"].decode_calls > 0,
            f"both drains decode alike: {reps}")
    require(read_back("mesh"), "objects bit-exact after the sharded drain")
    for st in stores.values():
        st.close()
    del objs, stores, scheds

    geo = ckpt_geometry(ckpt_mib)
    state = ckpt_state(torch, geo)
    root = Path(tempfile.mkdtemp(prefix="msr_shard_ckpt_"))
    try:
        cks = {"unsharded": MSRCheckpointer(root / "unsharded", spec),
               "mesh": MSRCheckpointer(root / "mesh", spec, mesh=mesh)}
        require(cks["mesh"].code.mesh is mesh
                and cks["mesh"].device.type == "cuda",
                "the checkpointer's code is sharded over the mesh")
        pair("checkpoint", "save", True, lambda side: cks[side].save(1, state))
        require(ckpt_digest(cks["mesh"]._step_dir(1))
                == ckpt_digest(cks["unsharded"]._step_dir(1)),
                "the sharded save writes the unsharded save's step files")
        for name, failed, path, mesh_first in (
                ("restore_regenerate_node5", [5], "regenerate", False),
                ("restore_reconstruct_2_9_14", [2, 9, 14], "reconstruct",
                 True)):
            for ck in cks.values():
                for f in failed:
                    for file in ck._node_files(1, f):
                        file.unlink()
            got = pair("checkpoint", name, mesh_first,
                       lambda side: cks[side].restore(
                           state, 1, failed_nodes=failed))
            require(all(rep.path == path and all(
                torch.equal(a, b) for a, b in zip(ckpt_leaves(tree),
                                                  ckpt_leaves(state)))
                for tree, rep in got.values()),
                f"{path} restores bit-exact on both sides")
            del got
        for ck in cks.values():
            ck.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    return rows


def phase_shard(torch, np, gfm, circ, plan_mod, s: int, store_mib: int,
                ckpt_mib: int) -> dict:
    """The stream-axis mesh on the card, kernel counts set to 0 just
    before and read just after: the planner's four main-path ops at S
    symbols per block over meshes of SHARD_MESHES shards on one card (and
    over the distinct cards where the host has several), each bit-equal
    to the unsharded planner with one launch per shard; the store and
    checkpoint known answers under a mesh of SHARD_STORE_MESH; the ring
    encode over 16 nodes on both wires against circulant_encode, k
    blocks a link; int8_ring_mean over RING_MEAN_N rows of RING_MEAN_ROW
    against its plain composition and the true mean; the store and
    checkpoint phases' workloads at full size under that mesh beside
    unsharded twins (:func:`shard_at_scale`)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.msr_checkpoint import MSRCheckpointer
    from repro_torch.codes import CodeClass
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.core.repair import build_repair_matrix
    from repro_torch.core.ring import LinkTraffic, ring_encode
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_host_mesh, make_storage_mesh
    from repro_torch.optim.compression import (dequantize, int8_ring_mean,
                                               quantize)
    from repro_torch.sharding.mesh import StreamMesh, use_mesh
    from repro_torch.store import CodedObjectStore, RepairScheduler
    spec = CodeSpec.make(K, P)
    n = spec.n
    dev0 = torch.device("cuda", torch.cuda.current_device())
    be = dispatch.get("cuda")
    gfm.launches = 0
    circ.launches = 0
    plain = plan_mod.get_planner(be, P)
    require(plan_mod.get_planner(be, P, mesh=1) is plain,
            "get_planner(mesh=1) is the unsharded planner")
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(shape, hi=P):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32,
                             device="cuda")

    rmat = build_repair_matrix(spec)
    data = rnd((n, s))
    x = {"data": data, "mat": rnd((n, n)), "rp": data[n - 1],
         "nd": data[:K], "rps": data[K:K + 4], "nds": rnd((4, K, s))}
    ops = {"circulant_encode": (circ, lambda pl: pl.circulant_encode(
               x["data"], spec.c)),
           "decode": (gfm, lambda pl: pl.matmul(x["mat"], x["data"])),
           "regenerate": (gfm, lambda pl: pl.regenerate(rmat, x["rp"],
                                                        x["nd"])),
           "regenerate_batch": (gfm, lambda pl: pl.regenerate_batch(
               rmat, x["rps"], x["nds"]))}
    meshes = [(m, StreamMesh(m, devices=[dev0] * m)) for m in SHARD_MESHES]
    cards = torch.cuda.device_count()
    if cards > 1:
        meshes.append((f"{cards} cards", StreamMesh(cards)))
    rows = []
    for name, (kern, op) in ops.items():
        want = op(plain).device()
        for label, mesh in meshes:
            pl = plan_mod.get_planner(be, P, mesh=mesh)
            require((pl is plain) == (mesh.size == 1),
                    f"mesh {label}: its own planner, 1 shard the plain one")
            op(pl).device()                      # warm: plan key, buffers
            walls, devs = [], []
            for _ in range(3):
                n0 = kern.launches
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                got = op(pl).device()
                e1.record()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                devs.append(e0.elapsed_time(e1))
                require(kern.launches - n0 == mesh.size,
                        f"{name} over mesh {label}: {kern.launches - n0} "
                        f"launches, one per shard ({mesh.size})")
            require(torch.equal(got, want),
                    f"{name} over mesh {label} bit-equal to unsharded")
            rows.append({"op": name, "mesh": label, "shards": mesh.size,
                         "wall_ms": statistics.median(walls),
                         "device_ms": statistics.median(devs)})
            del got
        del want
    del x, data
    torch.cuda.empty_cache()

    # store and checkpoint known answers, unsharded and under a mesh: a
    # correctness check at the reference's size (timed at full size in
    # shard_at_scale)
    mesh4 = StreamMesh(SHARD_STORE_MESH, devices=[dev0] * SHARD_STORE_MESH)
    known = {}
    for label, mesh in (("unsharded", None), ("mesh", mesh4)):
        with use_mesh(mesh):
            digest = store_rehearsal(CodeSpec, CodedObjectStore,
                                     RepairScheduler, CodeClass)
        known[f"store_{label}"] = digest
        require(digest == KA_STORE_SHA256,
                f"store known answer {label}: {digest} vs the JAX reference")
    ka_tree = {g: {k: torch.from_numpy(v).cuda() for k, v in d.items()}
               for g, d in ckpt_known_state(np).items()}
    root = Path(tempfile.mkdtemp(prefix="msr_shard_"))
    try:
        for label, mesh in (("unsharded", None), ("mesh", mesh4)):
            digest = ckpt_rehearsal(MSRCheckpointer, CodeSpec, root / label,
                                    ka_tree, mesh=mesh)
            known[f"ckpt_{label}"] = digest
            require(digest == KA_CKPT_SHA256,
                    f"checkpoint known answer {label}: {digest} vs the JAX "
                    f"reference")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the ring encode over 16 nodes on one card
    ring = {}
    data = rnd((n, s), 256)                      # raw bytes: byte wire valid
    want = circ(data, spec.c, P)
    ring["circulant_encode_ms"] = time_ms(lambda: circ(data, spec.c, P), 5)
    mesh16 = make_storage_mesh(n, devices=[dev0] * n)
    for wire, byte_wire in (("int32", False), ("uint8", True)):
        traffic = LinkTraffic()
        got = ring_encode(data, spec, mesh16, byte_wire=byte_wire,
                          traffic=traffic)
        require(torch.equal(got, want),
                f"ring_encode ({wire} wire) equals circulant_encode")
        require(set(traffic.blocks.values()) == {K}
                and len(traffic.blocks) == n,
                f"{K} blocks on each of the {n} links: {traffic.blocks}")
        per_symbol = 1 if byte_wire else 4
        require(set(traffic.bytes.values()) == {K * s * per_symbol},
                f"{per_symbol} B a symbol on the {wire} wire")
        del got
        ring[f"{wire}_ms"] = time_ms(lambda: ring_encode(
            data, spec, mesh16, byte_wire=byte_wire), 3, warmup=1)
        ring[f"{wire}_link_bytes"] = K * s * per_symbol
    del data, want
    torch.cuda.empty_cache()

    # int8_ring_mean over qwen3-4b's embedding, one row a device
    g = torch.Generator(device="cuda").manual_seed(11)
    rows_x = torch.randn((RING_MEAN_N,) + RING_MEAN_ROW, generator=g,
                         device="cuda")
    mesh_n = make_host_mesh(devices=[dev0] * RING_MEAN_N)
    t0 = time.perf_counter()
    got = int8_ring_mean(rows_x, mesh_n, "data")
    torch.cuda.synchronize()
    mean_wall = (time.perf_counter() - t0) * 1e3
    want = ring_mean_plain(torch, quantize, dequantize, rows_x)
    diff = max(float((got[i] - want).abs().max()) for i in range(RING_MEAN_N))
    require(diff == 0.0, f"int8_ring_mean vs its plain composition: max "
            f"|diff| {diff} (tolerance 0: the same float32 ops in order)")
    del want
    scale = float(rows_x.abs().max()) / 127.0
    err = float((got[0] - rows_x.mean(0)).abs().max())
    require(err <= RING_MEAN_BOUND * scale,
            f"int8_ring_mean within {RING_MEAN_BOUND} x scale of the true "
            f"mean: {err} vs {RING_MEAN_BOUND * scale}")
    ring_mean = {"n": RING_MEAN_N, "row": list(RING_MEAN_ROW),
                 "wall_ms": mean_wall,
                 "ms": time_ms(lambda: int8_ring_mean(rows_x, mesh_n, "data"),
                               3, warmup=1),
                 "max_abs_diff_vs_plain": diff, "err_vs_true_mean": err,
                 "bound": RING_MEAN_BOUND * scale}
    del got, rows_x
    torch.cuda.empty_cache()
    scale = shard_at_scale(torch, np, gfm, circ, mesh4, store_mib, ckpt_mib)
    launches = counted(gfm, circ)
    require(all(v > 0 for v in launches.values()),
            f"both kernels ran on the shard path: {launches}")
    return {"launches": launches, "symbols_per_block": s, "cards": cards,
            "planner": rows, "known_answers": known, "ring": ring,
            "int8_ring_mean": ring_mean, "mesh": SHARD_STORE_MESH,
            "at_scale": scale}


MODEL_ARCH = "qwen3-4b"     # serve_demo.py's default arch, at full width
MODEL_LAYERS = 2            # of 36: the depth cut; no width is cut
MODEL_PARAM_BYTES = 3_919_106_048   # the float32 tree at 2 layers
MODEL_BATCH, MODEL_PROMPT, MODEL_NEW = 4, 2048, 32
MODEL_MAX_LEN = MODEL_PROMPT + MODEL_NEW
# card vs CPU logits: both are torch, rounding after each bf16 op; the
# card's and the CPU's matmuls sum in different orders, so a bf16 output
# may land one step apart and the step carries through the layers — four
# bf16 steps at magnitude 4, as KA_MODEL_ATOL
MODEL_CPU_ATOL = 0.125
DEMO_K = 4                  # serve_demo.py's default --k: [8, 4]
DEMO_N = 2 * DEMO_K


def model_config(dataclasses, get_config):
    return dataclasses.replace(get_config(MODEL_ARCH), n_layers=MODEL_LAYERS)


def model_store_shapes(n_stripes: int) -> tuple[list, list]:
    """circulant_encode's (what, s) and gf_matmul's (what, a, sources) on
    the model path: the parameter object's put windows (full and the
    ragged tail) and, with one node lost, a degraded get's decode of one
    lost row over one failure pattern's staged downloads (about one
    stripe in STORE_NODES, each pattern a group)."""
    s, n = STORE_STRIPE, 2 * K
    tail = n_stripes % STORE_PUT_TILE or STORE_PUT_TILE
    g = -(-n_stripes // STORE_NODES)
    return ([("model put window", STORE_PUT_TILE * s),
             ("model put tail", tail * s)],
            [("model degraded get", (1, n), ((n, g * s),))])


def demo_shapes(s: int, k: int) -> list:
    """gf_matmul's operands of serve_demo.py's CodedReadServer at [2k, k]
    with s symbols per block: the degraded read of 1..n-k lost rows over
    (data, redundancy) row sources and the repair of the n-k lost nodes."""
    n = 2 * k
    return ([("demo decode", (m, n), ((k, s), (k, s)))
             for m in range(1, n - k + 1)]
            + [("demo multi-loss repair", (n + n - k, n), ((k, s), (k, s)))])


def model_param_bytes(torch, cfg) -> int:
    """Bytes of ``cfg``'s parameter tree, from its shapes (built on the
    meta device, nothing allocated)."""
    from repro_torch.core.placement import tree_flatten
    from repro_torch.models import Model
    params = Model(cfg).init(torch.Generator(), device="meta")
    return sum(x.numel() * x.element_size()
               for x in tree_flatten(params)[0])


def phase_model(torch, np, gfm, circ, keep: dict) -> dict:
    """qwen3-4b at full width (2 of 36 layers) served from its parameters
    in the coded object store, then card logits against the CPU path and
    the reference's known answer, then serve_demo.py's rack kill.  Kernel
    counts set to 0 just before and read just after."""
    import dataclasses
    import resource
    from repro_torch.cluster.events import default_layout
    from repro_torch.configs import get_config
    from repro_torch.core import placement
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.models import Model, numpy_params, params_from_numpy
    from repro_torch.models import attention as attn_mod
    from repro_torch.serve.engine import (CodedReadServer, Request,
                                          ServingEngine)
    from repro_torch.store import CodedObjectStore, RepairScheduler

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def leaves_equal(a, b) -> bool:
        la, ta = placement.tree_flatten(a)
        lb, tb = placement.tree_flatten(b)
        return ta == tb and all(x.dtype == y.dtype and x.device == y.device
                                and torch.equal(x, y)
                                for x, y in zip(la, lb))

    flash_calls = []
    real_flash = attn_mod.flash_attention

    def counting_flash(*a, **kw):
        flash_calls.append(list(a[0].shape))
        return real_flash(*a, **kw)

    cfg = model_config(dataclasses, get_config)
    model = Model(cfg)
    times = {"prefill_s": [], "decode_s": []}

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            times[key].append(sync_s(t0))
            return out
        return run

    model.prefill = timed(model.prefill, "prefill_s")
    model.decode_step = timed(model.decode_step, "decode_s")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (MODEL_BATCH, MODEL_PROMPT)
                           ).astype(np.int32)
    out: dict = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                            "n_kv_heads": cfg.n_kv_heads,
                            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                            "vocab_size": cfg.vocab_size},
                 "batch": MODEL_BATCH, "prompt": MODEL_PROMPT,
                 "new_tokens": MODEL_NEW, "max_len": MODEL_MAX_LEN}
    attn_mod.flash_attention = counting_flash
    store = None
    gfm.launches = 0
    circ.launches = 0
    try:
        # (a) full width, parameters in the coded store
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        out["init_ms"] = sync_s(t0) * 1e3
        leaves = placement.tree_flatten(params)[0]
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        require(nbytes == MODEL_PARAM_BYTES and all(
            x.device.type == "cuda" for x in leaves),
            f"{nbytes} B of parameters on the card, {MODEL_PARAM_BYTES} "
            f"expected")
        out["param_bytes"] = nbytes
        store = CodedObjectStore(CodeSpec.make(K, P), n_nodes=STORE_NODES,
                                 stripe_symbols=STORE_STRIPE)
        sched = RepairScheduler(store)
        store.subscribe(sched.on_event)
        steps = {}

        def step(name, fn):
            n0 = counted(gfm, circ)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn()
            dt = sync_s(t0)
            steps[name] = {"wall_ms": dt * 1e3,
                           "MBps": nbytes / dt / 1e6,
                           "launches": launched(gfm, circ, n0),
                           "peak_device_bytes":
                               torch.cuda.max_memory_allocated()}
            return res

        stat = step("put", lambda: store.put_pytree("params", params))
        out["stripes"] = stat.n_stripes
        require(steps["put"]["launches"]["circulant_encode"] > 0
                and steps["put"]["launches"]["gf_matmul"] == 0,
                f"the put encodes on the card: {steps['put']}")
        eng = step("healthy_read", lambda: ServingEngine.from_coded_store(
            model, store, key="params", batch_size=MODEL_BATCH,
            max_len=MODEL_MAX_LEN))
        require(steps["healthy_read"]["launches"] == {
            "gf_matmul": 0, "circulant_encode": 0}
            and leaves_equal(eng.params, params),
            f"healthy read: no launch, every leaf equal: "
            f"{steps['healthy_read']}")

        def serve(name):
            reqs = [Request(uid=i, prompt=prompts[i],
                            max_new_tokens=MODEL_NEW)
                    for i in range(MODEL_BATCH)]
            times["prefill_s"].clear()
            times["decode_s"].clear()
            n_flash = len(flash_calls)
            done = step(name, lambda: eng.serve(reqs, prompt_len=MODEL_PROMPT))
            require(len(flash_calls) - n_flash == cfg.n_layers,
                    f"{name}: the prefill takes the flash path in every "
                    f"layer ({len(flash_calls) - n_flash} calls)")
            row = steps[name]
            row["prefill_ms"] = times["prefill_s"][0] * 1e3
            row["decode_ms_per_token"] = (statistics.median(
                times["decode_s"]) * 1e3)
            row["tokens_per_s"] = (MODEL_BATCH * MODEL_NEW
                                   / (row["wall_ms"] / 1e3))
            del row["MBps"]
            toks = [r.out_tokens for r in done]
            require(all(len(t) == MODEL_NEW and min(t) >= 0
                        and max(t) < cfg.vocab_size for t in toks),
                    f"{name}: {MODEL_NEW} tokens in range per request")
            return toks

        healthy = serve("serve_healthy")
        # profile one short generate: device busy share, time by name
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate(prompts, 8)
            prof_s = sync_s(t0)
        out["profile_generate_8"] = busy_share(torch, prof, prof_s)
        store.fail_node(3)
        step("degraded_read",
             lambda: eng.reload_params(store, key="params"))
        require(steps["degraded_read"]["launches"]["gf_matmul"] >= 1
                and leaves_equal(eng.params, params),
                f"degraded read: gf_matmul launched, every leaf equal: "
                f"{steps['degraded_read']}")
        keep["params_node3_lost"] = eng.params
        require(serve("serve_degraded") == healthy,
                "tokens after the degraded read equal the healthy run's")
        store.replace_node(3)
        rep = step("drain", sched.drain_all)
        steps["drain"]["repaired_stripes"] = rep.repaired_stripes
        require(store.total_lost_shares() == 0
                and steps["drain"]["launches"]["gf_matmul"] >= 1,
                f"node 3 drained on the card: {steps['drain']}")
        step("read_after_drain",
             lambda: eng.reload_params(store, key="params"))
        require(steps["read_after_drain"]["launches"]["gf_matmul"] == 0
                and leaves_equal(eng.params, params),
                "read after the drain: systematic, every leaf equal")
        require(serve("serve_after_drain") == healthy,
                "tokens after the drain equal the healthy run's")
        out["steps"] = steps
        out["flash_calls"] = flash_calls[:2]
        out["tokens_healthy_first"] = healthy[0][:8]
        del eng
        store.close()
        store = None
        torch.cuda.empty_cache()

        # (b) the same weights on the CPU plain path
        cpu_params = placement.tree_flatten(params)[1].unflatten(
            [x.cpu() for x in placement.tree_flatten(params)[0]])
        prompt = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, 16)).astype(np.int32)
        max_len = 16 + 4
        t0 = time.perf_counter()
        lc, cc = model.prefill(params, {"tokens": torch.from_numpy(
            prompt).cuda()}, max_len=max_len, q_chunk=None)
        lh, ch = model.prefill(cpu_params, {"tokens": torch.from_numpy(
            prompt)}, max_len=max_len, q_chunk=None)
        errs = []
        for t in range(5):
            got, want = lc.float().cpu().numpy(), lh.numpy()
            errs.append(float(np.abs(got - want).max()))
            top2 = np.sort(want, -1)[..., -2:]
            sure = (top2[..., 1] - top2[..., 0]) > 2 * MODEL_CPU_ATOL
            require(errs[-1] <= MODEL_CPU_ATOL and np.array_equal(
                got.argmax(-1)[sure], want.argmax(-1)[sure]),
                f"card vs CPU logits at step {t}: max |diff| {errs[-1]} "
                f"(tolerance {MODEL_CPU_ATOL})")
            if t == 4:
                break
            tok = want[:, -1].argmax(-1)[:, None].astype(np.int32)
            lc, cc = model.decode_step(params, cc, torch.from_numpy(
                tok).cuda(), 16 + t, max_len=max_len)
            lh, ch = model.decode_step(cpu_params, ch, torch.from_numpy(tok),
                                       16 + t, max_len=max_len)
        out["cpu_check"] = {"batch": 1, "prompt": 16, "decode_steps": 4,
                            "max_abs_err": max(errs), "per_step": errs,
                            "tolerance": MODEL_CPU_ATOL,
                            "seconds": time.perf_counter() - t0}
        del cpu_params, params, lc, cc, lh, ch
        torch.cuda.empty_cache()

        # (c) the reference's known answer
        ka_cfg = get_config(KA_MODEL_ARCH).reduced(**KA_MODEL_OVERRIDES)
        ka_params = params_from_numpy(numpy_params(ka_cfg, KA_MODEL_SEED))
        prompt = ka_model_prompt(np, ka_cfg.vocab_size)
        logits, _ = Model(ka_cfg).prefill(
            ka_params, {"tokens": torch.from_numpy(prompt).cuda()},
            q_chunk=None)
        got = logits[0, -1, KA_MODEL_SLICE].cpu().numpy()
        ka_err = float(np.abs(got - np.asarray(KA_MODEL_LOGITS)).max())
        require(got.shape == (len(KA_MODEL_LOGITS),)
                and ka_err <= KA_MODEL_ATOL,
                f"model known answer: max |diff| {ka_err} (tolerance "
                f"{KA_MODEL_ATOL})")
        out["known_answer"] = {"max_abs_err": ka_err,
                               "tolerance": KA_MODEL_ATOL}

        # (d) serve_demo.py's own path: a rack killed while serving
        demo_cfg = get_config(MODEL_ARCH).reduced()
        demo = Model(demo_cfg)
        demo_params = demo.init(torch.Generator(device="cuda").manual_seed(0))
        spec = CodeSpec.make(DEMO_K, P)
        layout = default_layout(spec.n, spec.k)
        n0 = counted(gfm, circ)
        t0 = time.perf_counter()
        srv = CodedReadServer.for_pytree(demo_params, spec, layout=layout)
        deng = ServingEngine.from_coded_store(demo, srv, batch_size=4,
                                              max_len=128)
        def demo_reqs():
            r = np.random.default_rng(0)
            return [Request(uid=i, prompt=r.integers(
                1, demo_cfg.vocab_size, size=6 + i).astype(np.int32),
                max_new_tokens=16) for i in range(4 * 2 + 1)]

        d_healthy = [r.out_tokens for r in deng.serve(demo_reqs(), 16)]
        victims = layout.nodes_in(0)[: spec.n - spec.k]
        for v in victims:
            srv.sim.fail_node(v)
        deng.reload_params(srv)
        require(leaves_equal(deng.params, demo_params)
                and [r.out_tokens for r in deng.serve(demo_reqs(), 16)]
                == d_healthy and srv.metrics.reads_degraded > 0,
                "serve_demo: bit-exact tokens from the survivors")
        require(srv.sim.repair_now() and torch.equal(srv.sim.node_a,
                                                     srv.sim._orig_a),
                "serve_demo: the cluster is whole after repair_now()")
        deng.reload_params(srv)
        require([r.out_tokens for r in deng.serve(demo_reqs(), 16)]
                == d_healthy, "serve_demo: tokens after repair")
        out["serve_demo"] = {
            "code": f"[{spec.n},{spec.k}] GF({P})",
            "block_symbols": srv.sim.S, "killed": list(victims),
            "wall_ms": sync_s(t0) * 1e3, "launches": launched(gfm, circ, n0),
            "reads": srv.metrics.summary()["reads"],
            "repair": srv.metrics.summary()["repair"]}
        del deng, srv, demo_params
    finally:
        attn_mod.flash_attention = real_flash
        if store is not None:
            store.close()
    out["launches"] = counted(gfm, circ)
    require(all(v > 0 for v in out["launches"].values()),
            f"both kernels ran on the model path: {out['launches']}")
    out["host_peak_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    torch.cuda.empty_cache()
    return out


# Phase families: the registry's other block kinds at their published
# widths, only depth cut.  granite-moe and whisper are served from the
# coded store (put, then read with node 3 lost); xlstm and recurrentgemma
# are drawn on the card.
FAMILIES = {
    "granite-moe-1b-a400m": {"layers": {"n_layers": 2},
                             "param_bytes": 629_440_512, "stored": True},
    "whisper-medium": {"layers": {"n_layers": 2, "encoder_layers": 2},
                       "param_bytes": 447_418_368, "stored": True},
    # one full cycle: 7 mLSTM + 1 sLSTM
    "xlstm-1.3b": {"layers": {"n_layers": 8},
                   "param_bytes": 3_090_350_304, "stored": False},
    # one cycle: rg, rg, la (window 2048: the decode wraps the ring)
    "recurrentgemma-2b": {"layers": {"n_layers": 3},
                          "param_bytes": 6_270_679_040, "stored": False},
}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 4, 2048, 32
WHISPER_PROMPT = 256        # decoder prompt over 1500 frame embeddings
FAMILY_CPU_PROMPT = 64      # card vs CPU: a 1 x 64 prompt
FAMILY_PROFILE_PROMPT = 256  # the profiled short generate's prompt
FAMILY_LOST_NODE = 3


def family_config(dataclasses, get_config, arch: str):
    return dataclasses.replace(get_config(arch), **FAMILIES[arch]["layers"])


def degraded_patterns(store, key: str, node: int) -> int:
    """Failure patterns of a degraded read of ``key`` with ``node`` lost:
    the distinct code positions the node holds among the key's stripes
    (the store decodes each pattern's stripes in one gf_matmul launch)."""
    return len({store.placement_of(key, t).index(node)
                for t in range(store.stat(key).n_stripes)
                if node in store.placement_of(key, t)})


def family_traffic(np, cfg, batch: int, prompt: int, seed: int) -> dict:
    """Seeded numpy traffic of phase families: token prompts, and for an
    encoder-decoder its frame embeddings (the stubbed frontend's output,
    0.02 times standard normals)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt)
                                  ).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = (rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def phase_families(torch, np, gfm, circ, keep: dict) -> dict:
    """The registry's other block kinds on the card at their published
    widths, depth cut (FAMILIES): granite-moe and whisper put into the
    [16, 8] store and read back with node 3 lost (one circulant_encode
    launch per put window, one gf_matmul launch per failure pattern,
    every leaf equal), xlstm and recurrentgemma drawn on the card; each
    served to 4 requests (granite, xlstm, recurrentgemma: 2048 prompt
    tokens + 32 greedy through ServingEngine; whisper: 1500 frames and a
    256-token prompt + 32 through Model.prefill / decode_step), the
    tokens from read parameters equal to those from the put ones; the
    same weights on the CPU against the card's logits (1 x 64 prompt and
    4 decode steps), the MoE's routing held on identical logits; each
    family's known answer.  The stored families' parameters read with
    node 3 lost are kept in ``keep`` (by arch) for phase
    parallel_families.  Kernel counts set to 0 just before and read just
    after."""
    import dataclasses
    import resource
    from repro_torch.configs import get_config
    from repro_torch.core import placement
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.models import Model, moe, numpy_params, params_from_numpy
    from repro_torch.serve.engine import (Request, ServingEngine,
                                          _read_coded_params)
    from repro_torch.store import CodedObjectStore

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def leaves_equal(a, b) -> bool:
        la, ta = placement.tree_flatten(a)
        lb, tb = placement.tree_flatten(b)
        return ta == tb and all(x.dtype == y.dtype and x.device == y.device
                                and torch.equal(x, y)
                                for x, y in zip(la, lb))

    def to_dev(batch, dev):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def generate(model, params, cfg, traffic, prompt: int, new: int):
        """Greedy tokens of the 4 requests: ServingEngine.generate, or
        for an encoder-decoder (the reference's engine takes token
        prompts only) Model.prefill and decode_step."""
        batch = {k: v[:, :prompt] if k == "tokens" else v
                 for k, v in traffic.items()}
        if not cfg.is_encoder_decoder:
            eng = ServingEngine(model, params, batch_size=FAMILY_BATCH,
                                max_len=prompt + new)
            return eng.generate(batch["tokens"], new).tolist()
        logits, cache = model.prefill(params, to_dev(batch, "cuda"),
                                      max_len=prompt + new, q_chunk=None)
        toks = []
        for t in range(new):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok, prompt + t,
                                              max_len=prompt + new)
        return torch.cat(toks, 1).cpu().numpy().tolist()

    def serve(model, params, cfg, traffic) -> tuple[list, dict]:
        """Greedy tokens of the 4 requests and the serving times."""
        times = {"prefill_s": [], "decode_s": []}
        real_prefill, real_decode = model.prefill, model.decode_step

        def timed(fn, key):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                times[key].append(sync_s(t0))
                return res
            return run

        model.prefill = timed(real_prefill, "prefill_s")
        model.decode_step = timed(real_decode, "decode_s")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            if cfg.is_encoder_decoder:
                out = generate(model, params, cfg, traffic, WHISPER_PROMPT,
                               FAMILY_NEW)
            else:       # through the engine's request queue
                eng = ServingEngine(model, params, batch_size=FAMILY_BATCH,
                                    max_len=FAMILY_PROMPT + FAMILY_NEW)
                reqs = [Request(uid=i, prompt=traffic["tokens"][i],
                                max_new_tokens=FAMILY_NEW)
                        for i in range(FAMILY_BATCH)]
                out = [r.out_tokens for r in
                       eng.serve(reqs, prompt_len=FAMILY_PROMPT)]
            wall = sync_s(t0)
        finally:
            model.prefill, model.decode_step = real_prefill, real_decode
        require(all(len(t) == FAMILY_NEW and min(t) >= 0
                    and max(t) < cfg.vocab_size for t in out),
                f"{cfg.name}: {FAMILY_NEW} tokens in range per request")
        return out, {
            "wall_ms": wall * 1e3,
            "prefill_ms": times["prefill_s"][0] * 1e3,
            "decode_ms_per_token": statistics.median(times["decode_s"]) * 1e3,
            "tokens_per_s": FAMILY_BATCH * FAMILY_NEW / wall,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}

    def card_vs_cpu(model, params, cfg) -> dict:
        """1 x 64 prefill + 4 decode steps on the card and on the CPU from
        the same weights; for an MoE, each top-k call's choices on both
        devices, and the routing of the CPU's logits on the card."""
        cpu_params = placement.tree_flatten(params)[1].unflatten(
            [x.cpu() for x in placement.tree_flatten(params)[0]])
        batch = family_traffic(np, cfg, 1, FAMILY_CPU_PROMPT, 2)
        calls = {"cuda": [], "cpu": []}
        real_top_k, real_route = moe.top_k, moe.route
        logits_seen = []

        def rec_top_k(probs, k):
            vals, idx = real_top_k(probs, k)
            calls[probs.device.type].append((probs.detach().cpu().numpy(),
                                             idx.cpu().numpy()))
            return vals, idx

        def rec_route(cfg_, logits, cap):
            if logits.device.type == "cpu" and not logits_seen:
                logits_seen.append((logits.clone(), cap))
            return real_route(cfg_, logits, cap)

        moe.top_k, moe.route = rec_top_k, rec_route
        t0 = time.perf_counter()
        max_len = FAMILY_CPU_PROMPT + 4
        errs, greedy_differs = [], False
        try:
            lc, cc = model.prefill(params, to_dev(batch, "cuda"),
                                   max_len=max_len, q_chunk=None)
            lh, ch = model.prefill(cpu_params, to_dev(batch, "cpu"),
                                   max_len=max_len, q_chunk=None)
            for t in range(5):
                got, want = lc.float().cpu().numpy(), lh.numpy()
                errs.append(float(np.abs(got - want).max()))
                top2 = np.sort(want, -1)[..., -2:]
                sure = (top2[..., 1] - top2[..., 0]) > 2 * MODEL_CPU_ATOL
                greedy_differs |= not np.array_equal(
                    got.argmax(-1)[sure], want.argmax(-1)[sure])
                if t == 4:
                    break
                tok = want[:, -1].argmax(-1)[:, None].astype(np.int32)
                lc, cc = model.decode_step(
                    params, cc, torch.from_numpy(tok).cuda(),
                    FAMILY_CPU_PROMPT + t, max_len=max_len)
                lh, ch = model.decode_step(
                    cpu_params, ch, torch.from_numpy(tok),
                    FAMILY_CPU_PROMPT + t, max_len=max_len)
        finally:
            moe.top_k, moe.route = real_top_k, real_route
        res = {"batch": 1, "prompt": FAMILY_CPU_PROMPT, "decode_steps": 4,
               "max_abs_err": max(errs), "per_step": errs,
               "tolerance": MODEL_CPU_ATOL, "greedy_differs": greedy_differs}
        ok = max(errs) <= MODEL_CPU_ATOL and not greedy_differs
        if cfg.n_experts:
            flips = []
            for i, ((pc, ic), (ph, ih)) in enumerate(zip(calls["cuda"],
                                                         calls["cpu"])):
                differ = (np.sort(ic, -1) != np.sort(ih, -1)).any(-1)
                for pos in zip(*np.nonzero(differ)):
                    mine = set(ic[pos].tolist()) - set(ih[pos].tolist())
                    theirs = set(ih[pos].tolist()) - set(ic[pos].tolist())
                    gap = max(abs(float(np.log(ph[pos][a]) - np.log(ph[pos][b])))
                              for a in mine for b in theirs)
                    flips.append({"call": i, "position": [int(x) for x in pos],
                                  "log_prob_gap": gap})
            logits, cap = logits_seen[0]
            on_card = moe.route(cfg, logits.cuda(), cap)
            on_cpu = moe.route(cfg, logits, cap)
            same = all(torch.equal(on_card[k].cpu(), on_cpu[k])
                       for k in ("gate_idx", "pos_in_expert", "keep"))
            require(same, f"{cfg.name}: routing of identical logits equal "
                    f"on the card and the CPU")
            res["routing"] = {"top_k_calls": len(calls["cuda"]),
                              "flips": flips[:16], "n_flips": len(flips),
                              "identical_logits_equal": same}
            # a card/CPU difference of whole-expert size is allowed only
            # where routing parted at a near-tie
            ok = ok or (flips and all(f["log_prob_gap"] <= MODEL_CPU_ATOL
                                      for f in flips))
        require(ok, f"{cfg.name}: card vs CPU logits: {res}")
        res["seconds"] = time.perf_counter() - t0
        del cpu_params
        return res

    out: dict = {"configs": {}}
    gfm.launches = 0
    circ.launches = 0
    for arch, spec in FAMILIES.items():
        t_arch = time.perf_counter()
        cfg = family_config(dataclasses, get_config, arch)
        model = Model(cfg)
        rec: dict = {"config": {
            k: getattr(cfg, k) for k in (
                "n_layers", "encoder_layers", "d_model", "n_heads",
                "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                "layer_pattern", "n_experts", "n_experts_per_token",
                "moe_dff", "rnn_width", "window_size", "encoder_seq")}}
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        rec["init_ms"] = sync_s(t0) * 1e3
        leaves = placement.tree_flatten(params)[0]
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        require(nbytes == spec["param_bytes"]
                and all(x.device.type == "cuda" for x in leaves),
                f"{arch}: {nbytes} B of parameters on the card, "
                f"{spec['param_bytes']} expected")
        rec["param_bytes"] = nbytes
        del leaves
        traffic = family_traffic(
            np, cfg, FAMILY_BATCH,
            WHISPER_PROMPT if cfg.is_encoder_decoder else FAMILY_PROMPT, 5)
        served = params
        if spec["stored"]:
            store = CodedObjectStore(CodeSpec.make(K, P), n_nodes=STORE_NODES,
                                     stripe_symbols=STORE_STRIPE)
            try:
                n0 = counted(gfm, circ)
                t0 = time.perf_counter()
                stat = store.put_pytree("params", params)
                rec["put_ms"] = sync_s(t0) * 1e3
                windows = -(-stat.n_stripes // store.put_tile_stripes)
                rec["stripes"], rec["put_windows"] = stat.n_stripes, windows
                rec["put_launches"] = launched(gfm, circ, n0)
                require(rec["put_launches"] == {"gf_matmul": 0,
                                                "circulant_encode": windows},
                        f"{arch}: one encode launch per put window: {rec}")
                store.fail_node(FAMILY_LOST_NODE)
                patterns = degraded_patterns(store, "params",
                                             FAMILY_LOST_NODE)
                n0 = counted(gfm, circ)
                t0 = time.perf_counter()
                if cfg.is_encoder_decoder:
                    served = _read_coded_params(store, "params")
                else:
                    served = ServingEngine.from_coded_store(
                        model, store, key="params", batch_size=FAMILY_BATCH,
                        max_len=FAMILY_PROMPT + FAMILY_NEW).params
                rec["degraded_read_ms"] = sync_s(t0) * 1e3
                rec["failure_patterns"] = patterns
                rec["read_launches"] = launched(gfm, circ, n0)
                require(rec["read_launches"] == {"gf_matmul": patterns,
                                                 "circulant_encode": 0}
                        and leaves_equal(served, params),
                        f"{arch}: the degraded read is one gf_matmul launch "
                        f"per failure pattern, every leaf equal: {rec}")
            finally:
                store.close()
        # the first serving run warms the card's libraries; the second is
        # the one timed (from the store-read parameters when stored)
        first, _ = serve(model, params, cfg, traffic)
        tokens, rec["serve"] = serve(model, served, cfg, traffic)
        require(tokens == first, f"{arch}: tokens from the "
                f"{'store-read' if spec['stored'] else 'same'} parameters "
                f"equal the first run's")
        rec["tokens_first"] = tokens[0][:8]
        # device time by name and busy share of a short generate: a
        # 256-token prompt and 8 new tokens
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate(model, params, cfg, traffic, FAMILY_PROFILE_PROMPT, 8)
            prof_s = sync_s(t0)
        rec["profile_generate_8"] = busy_share(torch, prof, prof_s)
        if spec["stored"]:
            keep[arch] = served
        del served
        rec["cpu_check"] = card_vs_cpu(model, params, cfg)
        del params
        torch.cuda.empty_cache()

        # the reference's known answer, reduced
        ka_cfg = get_config(arch).reduced(**KA_FAMILY_OVERRIDES.get(arch, {}))
        ka_params = params_from_numpy(numpy_params(ka_cfg, KA_MODEL_SEED))
        logits, _ = Model(ka_cfg).prefill(
            ka_params, to_dev(ka_family_batch(np, ka_cfg), "cuda"),
            q_chunk=None)
        got = logits[0, -1, KA_MODEL_SLICE].cpu().numpy()
        ka_err = float(np.abs(got - np.asarray(KA_FAMILY_LOGITS[arch])).max())
        require(got.shape == (len(KA_FAMILY_LOGITS[arch]),)
                and ka_err <= KA_MODEL_ATOL,
                f"{arch} known answer: max |diff| {ka_err} (tolerance "
                f"{KA_MODEL_ATOL})")
        rec["known_answer"] = {"max_abs_err": ka_err,
                               "tolerance": KA_MODEL_ATOL}
        rec["host_peak_rss_bytes"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
        rec["seconds"] = time.perf_counter() - t_arch
        out["configs"][arch] = rec
        del ka_params, logits
        torch.cuda.empty_cache()
    out["launches"] = counted(gfm, circ)
    require(all(v > 0 for v in out["launches"].values()),
            f"both kernels ran on the families path: {out['launches']}")
    return out


TRAIN_BATCH, TRAIN_SEQ = 2, 2048   # 2 x 2048 tokens: b*h*s^2 = 2^28, flash
TRAIN_STEPS = 4             # timed full-width steps
TRAIN_CPU_SEQ = 64          # card vs CPU: one 1 x 64-token step
TRAIN_LOSS_ATOL = 1e-2      # tests/test_torch_train.py's LOSS_ATOL
TRAIN_GRAD_RTOL = 3e-2      # and GRAD_RTOL (relative L2 per leaf)
TRAIN_FLASH_TOL = 3e-2      # and FLASH_BF16_TOL (rtol = atol, bf16 flash)
TRAIN_KV_CHUNK = 1024       # attention.attention's flash KV chunk
TRAIN_GRAD_LEAVES = (("lm_head",), ("stack", "cycles", 0, "attn", "wq"),
                     ("stack", "cycles", 0, "norm1", "scale"))
DRILL_PRESET, DRILL_K, DRILL_CRASH = "tiny", 4, 80   # train_tiny_lm defaults


def train_drill_symbols(torch) -> int:
    """Symbols per block of the crash drill's checkpoints at
    [2 * DRILL_K, DRILL_K]: the checkpointer's own layout
    (placement.pytree_to_blocks) of the tiny preset's training state,
    drawn on the CPU.  phase_train holds it against the drill's
    manifests."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement import pytree_to_blocks
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_state
    from repro_torch.train.tiny_lm import PRESETS
    cfg = get_config("paper-tiny-lm").reduced(**PRESETS[DRILL_PRESET]["model"])
    state = init_state(Model(cfg), adamw.AdamWConfig(), device="cpu")
    return pytree_to_blocks(state, 2 * DRILL_K, P)[0].shape[1]


def train_shapes(s: int) -> tuple[list, list]:
    """circulant_encode's (what, s) and gf_matmul's (what, a, sources) on
    the train path: the crash drill's save tiles and the regenerate of
    the crashed node's pair over (r_prev, next_data), at s symbols per
    block split into the checkpointer's tiles."""
    from repro_torch.checkpoint.msr_checkpoint import SAVE_TILE_SYMBOLS
    tiles = sorted({min(SAVE_TILE_SYMBOLS, s), s % SAVE_TILE_SYMBOLS or
                    min(SAVE_TILE_SYMBOLS, s)})
    return ([("train save tile", t) for t in tiles],
            [("train repair regenerate", (2, DRILL_K + 1),
              ((1, t), (DRILL_K, t))) for t in tiles])


def phase_train(torch, np, gfm, circ, n_steps: int) -> dict:
    """The training path on the card.  (a) qwen3-4b at full width, 2 of 36
    layers, float32 master parameters drawn on the card from a seed:
    ``make_train_step`` with ``AdamWConfig()`` for ``n_steps`` steps of
    2 x 2048 ``batch_at`` tokens (the attention takes the flash path,
    forward and backward, in both layers: counted), one more step
    profiled; then the flash forward and backward alone at the steps'
    shape, and one 1 x 64-token step's loss and grads through the flash
    path, on the card and on the CPU from the same inputs.  (b) train_tiny_lm.py's crash drill
    on the card: node 2 lost at step 80 of 120, its checkpoint pair
    repaired, the final state bit-exact with an uninterrupted run.
    Kernel counts set to 0 just before and read just after."""
    import dataclasses
    import math
    import tempfile
    import repro_torch.models.attention as attn_mod
    from repro_torch.configs import get_config
    from repro_torch.core.placement import tree_flatten
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import (accumulate_grads, deterministic,
                                          make_train_step)
    from repro_torch.models import Model
    from repro_torch.models.flash import FlashAttention, flash_attention
    from repro_torch.optim import adamw
    from repro_torch.train import tiny_lm

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    gfm.launches = 0
    circ.launches = 0
    cfg = dataclasses.replace(get_config(MODEL_ARCH), n_layers=MODEL_LAYERS)
    model = Model(cfg)
    opt_cfg = adamw.AdamWConfig()
    out: dict = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                            "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                            "n_kv_heads": cfg.n_kv_heads,
                            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                            "vocab_size": cfg.vocab_size,
                            "loss_chunk": cfg.loss_chunk},
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                 "optimizer": dataclasses.asdict(opt_cfg),
                 "n_microbatches": 1}
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)

    def batch(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in batch_at(dcfg, i).items()}

    with deterministic():
        # (a) full width
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        state = {"params": params, "opt": adamw.init(params, opt_cfg)}
        out["init_ms"] = sync_s(t0) * 1e3
        out["param_bytes"] = sum(x.numel() * x.element_size()
                                 for x in tree_flatten(params)[0])
        del params
        step_fn = make_train_step(model, opt_cfg)
        rows = []
        for i in range(n_steps):
            b = batch(i)
            f0, b0 = FlashAttention.forward_calls, FlashAttention.backward_calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            dt = sync_s(t0)
            row = {"step": i, "wall_ms": dt * 1e3,
                   "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "flash_forward": FlashAttention.forward_calls - f0,
                   "flash_backward": FlashAttention.backward_calls - b0,
                   "peak_device_bytes": torch.cuda.max_memory_allocated()}
            require(math.isfinite(row["loss"])
                    and math.isfinite(row["grad_norm"]),
                    f"train step {i}: finite loss and grad_norm ({row})")
            require(row["flash_forward"] == 2 * cfg.n_layers
                    and row["flash_backward"] == cfg.n_layers,
                    f"train step {i}: the flash forward twice (remat) and "
                    f"its backward once in each layer ({row})")
            rows.append(row)
        require(int(state["opt"].step) == n_steps,
                f"the optimizer counted {n_steps} steps")
        warm = [r["wall_ms"] for r in rows[1:]]
        out["steps"] = rows
        out["first_step_ms"] = rows[0]["wall_ms"]
        out["warm_step_ms"] = warm
        out["warm_step_ms_median"] = statistics.median(warm)
        out["tokens_per_s"] = (TRAIN_BATCH * TRAIN_SEQ
                               / (out["warm_step_ms_median"] / 1e3))
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        b = batch(n_steps)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            prof_s = sync_s(t0)
        require(math.isfinite(float(metrics["loss"])),
                "the profiled step's loss is finite")
        out["profile_step"] = busy_share(torch, prof, prof_s)
        del prof, b

        params = state["params"]
        del state, metrics
        torch.cuda.empty_cache()

        # the flash forward and backward alone at the timed steps' shape
        # (repeat-kv'd to 32 heads, bf16, two KV chunks), card vs CPU
        t0 = time.perf_counter()
        g = np.random.default_rng(5)
        qkv = [torch.from_numpy(g.standard_normal(
            (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.head_dim),
            dtype=np.float32)).bfloat16() for _ in range(3)]
        do = torch.from_numpy(g.standard_normal(
            qkv[0].shape, dtype=np.float32)).bfloat16()
        pos = torch.arange(TRAIN_SEQ, dtype=torch.int32).expand(
            TRAIN_BATCH, TRAIN_SEQ)
        fres = {}
        for dev in ("cuda", "cpu"):
            xs = [x.to(dev).requires_grad_() for x in qkv]
            o = flash_attention(*xs, pos.to(dev), pos.to(dev), True, None,
                                TRAIN_KV_CHUNK)
            o.backward(do.to(dev))
            fres[dev] = [t.detach().float().cpu()
                         for t in (o, *(x.grad for x in xs))]
            del xs, o
        flash_err = {}
        for name, a, b in zip(("o", "dq", "dk", "dv"), fres["cuda"],
                              fres["cpu"]):
            d = (a - b).abs()
            require(bool((d <= TRAIN_FLASH_TOL * (1 + b.abs())).all()),
                    f"flash {name} card vs CPU at ({TRAIN_BATCH}, "
                    f"{TRAIN_SEQ}, {cfg.n_heads}, {cfg.head_dim}): max "
                    f"|diff| {float(d.max())} (tolerance {TRAIN_FLASH_TOL})")
            flash_err[name] = float(d.max())
        out["flash_check"] = {
            "shape": [TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.head_dim],
            "dtype": "bfloat16", "causal": True, "kv_chunk": TRAIN_KV_CHUNK,
            "kv_chunks": TRAIN_SEQ // TRAIN_KV_CHUNK,
            "max_abs_diff": flash_err, "tolerance": TRAIN_FLASH_TOL,
            "seconds": time.perf_counter() - t0}
        del fres, qkv, do
        torch.cuda.empty_cache()

        # the same weights, one 1 x 64-token step on the card and the CPU,
        # its attention on the flash path as the timed steps' (at 64
        # tokens it would take the plain _sdpa path)
        tok = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, TRAIN_CPU_SEQ + 1)).astype(np.int32)
        small = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
                 "labels": torch.from_numpy(tok[:, 1:].copy())}
        t0 = time.perf_counter()
        res, flash_calls = {}, {}
        old_min = attn_mod.FLASH_MIN_ELEMS
        attn_mod.FLASH_MIN_ELEMS = 1
        try:
            for dev in ("cuda", "cpu"):
                leaves, tdef = tree_flatten(params)
                on = tdef.unflatten([x.to(dev) for x in leaves])
                f0 = FlashAttention.forward_calls
                b0 = FlashAttention.backward_calls
                loss, _, grads = accumulate_grads(
                    model, on, {k: v.to(dev) for k, v in small.items()})
                flash_calls[dev] = [FlashAttention.forward_calls - f0,
                                    FlashAttention.backward_calls - b0]
                res[dev] = (float(loss), [leaf(grads, pth).float().cpu()
                                          for pth in TRAIN_GRAD_LEAVES])
                del on, grads
        finally:
            attn_mod.FLASH_MIN_ELEMS = old_min
        require(all(c == [2 * cfg.n_layers, cfg.n_layers]
                    for c in flash_calls.values()),
                f"card vs CPU train step on the flash path in every layer, "
                f"forward twice (remat) and backward once: {flash_calls}")
        (lc, gc), (lh, gh) = res["cuda"], res["cpu"]
        errs = {"/".join(map(str, pth)): float((a - b).norm() / b.norm())
                for pth, a, b in zip(TRAIN_GRAD_LEAVES, gc, gh)}
        require(abs(lc - lh) <= TRAIN_LOSS_ATOL
                and all(e <= TRAIN_GRAD_RTOL for e in errs.values()),
                f"card vs CPU train step: loss {lc} vs {lh} (tolerance "
                f"{TRAIN_LOSS_ATOL}), grads rel L2 {errs} (tolerance "
                f"{TRAIN_GRAD_RTOL})")
        out["cpu_check"] = {"batch": 1, "seq": TRAIN_CPU_SEQ,
                            "attention": "flash",
                            "flash_calls": flash_calls,
                            "loss_card": lc, "loss_cpu": lh,
                            "loss_abs_err": abs(lc - lh),
                            "loss_tolerance": TRAIN_LOSS_ATOL,
                            "grad_rel_l2": errs,
                            "grad_tolerance": TRAIN_GRAD_RTOL,
                            "seconds": time.perf_counter() - t0}
        del params, gc, gh
        torch.cuda.empty_cache()

    # (b) the crash drill of train_tiny_lm.py, on the card
    n0 = counted(gfm, circ)
    args = tiny_lm.parser().parse_args(
        ["--preset", DRILL_PRESET, "--k", str(DRILL_K),
         "--crash-step", str(DRILL_CRASH)])
    with tempfile.TemporaryDirectory() as d:
        args.ckpt_dir = d
        t0 = time.perf_counter()
        drill = tiny_lm.run(args, log=lambda *_: None)
        drill_s = sync_s(t0)
        manifest_symbols = {
            json.loads(json.loads(m.read_text())["tree"])["block_symbols"]
            for m in Path(d).glob("step_*/manifest.json")}
    launches = launched(gfm, circ, n0)
    leaves = tree_flatten(drill["state"])[0]
    require(all(x.device.type == "cuda" for x in leaves),
            "the drill's state lives on the card")
    s_block = train_drill_symbols(torch)
    require(manifest_symbols == {s_block},
            f"the drill's checkpoints hold {manifest_symbols} symbols a "
            f"block; the kernels phase checked {s_block}")
    from repro_torch.checkpoint.msr_checkpoint import SAVE_TILE_SYMBOLS
    tiles = -(-s_block // SAVE_TILE_SYMBOLS)
    saves = 2 * (drill["steps"] // drill["ckpt_every"])
    require(launches["circulant_encode"] == saves * tiles
            and launches["gf_matmul"] >= 1,
            f"drill: one circulant_encode launch per save tile ({saves} "
            f"saves x {tiles} tiles) and gf_matmul at the repair: "
            f"{launches}")
    rep = drill["repairs"][0]
    out["drill"] = {
        "preset": DRILL_PRESET, "code": f"[{2 * DRILL_K},{DRILL_K}] GF({P})",
        "params": drill["n_params"], "steps": drill["steps"],
        "ckpt_every": drill["ckpt_every"], "crash_step": drill["crash_step"],
        "repair": {k: rep[k] for k in ("step", "failed", "ckpt_step",
                                       "restore_path", "repair_bytes")},
        "loss_first": drill["losses"][0], "loss_last": drill["losses"][-1],
        "bit_exact": True, "saves": saves, "tiles_per_save": tiles,
        "symbols_per_block": s_block, "launches": launches,
        "seconds": drill_s}
    del drill, leaves
    out["launches"] = counted(gfm, circ)
    torch.cuda.empty_cache()
    return out


PARALLEL_MESH = (2, 2)      # (data, model): [cuda:0] * 4, or 4 distinct cards
PARALLEL_STEPS = 3          # train steps a layout
PARALLEL_TWIN_MICRO = 2     # the unsharded twin's microbatches
PARALLEL_CODE_K = 8         # the sharded checkpoint's [16, 8] code
PARALLEL_LOST_NODE = 5      # lost at the sharded checkpoint's restore
PARALLEL_MARGIN = 0.25      # greedy tokens held where the top-2 margin is


def parallel_mesh(torch, device: str):
    """The phase's (data, model) mesh: distinct cards where the host has
    enough, else the one card repeated (a CPU rehearsal: the host)."""
    from repro_torch.launch.mesh import checked_mesh
    n = PARALLEL_MESH[0] * PARALLEL_MESH[1]
    if device == "cuda" and torch.cuda.device_count() >= n:
        devs = [torch.device("cuda", i) for i in range(n)]
    elif device == "cuda":
        devs = [torch.device("cuda", torch.cuda.current_device())] * n
    else:
        devs = [torch.device(device)] * n
    return checked_mesh(PARALLEL_MESH, ("data", "model"), devs)


def phase_parallel(torch, np, gfm, circ, serve_params,
                   device: str = "cuda") -> dict:
    """The model-parallel half of the sharding layer on the card, over a
    (data=2, model=2) mesh.  (a) qwen3-4b at full width (2 of 36 layers)
    trained by ``make_train_step`` on state laid out by the policy's
    hybrid specs (TP over model, FSDP over data), 3 steps of 2 x 2048
    ``batch_at`` tokens, against the unsharded step with 2 microbatches
    on the same inputs and initial parameters: loss per step, step-1
    grads per leaf, step ms and tokens/s, bytes moved between positions,
    bytes held per position against ``device_bytes``, the busy share of
    one more profiled step.  (b) the same under
    the dp layout (FSDP over all four positions).  (c) serving: the
    parameters phase ``model`` read with node 3 lost (``serve_params``),
    laid out by the hybrid specs, caches by ``cache_spec``;
    ``make_prefill_step`` and ``make_decode_step`` for 4 requests of 2048
    prompt + 32 new tokens against the unsharded steps.  (d) a sharded
    tiny-LM training state saved through ``MSRCheckpointer`` (files
    equal to an unsharded save's), restored with node 5 lost, re-placed
    bit-exactly, and its next step bit-equal to the step without the
    round trip.  Kernel counts set to 0 just before and read just
    after."""
    import dataclasses
    import math
    import tempfile
    from repro_torch.checkpoint.msr_checkpoint import MSRCheckpointer
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.core.placement import tree_flatten
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import (accumulate_grads, deterministic,
                                          make_decode_step,
                                          make_prefill_step,
                                          make_train_step,
                                          pick_microbatches)
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.sharding import ctx as shctx
    from repro_torch.sharding import place, policy
    from repro_torch.train.tiny_lm import PRESETS

    on_card = device == "cuda"
    mesh = parallel_mesh(torch, device)
    cards = sorted({d.index for d in mesh.devices.flat if on_card})

    def sync_s(t0):
        for i in cards:
            torch.cuda.synchronize(i)
        return time.perf_counter() - t0

    def allocated():
        return sum(torch.cuda.memory_allocated(i) for i in cards)

    def reset_peaks():
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)

    def peaks():
        return {f"cuda:{i}": torch.cuda.max_memory_allocated(i)
                for i in cards}

    def layout_state(state, mesh, layout):
        ps = policy.param_specs(state["params"], mesh, layout=layout)
        return place.place(state, policy.named(
            {"params": ps, "opt": policy.opt_specs(ps)}, mesh))

    def unique_bytes(tree):
        seen = {}
        for x in tree_flatten(tree)[0]:
            for t in (x.unique() if isinstance(x, place.Sharded) else [x]):
                seen[t.data_ptr()] = t.numel() * t.element_size()
        return sum(seen.values())

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def names_of(tree):
        return tree_flatten(policy.tree_map_with_path(
            lambda names, _: "/".join(names), tree))[0]

    def whole(tree):
        return [x.gather() if isinstance(x, place.Sharded) else x
                for x in tree_flatten(tree)[0]]

    gfm.launches = 0
    circ.launches = 0
    cfg = dataclasses.replace(get_config(MODEL_ARCH), n_layers=MODEL_LAYERS)
    model = Model(cfg)
    opt_cfg = adamw.AdamWConfig()
    shape = ShapeConfig("parallel", TRAIN_SEQ, TRAIN_BATCH, "train")
    out: dict = {"mesh": dict(mesh.shape),
                 "devices": [str(d) for d in mesh.devices.flat],
                 "config": cfg.name, "n_layers": cfg.n_layers,
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                 "choose_layout": policy.choose_layout(cfg, mesh, shape)}
    require(out["choose_layout"] == "hybrid",
            f"choose_layout picks hybrid for {cfg.name} on "
            f"{dict(mesh.shape)}: {out['choose_layout']}")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in batch_at(dcfg, i).items()}
               for i in range(PARALLEL_STEPS)]

    # (a), (b): train under each layout against the unsharded twin
    with deterministic():
        gen = (torch.Generator(device=device).manual_seed(0) if on_card
               else np.random.default_rng(0))
        params0 = model.init(gen, device=device)
        names = names_of(params0)
        twin_state = {"params": params0, "opt": adamw.init(params0, opt_cfg)}
        twin_loss, twin_metrics, twin_grads = accumulate_grads(
            model, params0, batches[0], PARALLEL_TWIN_MICRO)
        twin_grads = tree_flatten(twin_grads)[0]
        step_fn = make_train_step(model, opt_cfg, PARALLEL_TWIN_MICRO)
        twin = []
        for b in batches:
            t0 = time.perf_counter()
            twin_state, m = step_fn(twin_state, b)
            twin.append({"wall_ms": sync_s(t0) * 1e3,
                         "loss": float(m["loss"])})
        del twin_state, m
        if on_card:
            torch.cuda.empty_cache()
        layouts = {}
        for layout in ("hybrid", "dp"):
            row: dict = {"layout": layout}
            rules = policy.activation_rules(cfg, mesh, "train", layout)
            bspec = policy.batch_spec(batches[0], mesh,
                                      global_batch=TRAIN_BATCH, layout=layout)
            n_shards = int(np.prod([mesh.shape[a] for a in
                                    place._entry_axes(bspec["tokens"][0])
                                    ])) if bspec["tokens"] else 1
            n_micro = pick_microbatches(shape, n_shards)
            row.update(batch_spec=str(bspec["tokens"]),
                       batch_shards=n_shards, n_microbatches=n_micro)
            reset_peaks()
            a0 = allocated()
            state = layout_state({"params": params0,
                                  "opt": adamw.init(params0, opt_cfg)},
                                 mesh, layout)
            held = place.device_bytes(state)
            row["bytes_per_position"] = {str(k): v for k, v in held.items()}
            row["bytes_policy_total"] = sum(held.values())
            row["bytes_unique_storage"] = unique_bytes(state)
            row["bytes_allocated_by_place"] = allocated() - a0
            if on_card:
                require(abs(row["bytes_allocated_by_place"]
                            - row["bytes_unique_storage"])
                        <= 0.01 * row["bytes_unique_storage"],
                        f"{layout}: the card holds the placed state's "
                        f"distinct shards: {row}")
            sb = [place.place(b, policy.named(bspec, mesh)) for b in batches]
            with shctx.rules(mesh, rules):
                place.traffic.reset()
                loss, _, grads = accumulate_grads(model, state["params"],
                                                  sb[0], n_micro)
                row["grad_traffic"] = dataclasses.asdict(place.traffic)
                errs = {}
                for name, g, want in zip(names, tree_flatten(grads)[0],
                                         twin_grads):
                    errs[name] = rel_l2(g.gather(), want)
                del grads
                row["step1_loss"] = float(loss)
                row["step1_grad_rel_l2"] = errs
                require(abs(float(loss) - float(twin_loss))
                        <= TRAIN_LOSS_ATOL
                        and max(errs.values()) <= TRAIN_GRAD_RTOL,
                        f"{layout}: step-1 loss {float(loss)} vs "
                        f"{float(twin_loss)} (tolerance {TRAIN_LOSS_ATOL}), "
                        f"grads rel L2 max {max(errs.values())} (tolerance "
                        f"{TRAIN_GRAD_RTOL})")
                sh_step = make_train_step(model, opt_cfg, n_micro)
                rows = []
                for i, b in enumerate(sb):
                    place.traffic.reset()
                    t0 = time.perf_counter()
                    state, m = sh_step(state, b)
                    dt = sync_s(t0)
                    r = {"step": i, "wall_ms": dt * 1e3,
                         "loss": float(m["loss"]),
                         "twin_loss": twin[i]["loss"],
                         "twin_wall_ms": twin[i]["wall_ms"],
                         "traffic": dataclasses.asdict(place.traffic)}
                    require(math.isfinite(r["loss"]) and abs(
                        r["loss"] - r["twin_loss"]) <= TRAIN_LOSS_ATOL,
                        f"{layout} step {i}: loss {r['loss']} vs the "
                        f"unsharded {r['twin_loss']} (tolerance "
                        f"{TRAIN_LOSS_ATOL})")
                    rows.append(r)
                if on_card and layout == "hybrid":
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        state, m = sh_step(state, sb[0])
                        prof_s = sync_s(t0)
                    row["profile_step"] = busy_share(torch, prof, prof_s)
                    del prof
            row["steps"] = rows
            warm = statistics.median(r["wall_ms"] for r in rows[1:])
            twin_warm = statistics.median(r["wall_ms"] for r in twin[1:])
            row["warm_step_ms"] = warm
            row["twin_warm_step_ms"] = twin_warm
            row["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (warm / 1e3)
            row["twin_tokens_per_s"] = (TRAIN_BATCH * TRAIN_SEQ
                                        / (twin_warm / 1e3))
            row["peak_device_bytes"] = peaks()
            layouts[layout] = row
            del state, sb, m
            if on_card:
                torch.cuda.empty_cache()
        out["train"] = layouts
        out["twin_n_microbatches"] = PARALLEL_TWIN_MICRO
        del params0, twin_grads

        # (c) serving from the parameters read with node 3 lost
        rng = np.random.default_rng(11)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (MODEL_BATCH, MODEL_PROMPT)).astype(
                np.int32)).to(device)
        sparams = place.place(serve_params, policy.named(
            policy.param_specs(serve_params, mesh), mesh))
        prefill = make_prefill_step(model, max_len=MODEL_MAX_LEN)
        decode = make_decode_step(model, max_len=MODEL_MAX_LEN)

        def timed(fn, *a):
            t0 = time.perf_counter()
            res = fn(*a)
            return res, sync_s(t0) * 1e3

        serve = {}
        (lg, cache), ms = timed(prefill, serve_params, {"tokens": prompts})
        want = [lg.float()]
        tokens = [lg.argmax(-1).int()]
        dec_ms = []
        for t in range(MODEL_NEW - 1):
            (lg, cache), ms_t = timed(decode, serve_params, cache,
                                      tokens[-1], MODEL_PROMPT + t)
            want.append(lg.float())
            tokens.append(lg.argmax(-1).int())
            dec_ms.append(ms_t)
        serve["unsharded"] = {"prefill_ms": ms,
                              "decode_ms_per_token": statistics.median(
                                  dec_ms)}
        del cache
        batch = {"tokens": prompts}
        sbatch = place.place(batch, policy.named(policy.batch_spec(
            batch, mesh, global_batch=MODEL_BATCH), mesh))
        (lg, cache), ms = timed(prefill, sparams, sbatch)
        got = [lg.gather()]
        dec_ms = []
        for t in range(MODEL_NEW - 1):
            (lg, cache), ms_t = timed(decode, sparams, cache, tokens[t],
                                      MODEL_PROMPT + t)
            got.append(lg.gather())
            dec_ms.append(ms_t)
        serve["sharded"] = {"prefill_ms": ms,
                            "decode_ms_per_token": statistics.median(dec_ms),
                            "cache_spec": str(cache["cycles"][0]["k"].spec)}
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        top2 = [w.topk(2, dim=-1).values for w in want]
        sure = [(v[..., 0] - v[..., 1]) > PARALLEL_MARGIN for v in top2]
        flips = sum(int(((g.argmax(-1).int() != t) & s).sum())
                    for g, t, s in zip(got, tokens, sure))
        serve.update(max_abs_logit_diff=err, logit_tolerance=MODEL_CPU_ATOL,
                     tokens_checked=int(sum(int(s.sum()) for s in sure)),
                     token_flips_beyond_margin=flips,
                     margin=PARALLEL_MARGIN)
        require(err <= MODEL_CPU_ATOL and flips == 0,
                f"sharded serving vs unsharded: max |diff| {err} "
                f"(tolerance {MODEL_CPU_ATOL}), {flips} greedy tokens "
                f"apart where the top-2 margin exceeds {PARALLEL_MARGIN}")
        out["serve"] = serve
        del sparams, cache, got, want, lg
        if on_card:
            torch.cuda.empty_cache()

    # (d) a sharded training state through the MSR checkpointer
    tcfg = get_config("paper-tiny-lm").reduced(**PRESETS["tiny"]["model"])
    tmodel = Model(tcfg)
    topt = adamw.AdamWConfig(lr=1e-3)
    tparams = tmodel.init(np.random.default_rng(1), device=device)
    tdc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=64, global_batch=8,
                     seed=3)
    tb = [{k: torch.from_numpy(v).to(device)
           for k, v in batch_at(tdc, i).items()} for i in range(2)]
    bspec = policy.batch_spec(tb[0], mesh, global_batch=8)
    tb = [place.place(b, policy.named(bspec, mesh)) for b in tb]
    tstep = make_train_step(tmodel, topt)
    n0 = counted(gfm, circ)
    with deterministic(), tempfile.TemporaryDirectory() as d:
        state = layout_state({"params": tparams,
                              "opt": adamw.init(tparams, topt)},
                             mesh, "hybrid")
        state, _ = tstep(state, tb[0])
        spec = CodeSpec.make(PARALLEL_CODE_K, P)
        t0 = time.perf_counter()
        ck = MSRCheckpointer(Path(d) / "sharded", spec, device=device)
        ck.save(1, state)
        save_ms = sync_s(t0) * 1e3
        ck_whole = MSRCheckpointer(Path(d) / "whole", spec, device=device)
        ck_whole.save(1, place.gather(state))
        digests = [ckpt_digest(Path(d) / w / "step_000001")
                   for w in ("sharded", "whole")]
        require(digests[0] == digests[1],
                f"the sharded save's files equal the unsharded save's: "
                f"{digests}")
        t0 = time.perf_counter()
        restored, rep = ck.restore(state, step=1,
                                   failed_nodes=[PARALLEL_LOST_NODE])
        restore_ms = sync_s(t0) * 1e3
        replaced = layout_state(restored, mesh, "hybrid")
        require(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                    zip(whole(replaced), whole(state))),
                "the restored state re-placed equals the saved one bit "
                "for bit")
        nxt = [whole(tstep(s, tb[1])[0]) for s in (state, replaced)]
        same = all(torch.equal(a, b) for a, b in zip(*nxt))
        require(same, "the step after the round trip equals the step "
                      "without it, bit for bit")
        ck.close()
        ck_whole.close()
    ckl = launched(gfm, circ, n0)
    if on_card:
        require(ckl["circulant_encode"] >= 2 and ckl["gf_matmul"] >= 1,
                f"the sharded checkpoint encodes and repairs on the card: "
                f"{ckl}")
    out["checkpoint"] = {"config": "paper-tiny-lm tiny preset",
                         "code": f"[{2 * PARALLEL_CODE_K},{PARALLEL_CODE_K}]"
                                 f" GF({P})",
                         "files_sha256": digests[0], "save_ms": save_ms,
                         "restore_path": rep.path,
                         "lost_node": PARALLEL_LOST_NODE,
                         "restore_ms": restore_ms, "bit_exact": True,
                         "next_step_bit_equal": True, "launches": ckl}
    out["launches"] = counted(gfm, circ)
    if on_card:
        torch.cuda.empty_cache()
    return out


PF_BATCH, PF_SEQ = 4, 1024  # train: 4 x 1024 tokens a step
# the train sequence cut where the sLSTM's per-timestep loop (one pass a
# position, forward, remat and backward) would hold the phase for minutes;
# not below 512: at 256 tokens (one mLSTM chunk) the mLSTM gate biases'
# float32 grads part by 3.5% between two unsharded steps equal in exact
# arithmetic, too ill-conditioned for the float32 check (PERF.md)
PF_SEQ_CUT = {"xlstm-1.3b": 512}
PF_STEPS = 2                # timed sharded train steps a family
PF_MICRO = 2                # microbatches a step, cut from the global batch
PF_NEW = 8                  # new tokens served after the families prompt
PF_AUX_RTOL = 1e-5          # the sharded MoE aux against the unsharded
PF_FLIP_GAP = 0.125         # a routing flip is a near-tie below this gap
# xlstm at full width: two unsharded bf16 steps equal in exact arithmetic
# (1 and 2 microbatches) part by up to 45% on the mLSTM gates' grads
# (PERF.md), so its split is held in float32 compute, every leaf within
# PF_F32_RTOL; the bf16 grads are reported beside that spread
PF_FP32 = ("xlstm-1.3b",)
PF_F32_RTOL = 1e-3


class fp32_compute:
    """Weights and activations in float32 for the duration (the train
    step's bf16 casts off), as tests/test_torch_parallel_blocks.py's
    float32 test runs them."""

    def __enter__(self):
        import torch
        from repro_torch.launch import steps
        from repro_torch.models import model
        self.saved = steps._compute_copy, model.COMPUTE_DTYPE
        steps._compute_copy = lambda x: x
        model.COMPUTE_DTYPE = torch.float32

    def __exit__(self, *exc):
        from repro_torch.launch import steps
        from repro_torch.models import model
        steps._compute_copy, model.COMPUTE_DTYPE = self.saved


def quiet_params(torch, params):
    """``params`` with every attention ``wo`` and expert ``w_out`` zero:
    the blocks add nothing to the residual stream, so every layer's
    router sees the embedding bit for bit under any mesh, and a sharded
    and an unsharded MoE aux differ only by how the Switch term is
    reduced (tests/test_torch_parallel_blocks.py's C1 test)."""
    out = dict(params)
    out["stack"] = dict(params["stack"])
    out["stack"]["cycles"] = tuple(
        {**blk, "attn": {**blk["attn"], "wo": torch.zeros_like(
            blk["attn"]["wo"])}, "moe": {**blk["moe"], "w_out":
                                         torch.zeros_like(blk["moe"]["w_out"])}}
        for blk in params["stack"]["cycles"])
    return out


def record_top_k(moe, calls: list):
    """Wrap ``moe.top_k`` to record each call's (probs, choices) on the
    host; returns the original."""
    real = moe.top_k

    def top_k(probs, k):
        vals, idx = real(probs, k)
        calls.append((probs.detach().float().cpu().numpy(),
                      idx.cpu().numpy()))
        return vals, idx
    moe.top_k = top_k
    return real


def routing_flips(np, want: list, got: list) -> list:
    """Each token where a sharded top-k call (a batch shard's rows of
    one chunk) chose other experts than the unsharded call's rows nearest
    its probabilities: the log-probability gap of the swapped experts (a
    near-tie parted in one layer and the whole-expert differences it
    causes in the next layers alike)."""
    gaps = []
    for p, own in got:
        n = p.shape[0]
        rp, ridx = min(((c[0][r:r + n], c[1][r:r + n])
                        for c in want if c[0].shape[1:] == p.shape[1:]
                        for r in range(0, c[0].shape[0] - n + 1, n)),
                       key=lambda c: float(np.abs(c[0] - p).max()))
        for at in zip(*np.nonzero((np.sort(own, -1)
                                   != np.sort(ridx, -1)).any(-1))):
            mine = set(own[at].tolist()) - set(ridx[at].tolist())
            theirs = set(ridx[at].tolist()) - set(own[at].tolist())
            gaps.append(max(abs(float(np.log(rp[at][a]) - np.log(rp[at][b])))
                            for a in mine for b in theirs))
    return gaps


def phase_parallel_families(torch, np, gfm, circ, stored: dict,
                            device: str = "cuda") -> dict:
    """Every block kind split over the model axis on the card: the
    families phase's four configs (published widths, its depth cuts) on
    a (data=2, model=2) mesh under the hybrid layout.  For each: (a) 2
    train steps of 4 x 1024 tokens (whisper: 1500 frame embeddings and a
    1024-token decoder sequence; xlstm: 4 x 512, ``PF_SEQ_CUT``), 2
    microbatches cut from the global batch: step ms, tokens/s, peak
    memory, bytes gathered and reduced between positions a step, bytes
    per position; step 1's loss and grads against the unsharded step on
    the card (xlstm's grads in float32, ``PF_FP32``, beside the
    unsharded step's own spread); granite-moe's aux against the
    unsharded aux at 1 and 2 microbatches.  (b) 4 x (the
    families prompt + 8 new tokens) through the sharded prefill and
    decode steps against the unsharded steps (granite-moe and whisper on
    the parameters phase families read with node 3 lost, ``stored``;
    recurrentgemma and xlstm on ``Model.init``'s): logits, greedy tokens,
    prefill ms, decode ms a token.  (c) granite-moe's trained state,
    experts split on E over model, saved through ``MSRCheckpointer`` and
    restored with node 5 lost, bit-identical shard by shard.  Kernel
    counts set to 0 just before and read just after."""
    import dataclasses
    import math
    import tempfile
    from repro_torch.checkpoint.msr_checkpoint import MSRCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.core.placement import tree_flatten
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import (_split_micro, accumulate_grads,
                                          deterministic, make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import Model, moe
    from repro_torch.optim import adamw
    from repro_torch.sharding import ctx as shctx
    from repro_torch.sharding import place, policy

    on_card = device == "cuda"
    mesh = parallel_mesh(torch, device)
    cards = sorted({d.index for d in mesh.devices.flat if on_card})

    def sync_s(t0):
        for i in cards:
            torch.cuda.synchronize(i)
        return time.perf_counter() - t0

    def reset_peaks():
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)

    def peaks():
        return {f"cuda:{i}": torch.cuda.max_memory_allocated(i)
                for i in cards}

    def lay(tree, specs):
        return place.place(tree, policy.named(specs, mesh))

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    def names_of(tree):
        return tree_flatten(policy.tree_map_with_path(
            lambda names, _: "/".join(names), tree))[0]

    def batches_of(cfg, seq, n, seed):
        """n seeded batches of PF_BATCH rows (whisper: with frames)."""
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=PF_BATCH, seed=seed)
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_at(dcfg, i).items()}
            if cfg.is_encoder_decoder:
                b["enc_embeds"] = torch.from_numpy((rng.standard_normal(
                    (PF_BATCH, cfg.encoder_seq, cfg.d_model)) * 0.02
                    ).astype(np.float32)).to(device)
            out.append(b)
        return out

    def aux_of(model, params, batch, n_micro):
        with torch.no_grad():
            return float(sum(model.loss(params, mb, remat=False)[1]["aux"]
                             for mb in _split_micro(batch, n_micro))
                         / n_micro)

    gfm.launches = 0
    circ.launches = 0
    opt_cfg = adamw.AdamWConfig()
    out: dict = {"mesh": dict(mesh.shape),
                 "devices": [str(d) for d in mesh.devices.flat],
                 "layout": "hybrid", "train_batch": PF_BATCH,
                 "train_seq": PF_SEQ, "n_microbatches": PF_MICRO,
                 "new_tokens": PF_NEW, "reduced": {
                     arch: {"train_seq": [PF_SEQ, cut]}
                     for arch, cut in PF_SEQ_CUT.items()}, "configs": {}}
    ck_state = None
    for arch in FAMILIES:
        t_arch = time.perf_counter()
        cfg = family_config(dataclasses, get_config, arch)
        model = Model(cfg)
        rec: dict = {"n_layers": cfg.n_layers,
                     "params_source": "coded store, node 3 lost"
                     if arch in stored else "Model.init"}
        params = stored.pop(arch, None)
        if params is None:
            gen = (torch.Generator(device=device).manual_seed(0) if on_card
                   else np.random.default_rng(0))
            params = model.init(gen, device=device)
        names = names_of(params)
        pspecs = policy.param_specs(params, mesh, layout="hybrid")
        rules = policy.activation_rules(cfg, mesh, "train", "hybrid")
        seq = PF_SEQ_CUT.get(arch, PF_SEQ)
        rec["train_seq"] = seq
        batches = batches_of(cfg, seq, PF_STEPS, 0)
        bspec = policy.batch_spec(batches[0], mesh, global_batch=PF_BATCH)
        # (a) train: step 1's grads unsharded, then the sharded steps
        def step1_grads(ps, batch):
            t0 = time.perf_counter()
            loss, metrics, grads = accumulate_grads(model, ps, batch,
                                                    PF_MICRO)
            return loss, metrics, [g.gather() if isinstance(
                g, place.Sharded) else g for g in tree_flatten(grads)[0]], \
                sync_s(t0) * 1e3

        def errors(got, want):
            for name, g in zip(names, got):
                require(bool(torch.isfinite(g).all()),
                        f"{arch}: finite grad {name}")
            return {name: rel_l2(g, w) for name, g, w in zip(names, got,
                                                              want)}

        def worst(errs):
            return sorted(errs.items(), key=lambda kv: -kv[1])[:4]

        with deterministic():
            twin_loss, twin_m, twin_grads, ms = step1_grads(params,
                                                            batches[0])
            rec["unsharded_grads_ms"] = ms
            reset_peaks()
            state = lay({"params": params, "opt": adamw.init(params, opt_cfg)},
                        {"params": pspecs, "opt": policy.opt_specs(pspecs)})
            held = place.device_bytes(state)
            rec["bytes_per_position"] = {str(k): v for k, v in held.items()}
            sb = [lay(b, bspec) for b in batches]
            with shctx.rules(mesh, rules):
                place.traffic.reset()
                loss, metrics, grads, ms = step1_grads(state["params"], sb[0])
                rec["sharded_grads_ms"] = ms
                rec["grads_traffic"] = dataclasses.asdict(place.traffic)
                errs = errors(grads, twin_grads)
                del grads
                rec["step1"] = {
                    "loss": float(loss), "unsharded_loss": float(twin_loss),
                    "aux": float(metrics["aux"]),
                    "unsharded_aux": float(twin_m["aux"]),
                    "grad_rel_l2_max": max(errs.values()),
                    "grad_rel_l2_worst": worst(errs)}
                require(abs(float(loss) - float(twin_loss)) <= TRAIN_LOSS_ATOL,
                        f"{arch}: step-1 loss vs the unsharded step: "
                        f"{rec['step1']}")
                if arch in PF_FP32:
                    # the unsharded step's own bf16 spread, then the split
                    # held in float32
                    one = accumulate_grads(model, params, batches[0], 1)[2]
                    spread = errors(tree_flatten(one)[0], twin_grads)
                    del one, twin_grads
                    rec["step1"]["unsharded_1_vs_2_microbatches_worst"] = \
                        worst(spread)
                    with fp32_compute():
                        floss, _, fwant, _ = step1_grads(params, batches[0])
                        sloss, _, fgot, _ = step1_grads(state["params"], sb[0])
                        one = accumulate_grads(model, params, batches[0], 1)[2]
                    ferrs = errors(fgot, fwant)
                    fspread = errors(tree_flatten(one)[0], fwant)
                    del fgot, fwant, one
                    rec["step1_float32"] = {
                        "loss": float(sloss), "unsharded_loss": float(floss),
                        "grad_rel_l2_max": max(ferrs.values()),
                        "grad_rel_l2_worst": worst(ferrs),
                        "unsharded_1_vs_2_microbatches_worst": worst(fspread),
                        "tolerance": PF_F32_RTOL}
                    require(abs(float(sloss) - float(floss)) <= TRAIN_LOSS_ATOL
                            and max(ferrs.values()) <= PF_F32_RTOL,
                            f"{arch}: float32 step-1 vs the unsharded step: "
                            f"{rec['step1_float32']}")
                else:
                    del twin_grads
                    require(max(errs.values()) <= TRAIN_GRAD_RTOL,
                            f"{arch}: step-1 grads vs the unsharded step: "
                            f"{rec['step1']}")
                sh_step = make_train_step(model, opt_cfg, PF_MICRO)
                rows = []
                for i, b in enumerate(sb):
                    place.traffic.reset()
                    t0 = time.perf_counter()
                    state, m = sh_step(state, b)
                    dt = sync_s(t0)
                    rows.append({"step": i, "wall_ms": dt * 1e3,
                                 "tokens_per_s": PF_BATCH * seq / dt,
                                 "loss": float(m["loss"]),
                                 "traffic": dataclasses.asdict(place.traffic)})
                    require(math.isfinite(rows[-1]["loss"]),
                            f"{arch} step {i}: finite loss")
            rec["steps"] = rows
            rec["peak_device_bytes"] = peaks()
            if cfg.n_experts:       # C1: the aux over the global batch
                quiet = quiet_params(torch, params)
                squiet = lay(quiet, pspecs)
                aux = {}
                for n in (1, PF_MICRO):
                    want = aux_of(model, quiet, batches[0], n)
                    got = aux_of(model, squiet, sb[0], n)
                    aux[n] = {"sharded": got, "unsharded": want,
                              "rel": abs(got - want) / want}
                    require(aux[n]["rel"] <= PF_AUX_RTOL,
                            f"{arch}: sharded aux at {n} microbatches vs "
                            f"the unsharded: {aux[n]}")
                rec["aux_quiet_weights"] = aux
                del quiet, squiet
                ck_state = state
            del state, sb, m
            if on_card:
                torch.cuda.empty_cache()

        # (b) serve: the families prompt + 8 new tokens, sharded vs not
        prompt = WHISPER_PROMPT if cfg.is_encoder_decoder else FAMILY_PROMPT
        traffic = family_traffic(np, cfg, FAMILY_BATCH, prompt, 5)
        batch = {k: torch.from_numpy(v).to(device) for k, v in traffic.items()}
        prefill = make_prefill_step(model, max_len=prompt + PF_NEW)
        decode = make_decode_step(model, max_len=prompt + PF_NEW)
        calls = {"unsharded": [], "sharded": []}
        serve: dict = {"prompt": prompt}
        want, tokens, got = [], [], []
        for label, ps, b in (("unsharded", params, batch),
                             ("sharded", lay(params, policy.param_specs(
                                 params, mesh)), lay(batch, policy.batch_spec(
                                     batch, mesh, global_batch=FAMILY_BATCH)))):
            real = record_top_k(moe, calls[label])
            try:
                t0 = time.perf_counter()
                lg, cache = prefill(ps, b)
                prefill_ms = sync_s(t0) * 1e3
                dec = []
                for t in range(PF_NEW):
                    lg = lg.gather() if isinstance(lg, place.Sharded) else lg
                    (want if label == "unsharded" else got).append(lg.float())
                    if label == "unsharded":
                        tokens.append(lg[:, -1:].argmax(-1).int())
                    if t == PF_NEW - 1:
                        break
                    t0 = time.perf_counter()
                    lg, cache = decode(ps, cache, tokens[t], prompt + t)
                    dec.append(sync_s(t0) * 1e3)
            finally:
                moe.top_k = real
            serve[label] = {"prefill_ms": prefill_ms,
                            "decode_ms_per_token": statistics.median(dec)}
            if label == "sharded":
                serve["cache_specs"] = sorted({str(v.spec) for v in
                                               tree_flatten(cache)[0]})
                del ps
            del cache, lg
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        sure = [(lambda v: (v[..., 0] - v[..., 1]) > PARALLEL_MARGIN)(
            w[:, -1:].topk(2, dim=-1).values) for w in want]
        flips = sum(int(((g[:, -1:].argmax(-1).int() != w[:, -1:].argmax(
            -1).int()) & s).sum()) for g, w, s in zip(got, want, sure))
        serve.update(max_abs_logit_diff=err, logit_tolerance=MODEL_CPU_ATOL,
                     token_flips_beyond_margin=flips,
                     tokens_checked=int(sum(int(s.sum()) for s in sure)))
        ok = err <= MODEL_CPU_ATOL and flips == 0
        if cfg.n_experts:
            gaps = routing_flips(np, calls["unsharded"], calls["sharded"])
            serve["routing"] = {"top_k_calls": len(calls["sharded"]),
                                "differing_choices": len(gaps),
                                "near_ties": sum(g <= PF_FLIP_GAP
                                                 for g in gaps),
                                "max_log_prob_gap": max(gaps, default=0.0)}
            # a whole-expert difference only where routing parted at a
            # near-tie (phase families' rule, card vs CPU)
            ok = ok or (gaps and max(gaps) <= PF_FLIP_GAP)
        require(ok, f"{arch}: sharded serving vs unsharded: {serve}")
        rec["serve"] = serve
        del want, got, batch, calls, params
        if on_card:
            torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t_arch
        out["configs"][arch] = rec
        print(json.dumps({"parallel_families": arch, **rec}, default=str),
              file=sys.stderr, flush=True)

    # (c) granite-moe's trained state through the checkpointer
    require(ck_state is not None, "an MoE family's state to checkpoint")
    n0 = counted(gfm, circ)
    spec = CodeSpec.make(PARALLEL_CODE_K, P)
    with tempfile.TemporaryDirectory() as d:
        ck = MSRCheckpointer(Path(d) / "pf", spec, device=device)
        try:
            t0 = time.perf_counter()
            ck.save(1, ck_state)
            save_ms = sync_s(t0) * 1e3
            t0 = time.perf_counter()
            restored, rep = ck.restore(ck_state, step=1,
                                       failed_nodes=[PARALLEL_LOST_NODE])
            restore_ms = sync_s(t0) * 1e3
        finally:
            ck.close()
    ps = policy.param_specs(restored["params"], mesh)
    back = lay(restored, {"params": ps, "opt": policy.opt_specs(ps)})
    del restored
    same = all(a.spec == b.spec and all(
        a.shards[pos].dtype == b.shards[pos].dtype
        and torch.equal(a.shards[pos], b.shards[pos]) for pos in b.shards)
        for a, b in zip(tree_flatten(back)[0], tree_flatten(ck_state)[0]))
    require(same, "the restored granite-moe state equals the saved one, "
                  "shard by shard")
    moe_w = ck_state["params"]["stack"]["cycles"][0]["moe"]["w_in"]
    ckl = launched(gfm, circ, n0)
    if on_card:
        require(ckl["circulant_encode"] >= 1 and ckl["gf_matmul"] >= 1,
                f"the sharded checkpoint encodes and repairs on the card: "
                f"{ckl}")
    out["checkpoint"] = {"config": "granite-moe-1b-a400m",
                         "experts_spec": str(moe_w.spec),
                         "state_bytes": sum(
                             math.prod(x.shape) * x.unique()[0].element_size()
                             for x in tree_flatten(ck_state)[0]),
                         "code": f"[{2 * PARALLEL_CODE_K},{PARALLEL_CODE_K}]"
                                 f" GF({P})", "lost_node": PARALLEL_LOST_NODE,
                         "restore_path": rep.path, "save_ms": save_ms,
                         "restore_ms": restore_ms,
                         "bit_exact_shard_by_shard": True, "launches": ckl}
    del ck_state, back
    out["launches"] = counted(gfm, circ)
    if on_card:
        torch.cuda.empty_cache()
    return out


# the example twins: the reference's ledger lines each must print
EXAMPLE_LINES = {
    "quickstart": ("regenerated BIT-EXACTLY in one fused matmul",
                   "decode-inverse cache: 1 hit / 1 miss"),
    "store_demo": ("[degraded]", "BIT-EXACT", "[checkpoint] store-backed",
                   "scheduler repairs at-risk stripes first",
                   "[scheduler] drained", "/ 0 failed"),
    "serve_demo": ("[degraded] re-served", "BIT-EXACTLY", "[repair] rebuilt",
                   "availability=1.0"),
}
GF256_SHAPE = (16, 16, 1 << 20)     # gf256.matmul: (m, k) @ (k, n)


def phase_examples(torch, np, gfm, circ, keep: dict) -> dict:
    """The reference's three examples through their twins
    (``repro_torch.examples``) at the reference's default sizes on the
    card: quickstart (a 4 MiB file at [8, 4]: one encode, the fused
    regeneration of node 3 bit-exact, any-k reconstruction twice with one
    decode-cache hit), store_demo (6 objects of 96 KiB at [8, 4] on 12
    nodes: rack 0 lost, store-backed checkpoint restore, a node dying
    mid-drain, at-risk stripes repaired first, repair traffic below RS's,
    every get bit-exact) and serve_demo (qwen3-4b reduced served from a
    CodedReadServer at [8, 4]: tokens equal healthy, with rack 0 killed
    and after repair_now, availability 1.0).  Each asserts its invariants
    itself; here its ledger lines are checked too.  Kernel counts set to
    0 just before each example and read just after.  Then
    ``gf256.matmul`` (16, 16) @ (16, 2^20) on the card, bit-equal to the
    CPU's."""
    import contextlib
    import io
    from repro_torch.core import gf256
    from repro_torch.examples import quickstart, serve_demo, store_demo

    out: dict = {"examples": {}}
    total = {"gf_matmul": 0, "circulant_encode": 0}
    for name, mod in (("quickstart", quickstart), ("store_demo", store_demo),
                      ("serve_demo", serve_demo)):
        gfm.launches = 0
        circ.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counted(gfm, circ)
        text = buf.getvalue()
        for line in EXAMPLE_LINES[name]:
            require(line in text, f"{name} prints {line!r}")
        require(n["gf_matmul"] >= 1, f"{name} repairs or decodes on the "
                                     f"card: {n}")
        if name != "serve_demo":
            require(n["circulant_encode"] >= 1,
                    f"{name} encodes on the card: {n}")
        for k in total:
            total[k] += n[k]
        out["examples"][name] = {"seconds": wall, "launches": n,
                                 "lines": text.splitlines()}
    m, k, n_cols = GF256_SHAPE
    rng = np.random.default_rng(256)
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 256, (k, n_cols)).astype(np.int32))
    t0 = time.perf_counter()
    want = gf256.matmul(a, b)
    cpu_s = time.perf_counter() - t0
    a_c, b_c = a.cuda(), b.cuda()
    gf256.matmul(a_c, b_c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gf256.matmul(a_c, b_c)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    require(got.device.type == "cuda" and torch.equal(got.cpu(), want),
            "gf256.matmul on the card is bit-equal to the CPU's")
    out["gf256_matmul"] = {"shape": [m, k, n_cols], "bit_equal": True,
                           "card_ms": card_s * 1e3, "cpu_ms": cpu_s * 1e3}
    del a_c, b_c, got
    torch.cuda.empty_cache()
    out["launches"] = total
    return out


# the production cell the dryrun phase runs (arctic-480b x train_4k took
# more than 60 s on the host: PERF.md)
DRYRUN_CELL = ("arctic-480b", "decode_32k", False)


def phase_dryrun(torch, np, gfm, circ, keep: dict) -> dict:
    """``repro_torch.launch.dryrun`` on the host's CPU (the meta device;
    no kernel runs): the reference's reduced smoke cell (qwen3-4b reduced
    as tests/test_hlo_stats.py cuts it, 8 x 64 tokens on a (4, 2) mesh)
    with the record's invariants, then one production cell,
    ``DRYRUN_CELL`` on the 16 x 16 mesh at full depth, with its run_s.
    Kernel counts set to 0 just before and read just after (0)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    gfm.launches = 0
    circ.launches = 0
    cfg = get_config("qwen3-4b").reduced(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=256, loss_chunk=16)
    shape = ShapeConfig("train_smoke", 64, 8, "train")
    rec = dryrun.lower_cell("qwen3-4b", "train_smoke", cfg=cfg, shape=shape,
                            mesh=dryrun.meta_mesh((4, 2), ("data", "model")))
    six_nd = 6 * rec["n_active_params"] * rec["tokens_per_step"] / 8
    require(rec["mesh"] == "mesh4x2" and rec["n_devices"] == 8
            and rec["dynamic"]["collectives"]["total_bytes"] > 0
            and rec["per_position"]["flops"] > 0.5 * six_nd,
            f"the reduced dry-run cell's invariants: {rec['per_position']}")
    arch, shape_name, multi_pod = DRYRUN_CELL
    prod = dryrun.lower_cell(arch, shape_name, multi_pod=multi_pod)
    require(prod["n_params"] == 476_850_275_328
            and prod["n_active_params"] == 11_980_674_048
            and prod["n_devices"] == 256
            and prod["dynamic"]["flops"] > 0
            and prod["dynamic"]["collectives"]["total_bytes"] > 0,
            f"{arch} x {shape_name} at full depth: {prod['per_position']}")
    if prod["kind"] == "train":
        require(prod["per_position"]["flops"] > 0.5 * 6
                * prod["n_active_params"] * prod["tokens_per_step"] / 256,
                "the production cell's flops above half of 6 N T")
    n = counted(gfm, circ)
    require(n == {"gf_matmul": 0, "circulant_encode": 0},
            f"the dry run launches no kernel: {n}")
    keep_keys = ("arch", "shape", "mesh", "layout", "n_microbatches",
                 "n_params", "n_active_params", "memory", "per_position",
                 "run_s")
    return {"reduced_cell": {k: rec.get(k) for k in keep_keys},
            "production_cell": {**{k: prod.get(k) for k in keep_keys},
                                **{k: prod["dynamic"][k] for k in (
                                    "depth_run", "groups_run",
                                    "steps_run")}},
            "cpu": host_cpu(), "launches": n}


def host_cpu() -> str:
    """The host CPU's model name (from /proc/cpuinfo) and core count."""
    try:
        name = next(ln.split(":", 1)[1].strip()
                    for ln in Path("/proc/cpuinfo").read_text().splitlines()
                    if ln.startswith("model name"))
    except (OSError, StopIteration):
        name = "unknown"
    return f"{name} x {os.cpu_count()}"


# --only: phases run alone after the build, in order
ONLY = {"parallel_families": ("parallel_families",),
        "families,parallel_families": ("families", "parallel_families"),
        "examples": ("examples",), "dryrun": ("dryrun",),
        "examples,dryrun": ("examples", "dryrun")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--payload-mib", type=int, default=1024,
                    help="main-path payload; only the payload is ever cut, "
                         "never k or p (default 1024 = 1 GiB)")
    ap.add_argument("--store-mib", type=int, default=1024,
                    help="store-phase payload over 16 objects; only the "
                         "payload is ever cut (default 1024 = 1 GiB)")
    ap.add_argument("--ckpt-mib", type=int, default=512,
                    help="checkpoint-phase training state (default 512)")
    ap.add_argument("--serve-mib", type=int, default=256,
                    help="serve-phase payload over 16 objects (default 256)")
    ap.add_argument("--only", choices=ONLY, default=None,
                    help="build the kernels and run only these phases "
                         "(a rehearsal: no kernels line; without phase "
                         "families, parallel_families draws every family's "
                         "parameters from Model.init)")
    args = ap.parse_args()
    # deterministic cuBLAS for the train phase's bit-exact crash drill:
    # read when the process makes its first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from repro_torch.configs import get_config

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
    if args.only:
        kept: dict = {}
        for phase in ONLY[args.only]:
            t0 = time.perf_counter()
            fn = {"families": phase_families,
                  "parallel_families": phase_parallel_families,
                  "examples": phase_examples, "dryrun": phase_dryrun}[phase]
            emit({"phase": phase, "ok": True, "card": smi,
                  **fn(torch, np, gfm, circ, kept),
                  "seconds": time.perf_counter() - t0})
        print(smi, flush=True)
        emit({"ok": True, "only": ONLY[args.only],
              "device": {"platform": "gpu", "kind": name,
                         "count": torch.cuda.device_count()}})
        return 0

    payload_bytes = args.payload_mib << 20
    n = 2 * K
    s_main = -(-payload_bytes // n)
    if args.payload_mib != 1024:
        emit({"phase": "cut", "payload_mib": args.payload_mib,
              "full_payload_mib": 1024})

    t0 = time.perf_counter()
    model_stripes = [-(-nbytes // (n * STORE_STRIPE)) for nbytes in
                     [MODEL_PARAM_BYTES] + [f["param_bytes"] for f in
                                            FAMILIES.values() if f["stored"]]]
    demo_symbols = -(-model_param_bytes(torch, get_config(MODEL_ARCH)
                                        .reduced()) // DEMO_N)
    kern = phase_kernels(torch, gfm, circ, ref, fold_mismatches, s_main,
                         (args.store_mib << 20) // STORE_OBJECTS,
                         args.ckpt_mib, model_stripes, demo_symbols,
                         train_drill_symbols(torch))
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

    t0 = time.perf_counter()
    ckpt_res = phase_checkpoint(torch, np, gfm, circ, args.ckpt_mib)
    emit({"phase": "checkpoint", "ok": True, "card": smi,
          "code": f"[{n},{K}] GF({P})", **ckpt_res,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    serve_res = phase_serve(torch, np, gfm, circ, args.serve_mib)
    emit({"phase": "serve", "ok": True, "card": smi,
          "code": f"[{n},{K}] GF({P})", "nodes": STORE_NODES, **serve_res,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    cluster_res = phase_cluster(torch, np, gfm, circ, CLUSTER_SYMBOLS)
    emit({"phase": "cluster", "ok": True, "card": smi,
          "code": f"[{n},{K}] GF({P})", **cluster_res,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    drill_res = phase_drills(torch, gfm, circ)
    emit({"phase": "drills", "ok": True, "card": smi, "code": "[6,3] GF(257)",
          **drill_res, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    shard_res = phase_shard(torch, np, gfm, circ, plan_mod,
                            main_res["symbols_per_block"], args.store_mib,
                            args.ckpt_mib)
    emit({"phase": "shard", "ok": True, "card": smi,
          "code": f"[{n},{K}] GF({P})", **shard_res,
          "seconds": time.perf_counter() - t0})

    import dataclasses
    cut = model_config(dataclasses, get_config)
    require(model_param_bytes(torch, cut) == MODEL_PARAM_BYTES,
            "the model phase's parameter count")
    emit({"phase": "cut", "model": MODEL_ARCH, "reduced": {
        "n_layers": [get_config(MODEL_ARCH).n_layers, cut.n_layers]}})
    t0 = time.perf_counter()
    kept: dict = {}
    model_res = phase_model(torch, np, gfm, circ, kept)
    emit({"phase": "model", "ok": True, "card": smi,
          "code": f"[{n},{K}] GF({P})", "nodes": STORE_NODES,
          "stripe_symbols": STORE_STRIPE, **model_res,
          "seconds": time.perf_counter() - t0})

    for arch in FAMILIES:
        full, cut = get_config(arch), family_config(dataclasses, get_config,
                                                    arch)
        require(model_param_bytes(torch, cut) == FAMILIES[arch]["param_bytes"],
                f"the families phase's parameter count of {arch}")
        emit({"phase": "cut", "model": arch, "reduced": {
            k: [getattr(full, k), getattr(cut, k)]
            for k in FAMILIES[arch]["layers"]}})
    t0 = time.perf_counter()
    families_res = phase_families(torch, np, gfm, circ, kept)
    emit({"phase": "families", "ok": True, "card": smi,
          "code": f"[{n},{K}] GF({P})", "nodes": STORE_NODES,
          "stripe_symbols": STORE_STRIPE, "lost_node": FAMILY_LOST_NODE,
          "batch": FAMILY_BATCH, "prompt": FAMILY_PROMPT,
          "whisper_prompt": WHISPER_PROMPT, "new_tokens": FAMILY_NEW,
          **families_res, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    train_res = phase_train(torch, np, gfm, circ, TRAIN_STEPS)
    emit({"phase": "train", "ok": True, "card": smi, **train_res,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    parallel_res = phase_parallel(torch, np, gfm, circ,
                                  kept.pop("params_node3_lost"))
    emit({"phase": "parallel", "ok": True, "card": smi, **parallel_res,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    pf_res = phase_parallel_families(torch, np, gfm, circ, kept)
    emit({"phase": "parallel_families", "ok": True, "card": smi, **pf_res,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    ex_res = phase_examples(torch, np, gfm, circ, kept)
    emit({"phase": "examples", "ok": True, "card": smi, **ex_res,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    dry_res = phase_dryrun(torch, np, gfm, circ, kept)
    emit({"phase": "dryrun", "ok": True, "card": smi, **dry_res,
          "seconds": time.perf_counter() - t0})

    paths = {"main": main_res, "store": store_res, "checkpoint": ckpt_res,
             "serve": serve_res, "cluster": cluster_res, "drills": drill_res,
             "shard": shard_res, "model": model_res, "families": families_res,
             "train": train_res, "parallel": parallel_res,
             "parallel_families": pf_res, "examples": ex_res,
             "dryrun": dry_res}
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
            "launches": sum(r["launches"][kname] for r in paths.values()),
            "launches_by_path": {path: r["launches"][kname]
                                 for path, r in paths.items()},
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
