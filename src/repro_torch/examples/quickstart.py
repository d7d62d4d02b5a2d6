"""Quickstart: the paper end to end (the port of ``examples/quickstart.py``).

Encode a file with a [2k, k] double circulant MSR code, kill a node,
regenerate it with the embedded d = k+1 protocol, and verify any-k
reconstruction -- printing the bandwidth ledger from eq. (7).  The
encode is one ``circulant_encode`` launch on the card and the
regeneration one ``gf_matmul`` launch.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--k 4] [--mb 4] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR, encode_file, reconstruct_file
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--mb", type=float, default=4.0, help="file size in MiB")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    k = args.k
    spec = CodeSpec.make(k, p=257)
    code = DoubleCirculantMSR(spec, device=resolve_device(args.device))
    n, d = spec.n, spec.d
    print(f"[{n},{k}] double circulant MSR code over GF(257), "
          f"c = {spec.c}  (condition (6) verified)")

    payload = np.random.default_rng(0).integers(0, 256, int(args.mb * 2**20),
                                                dtype=np.int64).astype(np.uint8).tobytes()
    enc = encode_file(payload, spec, code)
    b = len(payload)
    s_block = enc.data.shape[1]
    print(f"file B = {b/2**20:.1f} MiB -> {n} data blocks + {n} redundancy "
          f"blocks of {s_block/2**20:.2f} MiB; per-node alpha = {2*s_block/2**20:.2f} MiB "
          f"(= B/k, the MSR point)")

    # ---- kill node 3 and regenerate it through the fused batched engine:
    # the whole newcomer computation is ONE (2, k+1) repair-matrix matmul
    victim = 3
    plan = code.repair_plan(victim)
    print(f"\nnode v_{victim} fails.  Embedded repair plan (no coefficient "
          f"search): redundancy from v_{plan.prev_node}, data from "
          f"{['v_%d' % j for j in plan.next_nodes]}")
    r_prevs = enc.red[plan.prev_node - 1][None]                     # (1, S)
    idx = torch.as_tensor(list(plan.data_indices), device=enc.data.device)
    nxt = enc.data[idx][None]                                       # (1,k,S)
    pairs = code.regenerate_batch([victim], r_prevs, nxt)
    assert torch.equal(pairs[0, 0], enc.data[victim - 1])
    assert torch.equal(pairs[0, 1], enc.red[victim - 1])
    gamma = d * s_block
    print(f"regenerated BIT-EXACTLY in one fused matmul.  downloaded {d} "
          f"blocks = {gamma/2**20:.2f} MiB = (k+1)B/2k; classical EC would "
          f"read {b/2**20:.1f} MiB  ->  saving {1-gamma/b:.1%}")

    # ---- any-k reconstruction (data collector path); the system inverse
    # is LRU-cached by node subset, so the second call costs no solve
    pick = sorted(np.random.default_rng(1).choice(n, size=k, replace=False) + 1)
    got = reconstruct_file(enc, [int(x) for x in pick], code)
    assert got == payload
    reconstruct_file(enc, [int(x) for x in pick], code)   # cache hit
    info = code.repair.decode_cache.cache_info()
    print(f"\nDC reconstruction from nodes {pick}: OK "
          f"(downloaded 2k blocks = B = {b/2**20:.1f} MiB, the minimum; "
          f"decode-inverse cache: {info.hits} hit / {info.misses} miss)")


if __name__ == "__main__":
    main()
