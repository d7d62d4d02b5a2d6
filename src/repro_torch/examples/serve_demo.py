"""Kill-nodes-while-serving, end to end (the port of
``examples/serve_demo.py``).

The serving engine's parameters live MSR-coded across a [2k, k] storage
cluster.  Mid-service a rack's worth of nodes is killed: parameter reads
transparently fall back to the one-matmul degraded decode, generation
continues bit-exactly, the fused repair engine rebuilds the lost nodes,
and the bandwidth ledger shows the repair traffic vs the classical-RS
re-download baseline.  The parameters are ``Model.init``'s draws from a
torch generator seeded 0, so the sampled tokens differ from the
reference's; every other number it prints is the reference's.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--arch qwen3-4b] [--k 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.cluster.events import default_layout
from repro_torch.configs import get_config
from repro_torch.core.circulant import CodeSpec
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serve.engine import CodedReadServer, Request, ServingEngine


def make_requests(rng, vocab, batch, new_tokens):
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, size=6 + i).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i in range(batch * 2 + 1)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--k", type=int, default=4, help="MSR code dimension")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)

    # ---- encode the parameters across the cluster
    spec = CodeSpec.make(args.k, 257)
    layout = default_layout(spec.n, spec.k)
    store = CodedReadServer.for_pytree(params, spec, layout=layout,
                                       device=device)
    s_sym = store.sim.S
    print(f"arch={cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model}) — "
          f"params stored on a [{spec.n},{spec.k}] MSR cluster over "
          f"GF({spec.p}), {s_sym/2**20:.2f} Mi symbols/block, "
          f"{layout.n_racks} racks")

    eng = ServingEngine.from_coded_store(model, store,
                                         batch_size=args.batch, max_len=128)
    rng = np.random.default_rng(0)
    reqs = make_requests(rng, cfg.vocab_size, args.batch, args.new_tokens)
    baseline = [list(r.prompt) for r in reqs]

    t0 = time.perf_counter()
    done = eng.serve(reqs, prompt_len=16)
    healthy_tokens = [r.out_tokens for r in done]
    print(f"\n[healthy] served {len(done)} requests in "
          f"{time.perf_counter()-t0:.2f}s (all-systematic parameter reads)")

    # ---- kill a rack's worth of nodes while serving continues
    victims = layout.nodes_in(0)[: spec.n - spec.k]
    for v in victims:
        store.sim.fail_node(v)
    print(f"\n[failure] killed nodes {list(victims)} (rack 0); "
          f"{len(store.sim.up_nodes())}/{spec.n} nodes up")

    eng.reload_params(store)            # transparent degraded decode
    reqs2 = [Request(uid=r.uid, prompt=np.asarray(p, np.int32),
                     max_new_tokens=args.new_tokens)
             for r, p in zip(done, baseline)]
    done2 = eng.serve(reqs2, prompt_len=16)
    degraded_tokens = [r.out_tokens for r in done2]
    assert degraded_tokens == healthy_tokens, "degraded decode must be bit-exact"
    print(f"[degraded] re-served all {len(done2)} requests BIT-EXACTLY from "
          f"{len(store.sim.up_nodes())} survivors "
          f"({store.metrics.reads_degraded} degraded block reads)")

    # ---- repair and verify the cluster is whole again
    repaired = store.sim.repair_now()
    if not repaired:
        raise RuntimeError("repair impossible: fewer than k nodes up")
    rep = store.metrics.summary()["repair"]
    assert torch.equal(store.sim.node_a, store.sim._orig_a)
    print(f"\n[repair] rebuilt {rep['nodes_repaired']} nodes in "
          f"{rep['events']} one-matmul decode(s): moved "
          f"{rep['symbols_moved']/2**20:.2f} Mi symbols vs RS re-download "
          f"{rep['rs_baseline_symbols']/2**20:.2f} Mi "
          f"(ratio {rep['ratio_vs_rs']})")
    eng.reload_params(store)
    done3 = eng.serve([Request(uid=r.uid, prompt=np.asarray(p, np.int32),
                               max_new_tokens=args.new_tokens)
                       for r, p in zip(done, baseline)], prompt_len=16)
    assert [r.out_tokens for r in done3] == healthy_tokens
    m = store.metrics.summary()
    assert m["availability"] == 1.0, m["availability"]
    print(f"[healed] cluster whole; availability={m['availability']}, "
          f"reads: {m['reads']['systematic']} systematic / "
          f"{m['reads']['degraded']} degraded / {m['reads']['failed']} failed")
    for r in done3[:3]:
        print(f"  req {r.uid}: prompt[-4:]={r.prompt[-4:].tolist()} -> "
              f"{r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
