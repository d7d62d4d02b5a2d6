"""End-to-end fault-tolerant training example of the port (the twin of the
reference's ``examples/train_tiny_lm.py``).

Trains an LM on the synthetic pipeline with MSR-coded checkpointing and an
injected node crash mid-run; verifies the post-repair run is bit-exact with
an uninterrupted one.

    PYTHONPATH=src python -m repro_torch.train.tiny_lm --preset tiny
    PYTHONPATH=src python -m repro_torch.train.tiny_lm --preset 100m
    PYTHONPATH=src python -m repro_torch.train.tiny_lm --arch qwen3-4b --reduced

The state and the GF kernels run on the card unless ``--device cpu`` is
given; checkpoint files go to ``--ckpt-dir`` (default: a new temporary
directory).
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Callable

import torch

from repro_torch.checkpoint.msr_checkpoint import MSRCheckpointer
from repro_torch.configs import get_config
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.placement import tree_flatten
from repro_torch.launch.steps import count_params
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.train.fault_tolerance import FailureEvent, FailureInjector
from repro_torch.train.loop import TrainConfig, train

PRESETS = {
    "tiny": dict(model=dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, d_ff=512, vocab_size=512,
                            loss_chunk=64),
                 steps=120, batch=8, seq=64),
    "100m": dict(model=dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                            head_dim=64, d_ff=2048, vocab_size=8192,
                            loss_chunk=128),
                 steps=300, batch=8, seq=256),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--arch", default="paper-tiny-lm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--k", type=int, default=4, help="MSR code dimension")
    ap.add_argument("--crash-step", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="where the state and the GF kernels run "
                         "(default: the card)")
    return ap


def run(args, log: Callable = print) -> dict:
    """The drill: a supervised run with node 2 crashing at ``crash_step``,
    then an uninterrupted run checkpointing into a temporary directory;
    asserts the loss fell, the crash was repaired once and both final
    states are bit-exact.  Returns the crashed run's repairs, losses and
    final state, and the run's shape."""
    preset = PRESETS[args.preset]
    cfg = get_config(args.arch)
    if args.reduced or args.arch == "paper-tiny-lm":
        cfg = cfg.reduced(**preset["model"])
    steps = args.steps or preset["steps"]
    tcfg = TrainConfig(n_steps=steps, global_batch=preset["batch"],
                       seq_len=preset["seq"], ckpt_every=max(steps // 6, 5),
                       log_every=max(steps // 10, 1), seed=0)
    crash = args.crash_step or (steps * 2 // 3)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="msr_ckpt_")
    spec = CodeSpec.make(args.k, 257)
    n_params = count_params(Model(cfg).init(torch.Generator(),
                                            device="meta"))
    log(f"arch={cfg.name}  params={n_params/1e6:.1f}M  steps={steps}  "
        f"MSR code [{spec.n},{spec.k}] over GF({spec.p})  ckpt={ckpt_dir}")
    ckpt = MSRCheckpointer(ckpt_dir, spec, device=args.device)
    injector = FailureInjector(spec.n, schedule=[FailureEvent(step=crash,
                                                              node=2)])

    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=max(steps // 20, 1),
                            total_steps=steps)
    log(f"\n-- training with a node-2 crash injected at step {crash} --")
    state, hist = train(cfg, tcfg, opt, checkpointer=ckpt, injector=injector,
                        log=log, device=args.device)
    repairs = [e for e in hist if e["event"] == "repair"]
    steps_logged = [e for e in hist if e["event"] == "step"]
    log(f"completed: {len(steps_logged)} step executions, "
        f"{len(repairs)} repair event(s)")
    for r in repairs:
        log(f"  crash@{r['step']}: restored from ckpt@{r['ckpt_step']} via "
            f"'{r['restore_path']}', repair read "
            f"{r['repair_bytes']/2**20:.2f} MiB")
    losses = [e["loss"] for e in steps_logged]
    log(f"loss: first={losses[0]:.4f}  last={losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("training must make progress")
    if len(repairs) != 1:
        raise AssertionError(f"one repair event expected, got {repairs}")

    log("\n-- verifying bit-exact equivalence with an uninterrupted run --")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt2 = MSRCheckpointer(tmp, spec, device=args.device)
        state_clean, _ = train(cfg, tcfg, opt, checkpointer=ckpt2, log=log,
                               device=args.device)
    la, ta = tree_flatten(state)
    lb, tb = tree_flatten(state_clean)
    if ta != tb or not all(a.dtype == b.dtype and torch.equal(a, b)
                           for a, b in zip(la, lb)):
        raise AssertionError("the crashed run's final state differs from "
                             "the uninterrupted run's")
    log("final states are BIT-EXACT equal: crash + MSR repair is invisible.")
    return {"repairs": repairs, "losses": losses, "state": state,
            "n_params": n_params, "steps": steps, "crash_step": crash,
            "ckpt_every": tcfg.ckpt_every}


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
