"""Training loop of the port (``repro.train.loop``): eager gradient-
accumulated steps + MSR checkpointing + failure supervision.  Used by
``repro_torch.train.tiny_lm`` and the parity tests.

Where the reference jits its step with the state donated, the port runs
``launch.steps.make_train_step`` eagerly: each step returns a new state
and the old one is dropped.  On the card every step runs under
``launch.steps.deterministic()`` (``torch.use_deterministic_algorithms``
with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), so a run that crashes, repairs
its checkpoint and replays ends bit-exact with one that never crashed.

Training states cross between the packages as numpy trees:
:func:`state_from_numpy` turns the reference's ``{"params", "opt"}`` (its
``OptState`` with numpy leaves) into the port's, and :func:`numpy_state`
goes back, every leaf bit-equal.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.placement import tree_flatten
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import deterministic, make_train_step
from repro_torch.models import Model, params_from_numpy
from repro_torch.optim import adamw

from .fault_tolerance import FailureInjector, Supervisor


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    n_microbatches: int = 1
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    write_behind: bool = False   # zero-stall checkpointing (DESIGN.md §12.5)


def init_state(model: Model, opt_cfg: adamw.AdamWConfig, seed: int = 0,
               device=None) -> dict:
    """Parameters drawn from ``torch.Generator(device).manual_seed(seed)``
    (not ``jax.random``'s draws: carry a state across with
    :func:`state_from_numpy`) and a fresh optimizer state, on ``device``
    (None: the card)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device=device)
    return {"params": params, "opt": adamw.init(params, opt_cfg)}


def state_from_numpy(state: dict, device=None) -> dict:
    """A training state ``{"params", "opt"}`` with numpy leaves — ``opt``
    any (mu, nu, step) triple such as the reference's ``OptState`` — as
    the port's, on ``device`` (None: the card), every leaf bit-equal."""
    mu, nu, step = state["opt"]
    return {"params": params_from_numpy(state["params"], device),
            "opt": adamw.OptState(mu=params_from_numpy(mu, device),
                                  nu=params_from_numpy(nu, device),
                                  step=params_from_numpy(step, device))}


def _numpy_leaf(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes        # numpy's bfloat16, as JAX hands it out
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def numpy_state(state: dict) -> dict:
    """The port's training state as numpy leaves of the same structure
    (``opt`` stays the port's ``OptState``; the reference's is
    ``OptState(*opt)``)."""
    leaves, tdef = tree_flatten(state)
    return tdef.unflatten([_numpy_leaf(x) for x in leaves])


def train(cfg: ModelConfig, tcfg: TrainConfig,
          opt_cfg: Optional[adamw.AdamWConfig] = None, *,
          checkpointer=None, injector: Optional[FailureInjector] = None,
          state: Optional[dict] = None, start_step: int = 0,
          log: Callable = print, device=None) -> tuple[dict, list[dict]]:
    """Returns (final_state, history).  Deterministic given seeds.

    ``device`` (None: the card) is where the state is drawn when
    ``state`` is None and where batches go; a given state stays where it
    is.  With a ``checkpointer`` the run goes through the ``Supervisor``
    (saves every ``ckpt_every`` steps, crash repair and replay), whose
    log is the history; otherwise a record is kept every ``log_every``
    steps and the last."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(
        lr=1e-3, warmup_steps=max(tcfg.n_steps // 20, 1),
        total_steps=tcfg.n_steps)
    model = Model(cfg)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
                               global_batch=tcfg.global_batch, seed=tcfg.seed)
    if state is None:
        state = init_state(model, opt_cfg, tcfg.seed, device)
    dev = state["opt"].step.device
    step_fn = make_train_step(model, opt_cfg, tcfg.n_microbatches)

    def data_fn(step: int) -> dict:
        b = pipeline.batch_at(dcfg, step)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    history: list[dict] = []
    with deterministic():
        if checkpointer is not None:
            sup = Supervisor(checkpointer, injector,
                             ckpt_every=tcfg.ckpt_every,
                             write_behind=tcfg.write_behind)
            state = sup.run(state, step_fn, data_fn, tcfg.n_steps,
                            start_step=start_step)
            return state, sup.log

        t0 = time.time()
        for step in range(start_step, start_step + tcfg.n_steps):
            state, metrics = step_fn(state, data_fn(step))
            if step % tcfg.log_every == 0 \
                    or step == start_step + tcfg.n_steps - 1:
                rec = {"step": step, "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "t": round(time.time() - t0, 2)}
                history.append(rec)
                log(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
                    f"gnorm {rec['grad_norm']:.3f}  {rec['t']}s")
    return state, history


__all__ = ["TrainConfig", "init_state", "train", "state_from_numpy",
           "numpy_state"]
