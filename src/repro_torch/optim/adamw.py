"""AdamW on trees of tensors (the port of ``repro.optim.adamw``): init /
update, bf16-safe.

Master weights and moments are fp32 regardless of compute dtype (moments
in ``moment_dtype`` when asked), and ``OptState.step`` is an int32 scalar
tensor.  ``OptState`` is a NamedTuple of the reference's name and fields,
so a training state ``{"params", "opt"}`` flattens to the reference's
tree (its ``TreeDef`` string equals the reference's ``PyTreeDef``) and a
checkpoint of either package restores in the other.  The update is one
pass over the leaves in the reference's flatten order, written as plain
tensor functions; nothing is updated in place.

A tree laid out over a mesh (``sharding.place.Sharded`` leaves, moments
by ``policy.opt_specs``) updates shard by shard where each shard lies;
its global norm counts each distinct block once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.placement import tree_flatten
from repro_torch.sharding.mesh import move_to
from repro_torch.sharding.place import Sharded, leafwise, shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"     # bf16 halves optimizer memory


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor


def _moment_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.moment_dtype] if cfg else torch.float32


def init(params, cfg: AdamWConfig | None = None) -> OptState:
    """Zero moments shaped like ``params`` (on each leaf's device) and
    step 0 on the first leaf's device."""
    dt = _moment_dtype(cfg)
    leaves, tdef = tree_flatten(params)
    zeros = [leafwise(lambda t: torch.zeros(t.shape, dtype=dt,
                                            device=t.device), p)
             for p in leaves]
    dev = leaves[0].device if leaves else None
    return OptState(mu=tdef.unflatten(zeros),
                    nu=tdef.unflatten([leafwise(torch.zeros_like, z)
                                       for z in zeros]),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in fp32."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, summed in the
    tree's flatten order.  A Sharded leaf adds each distinct block once,
    in mesh order, whatever positions replicate it; the sum lies on the
    first leaf's device."""
    total = 0
    for x in tree_flatten(tree)[0]:
        blocks = ([hs[0][1] for hs in x.holders().values()]
                  if isinstance(x, Sharded) else [x])
        for b in blocks:
            part = torch.sum(torch.square(b.float()))
            total = total + (part if isinstance(total, int)
                             else move_to(part, total.device))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: OptState, params):
    """Returns (new_params, new_state, metrics): the clipped AdamW step
    with decoupled weight decay, ``metrics = {"grad_norm", "lr"}``."""
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    sharded_step = isinstance(state.step, Sharded)
    step = (state.step.gather() if sharded_step else state.step) + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    mdt = _DTYPES[cfg.moment_dtype]

    def upd(g, m, v, p):
        c, lr_, b1c_, b2c_ = (move_to(t, p.device)
                              for t in (clip, lr, b1c, b2c))
        g = g.float() * c
        m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m / b1c_
        vhat = v / b2c_
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr_ * (step_ + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m.to(mdt), v.to(mdt)

    def upd_leaf(g, m, v, p):
        if isinstance(p, Sharded):
            return g.map_many(upd, m, v, p)
        return upd(g, m, v, p)

    flat_p, tdef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state.mu)[0]
    flat_v = tree_flatten(state.nu)[0]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments must be trees of the "
                         "same structure")
    out = [upd_leaf(g, m, v, p) for g, m, v, p in zip(flat_g, flat_m,
                                                      flat_v, flat_p)]
    new_p = tdef.unflatten([o[0] for o in out])
    new_m = tdef.unflatten([o[1] for o in out])
    new_v = tdef.unflatten([o[2] for o in out])
    if sharded_step:
        step = shard(step, state.step.mesh, state.step.spec)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(mu=new_m, nu=new_v, step=step), metrics


__all__ = ["AdamWConfig", "OptState", "init", "schedule", "global_norm",
           "update"]
