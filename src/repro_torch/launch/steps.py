"""The train step of the port (``repro.launch.steps``, its training half:
``make_train_step``, ``pick_microbatches``, ``count_params``).

The step is eager PyTorch: gradients come from ``torch.autograd.grad`` on
``Model.loss``, microbatches accumulate in fp32 in order, and the update
is ``optim.adamw.update``.  Nothing is compiled.

Determinism.  Run twice on the same inputs, the step gives bit-identical
states on the CPU.  On the card that needs
``torch.use_deterministic_algorithms(True)`` (the embedding gather's
backward accumulates rows that several tokens share) with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the process's first cuBLAS
call: :func:`deterministic` sets both, and ``repro_torch.train.loop.train``
runs under it.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Any

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.core.placement import tree_flatten
from repro_torch.optim import adamw

CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels for the duration: ``CUBLAS_WORKSPACE_CONFIG``
    set if unset (it only takes effect if no cuBLAS call has run yet in
    this process; a caller that needs it earlier sets it before starting
    CUDA), ``torch.use_deterministic_algorithms(True)``, and the previous
    mode restored on exit.  Uninitialized memory is not filled: nothing
    on the path reads memory before writing it."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    was_fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = was_fill
        torch.use_deterministic_algorithms(was, warn_only=was_warn)


def _compute_copy(x: torch.Tensor) -> torch.Tensor:
    """A weight as the model consumes it: a >= 2-D fp32 leaf cast to bf16
    (its gradient comes back fp32 through the cast), others as they are."""
    if x.dtype == torch.float32 and x.ndim >= 2:
        return x.to(torch.bfloat16)
    return x


def grads_of(model, params, batch) -> tuple[torch.Tensor, dict, Any]:
    """(loss, {"xent", "aux"}, grads) of ``model.loss`` at ``params``, the
    weights cast to bf16 at use as the reference's train step casts them;
    ``grads`` has ``params``' structure and dtypes."""
    leaves, tdef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss(
            tdef.unflatten([_compute_copy(x) for x in leaves]), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tdef.unflatten(list(grads)))


def _split_micro(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches in order: each leaf split on its batch axis —
    dim 1 of (3, b, s) M-RoPE positions, dim 0 of everything else."""
    def split(k, x):
        dim = 1 if (k == "positions" and x.ndim == 3) else 0
        b = x.shape[dim]
        if b % n:
            raise ValueError(f"batch {b} of {k!r} does not split into {n} "
                             f"microbatches")
        return torch.split(x, b // n, dim=dim)

    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def accumulate_grads(model, params, batch, n_microbatches: int = 1,
                     ) -> tuple[torch.Tensor, dict, Any]:
    """(loss, {"xent", "aux"}, grads) of one step: :func:`grads_of` on the
    whole batch, or on ``n_microbatches`` slices in order with each
    slice's grads summed into an fp32 accumulator and divided by n, as
    the loss and aux are (the reference's ``metrics["xent"]`` of a
    microbatched step is that mean loss)."""
    if n_microbatches == 1:
        return grads_of(model, params, batch)
    leaves, tdef = tree_flatten(params)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    aux = torch.zeros_like(loss)
    for mb in _split_micro(batch, n_microbatches):
        mloss, mmetrics, g = grads_of(model, params, mb)
        g_acc = [a + b.float() for a, b in zip(g_acc, tree_flatten(g)[0])]
        loss = loss + mloss
        aux = aux + mmetrics["aux"]
    loss = loss / n_microbatches
    return (loss, {"xent": loss, "aux": aux / n_microbatches},
            tdef.unflatten([g / n_microbatches for g in g_acc]))


def make_train_step(model, opt_cfg: adamw.AdamWConfig,
                    n_microbatches: int = 1):
    """Gradient-accumulated train step ``train_step(state, batch) ->
    (state, metrics)`` over ``state = {"params", "opt"}``: the grads of
    :func:`accumulate_grads`, then ``adamw.update``.  ``metrics`` holds
    0-d tensors: loss, xent, aux, grad_norm, lr."""

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = accumulate_grads(model, params, batch,
                                                n_microbatches)
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, grads, state["opt"], params)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **metrics, **opt_metrics})

    return train_step


def pick_microbatches(shape: ShapeConfig, n_batch_shards: int,
                      target_dev_tokens: int = 16384) -> int:
    """Largest microbatch count that divides the per-shard batch while
    pushing per-device live tokens down to ~target_dev_tokens."""
    local = shape.global_batch // max(n_batch_shards, 1)
    if local <= 0:
        return 1
    want = max(1, (local * shape.seq_len) // target_dev_tokens)
    n = min(local, want)
    while local % n:
        n -= 1
    return max(1, n)


def count_params(params) -> int:
    """Elements in a tree of tensors (or anything with a ``shape``)."""
    return sum(math.prod(x.shape) if len(x.shape) else 1
               for x in tree_flatten(params)[0])


__all__ = ["make_train_step", "pick_microbatches", "count_params",
           "grads_of", "accumulate_grads", "deterministic",
           "CUBLAS_WORKSPACE_CONFIG"]
