"""Step functions (train / prefill / decode) and shape stand-ins for every
(arch x shape) cell of the port (``repro.launch.steps``).

The steps are eager PyTorch: gradients come from ``torch.autograd.grad``
on ``Model.loss``, microbatches accumulate in fp32 in order, and the
update is ``optim.adamw.update``.  Nothing is compiled.  Every step takes
its state and batch either whole or laid out over a (data, model) mesh
(``sharding.place.place`` by the ``sharding.policy`` specs): the model
then runs under ``sharding.parallel``, and the results come back laid
out alike.  ``jax.ShapeDtypeStruct`` stand-ins are tensors on the
``meta`` device: shapes and dtypes, no memory.

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
from repro_torch.sharding import place
from repro_torch.sharding.place import Sharded
from repro_torch.sharding.policy import tree_map_with_path

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
    ``grads`` has ``params``' structure and dtypes.  A Sharded leaf is
    differentiated shard by shard (one input per distinct shard tensor)
    and its gradient laid out alike, copies of a block on distinct
    devices summed in mesh order (``place.reduce_copies``)."""
    leaves, tdef = tree_flatten(params)
    inputs: dict = {}

    def wants_grad(t):
        return inputs.setdefault(id(t), t.detach().requires_grad_(True))
    leaves = [place.leafwise(wants_grad, x) for x in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss(
            tdef.unflatten([_compute_copy(x) for x in leaves]), batch)
        grads = torch.autograd.grad(loss, list(inputs.values()),
                                    materialize_grads=True)
    by_id = {id(t): g for t, g in zip(inputs.values(), grads)}
    grads = [place.leafwise(lambda t: by_id[id(t)], x) for x in leaves]
    grads = [place.reduce_copies(g) if isinstance(g, Sharded) else g
             for g in grads]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tdef.unflatten(grads))


def _split_micro(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches in order, each a contiguous slice of the global
    batch as the reference cuts them: each leaf split on its batch axis —
    dim 1 of (3, b, s) M-RoPE positions, dim 0 of everything else.  A
    Sharded leaf's slice is re-laid over its batch axes
    (:meth:`Sharded.take`; rows that change position count in
    ``place.traffic``)."""
    def split(k, x):
        dim = 1 if (k == "positions" and x.ndim == 3) else 0
        b = x.shape[dim]
        if b % n:
            raise ValueError(f"batch {b} of {k!r} does not split into {n} "
                             f"microbatches")
        if isinstance(x, Sharded):
            try:
                return [x.take(dim, i * b // n, (i + 1) * b // n)
                        for i in range(n)]
            except ValueError as e:
                raise ValueError(f"{k!r} does not split into {n} "
                                 f"microbatches: {e}") from None
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
    g_acc = [place.leafwise(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), p) for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    aux = torch.zeros_like(loss)
    for mb in _split_micro(batch, n_microbatches):
        mloss, mmetrics, g = grads_of(model, params, mb)
        g_acc = [place.leafwise(lambda a, b: a + b.float(), a, b)
                 for a, b in zip(g_acc, tree_flatten(g)[0])]
        loss = loss + mloss
        aux = aux + mmetrics["aux"]
    loss = loss / n_microbatches
    return (loss, {"xent": loss, "aux": aux / n_microbatches},
            tdef.unflatten([place.leafwise(lambda g: g / n_microbatches, g)
                            for g in g_acc]))


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


def make_prefill_step(model, *, max_len: int, q_chunk: int = 1024):
    """``prefill_step(params, batch) -> (last-position logits, cache)``."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=max_len, q_chunk=q_chunk)

    return prefill_step


def make_decode_step(model, *, max_len: int):
    """``serve_step(params, cache, tokens, pos) -> (logits, cache)``."""
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, max_len=max_len)

    return serve_step


# ------------------------------------------------------------ input specs
def f(shape, dtype) -> torch.Tensor:
    """A shape stand-in: an empty tensor on the ``meta`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeConfig, *, labels: bool = True) -> dict:
    """Stand-ins for every model input of a train/prefill batch.  The
    frontends are stubs: audio and vision configs take precomputed
    frame/patch embeddings."""
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.embeds_as_input and not cfg.is_encoder_decoder:
        out["inputs_embeds"] = f((b, s, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = f((b, s), torch.int32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = f((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    if cfg.mrope_sections:
        out["positions"] = f((3, b, s), torch.int32)
    if labels and shape.kind == "train":
        out["labels"] = f((b, s), torch.int32)
    return out


def decode_input_specs(cfg, shape: ShapeConfig, model):
    """(cache, tokens, pos) stand-ins for the decode step at this cell:
    one new token against a KV cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    return (model.init_cache(b, s, device="meta"), f((b, 1), torch.int32),
            f((), torch.int32))


def state_specs(model) -> dict:
    """Stand-ins of a training state ``{"params", "opt"}``."""
    params = model.init(torch.Generator(), device="meta")
    return {"params": params, "opt": adamw.init(params)}


def count_params(params) -> int:
    """Elements in a tree of tensors (or anything with a ``shape``)."""
    return sum(math.prod(x.shape) if len(x.shape) else 1
               for x in tree_flatten(params)[0])


def count_active_params(cfg, params_shapes) -> int:
    """MoE: experts beyond top-k don't contribute to per-token compute."""
    total = count_params(params_shapes)
    if not cfg.n_experts:
        return total
    # expert tensors are the w_in/w_gate/w_out leaves under "moe" (they
    # carry an E axis, possibly behind the stacked n_cycles axis)
    expert = 0

    def visit(names, leaf):
        nonlocal expert
        if "moe" in names and names[-1] in ("w_in", "w_gate", "w_out"):
            expert += math.prod(leaf.shape)
        return leaf
    tree_map_with_path(visit, params_shapes)
    frac = cfg.n_experts_per_token / cfg.n_experts
    return int(total - expert * (1 - frac))


__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "pick_microbatches", "input_specs", "decode_input_specs",
           "state_specs", "count_params", "count_active_params",
           "grads_of", "accumulate_grads", "deterministic",
           "CUBLAS_WORKSPACE_CONFIG"]
