"""Sharding policy of the port (``repro.sharding.policy``): a spec per
(param path x shape) and per batch / cache kind, for the production
meshes (DESIGN.md §6).

Sharding never changes semantics — only layout and cross-position
traffic — so every rule has a divisibility-checked preference list with
a safe fallback, letting one policy serve all 10 architectures:

  * embeddings / lm_head:       vocab -> model
  * attention q/o projections:  heads -> model, else head_dim, else d_model
  * attention k/v projections:  kv_heads -> model, else head_dim, else d
  * dense FFN:                  hidden  -> model
  * MoE experts:                expert  -> model (expert parallelism)
  * RG-LRU / xLSTM inner dims:  width   -> model
  * norms / biases / gates:     replicated
  * batch:                      (pod, data); long-context decode shards the
                                KV-cache sequence dim on data instead
  * optimizer moments:          mirror the parameter specs

Stacked parameters carry a leading n_cycles axis: specs are computed on
shape[1:] and prefixed with None (detected via the "cycles" path entry).

A spec is the port's :func:`~repro_torch.sharding.mesh.P`, a plain tuple
with one entry per leading dim (an axis name, a tuple of names, or None).
The functions read only ``mesh.shape`` (a dict from axis name to size),
so any object with such a ``shape`` serves, a
:class:`~repro_torch.launch.mesh.DeviceMesh` or a stand-in.  Trees are the
port's: nested dicts, tuples, lists and named tuples, each leaf anything
with a ``shape`` (a tensor; a ``meta`` tensor stands in for
``jax.ShapeDtypeStruct``).  The specs equal the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.sharding.mesh import P


# --------------------------------------------------------------- helpers
def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def _fits(dim: int, mesh, axis: str) -> bool:
    n = _axis_size(mesh, axis)
    return n > 1 and dim % n == 0


def spec_fits(spec: tuple, shape: tuple[int, ...], mesh, *,
              require_multi: bool = False) -> bool:
    """Divisibility check for a spec against a concrete shape: every
    sharded dim must divide its mesh-axis product.  With
    ``require_multi`` a spec naming any size-1 axis is rejected too
    (used by the param rules, which want a REAL shard or a clean
    fallback).  Shared by the param policy and the activation-hint
    context (`ctx.constrain`), so the two can never disagree on what
    "fits" means."""
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([_axis_size(mesh, a) for a in axes]))
        if n > 1 and dim % n != 0:
            return False
        if require_multi and any(_axis_size(mesh, a) == 1 for a in axes):
            return False
    return True


def is_spec(x) -> bool:
    """A spec: a plain tuple whose entries are None, an axis name or a
    tuple of names (the named tuples and tuples of subtrees of a tree
    are not)."""
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = (),
                       is_leaf: Callable = lambda x: False) -> Any:
    """``fn(path_names, leaf)`` over a tree of dicts, tuples, lists and
    named tuples (None holds no leaf), keeping its structure.  Path names
    are the reference's: a dict key as ``str``, a sequence index as
    ``"[i]"``, a named tuple's field as ``".field"``."""
    if is_leaf(tree):
        return fn(list(path), tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map_with_path(fn, v, path + (str(k),),
                                                 is_leaf))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f".{f}",),
                                               is_leaf)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (f"[{i}]",),
                                             is_leaf)
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


# ------------------------------------------------------------- layouts
def choose_layout(cfg, mesh, shape_cfg) -> str:
    """"hybrid" (TP over `model` + DP/FSDP over `data`) vs "dp" (the model
    axis JOINS data parallelism: pure FSDP over every position, no
    per-layer activation all-reduces).

    dp is chosen when (a) the global batch divides the full position
    count, (b) sharded optimizer state is comfortably small, and (c) a
    single sample's attention scores fit next to the activations
    (plain-attention training at b_local=1).
    """
    n_dev = int(np.prod(list(mesh.shape.values())))
    if shape_cfg.kind != "train" or shape_cfg.global_batch % n_dev:
        return "hybrid"
    state_bytes = _rough_param_bytes(cfg) * 3       # fp32 params + mu + nu
    if state_bytes / n_dev > 2 * 2**30:
        return "hybrid"
    score_bytes = cfg.n_heads * shape_cfg.seq_len ** 2 * 4
    if score_bytes > 4 * 2**30:
        return "hybrid"
    return "dp"


def _rough_param_bytes(cfg) -> float:
    d, L = cfg.d_model, cfg.n_layers
    per_layer = 4 * d * cfg.n_heads * (cfg.head_dim or d // cfg.n_heads)
    per_layer += 3 * d * max(cfg.d_ff, int(d * cfg.xlstm_proj_factor))
    per_layer += 3 * cfg.n_experts * d * cfg.moe_dff
    total = L * per_layer + 2 * cfg.vocab_size * d
    return total * 4.0


# ---------------------------------------------------------- param rules
def param_spec(path_names: list[str], shape: tuple[int, ...], mesh) -> tuple:
    stacked = any("cycles" in n for n in path_names)
    eff = shape[1:] if stacked and len(shape) >= 2 else shape
    name = path_names[-1] if path_names else ""
    spec = _param_spec_inner(name, path_names, eff, mesh)
    if stacked and len(shape) >= 2:
        spec = P(None, *spec)
    return spec


def _param_spec_inner(name: str, path: list[str], shape: tuple[int, ...],
                      mesh) -> tuple:
    nd = len(shape)
    if nd <= 1:
        return P()                                           # norms, biases
    if name == "embed":
        return P("model", None) if _fits(shape[0], mesh, "model") else P()
    if name == "lm_head":
        return P(None, "model") if _fits(shape[1], mesh, "model") else P()
    in_moe = any(n in ("moe",) for n in path)
    if in_moe and name in ("w_in", "w_out", "w_gate") and nd == 3:
        # (E, d, ff) / (E, ff, d): expert parallelism first
        for cand in (P("model", None, None),
                     P(None, None, "model") if name != "w_out" else P(None, "model", None),
                     P(None, "model", None) if name != "w_out" else P(None, None, "model")):
            if _spec_fits(cand, shape, mesh):
                return cand
        return P()
    if name in ("wq", "wk", "wv") and nd == 3:               # (d, heads, hd)
        # heads -> model when divisible; otherwise REPLICATE over model (FSDP
        # still shards over data).  Never shard the contraction/input dims.
        cand = P(None, "model", None)
        return cand if _spec_fits(cand, shape, mesh) else P()
    if name == "wo" and nd == 3:                             # (h, hd, d)
        cand = P("model", None, None)                        # Megatron row-par
        return cand if _spec_fits(cand, shape, mesh) else P()
    if name == "w_zifo" and nd == 4:                         # (d, 4, h, dh)
        for cand in (P(None, None, "model", None), P(None, None, None, "model"),
                     P("model", None, None, None)):
            if _spec_fits(cand, shape, mesh):
                return cand
        return P()
    if name == "r_zifo" and nd == 4:                         # (4, h, dh, dh)
        for cand in (P(None, "model", None, None), P(None, None, "model", None)):
            if _spec_fits(cand, shape, mesh):
                return cand
        return P()
    if nd == 2:
        # generic matmul weight (d_in, d_out): prefer output dim ("column
        # parallel"), except *_out / w_down / wo which prefer input dim
        prefer_in = name in ("w_out", "w_down", "w_mlp_out")
        cands = ([P("model", None), P(None, "model")] if prefer_in
                 else [P(None, "model"), P("model", None)])
        for cand in cands:
            if _spec_fits(cand, shape, mesh):
                return cand
        return P()
    if name == "conv_w":                                     # (cw, width)
        return P(None, "model") if _fits(shape[1], mesh, "model") else P()
    if nd == 3:
        for cand in (P(None, None, "model"), P(None, "model", None)):
            if _spec_fits(cand, shape, mesh):
                return cand
    return P()


def _spec_fits(spec: tuple, shape: tuple[int, ...], mesh) -> bool:
    return spec_fits(spec, shape, mesh, require_multi=True)


def _add_fsdp(spec: tuple, shape: tuple[int, ...], mesh,
              min_size: int = 2**20, axes: tuple[str, ...] = ("data",)) -> tuple:
    """Add an FSDP shard over `axes` on the first free, divisible dim
    (ZeRO-3 style).  Parameters and optimizer moments then occupy
    bytes / prod(axes x existing) per position; each layer's weight slice
    is gathered at use.  Tiny leaves (norms, biases) stay replicated."""
    if int(np.prod(shape)) < min_size:
        return spec
    used = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = int(np.prod([_axis_size(mesh, a) for a in axes]))
    if n <= 1:
        return spec
    # prefer the largest free dim
    order = sorted((i for i, ax in enumerate(used) if ax is None),
                   key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n == 0:
            new = list(used)
            new[i] = axes if len(axes) > 1 else axes[0]
            return P(*new)
    # split axes across two free dims if one dim cannot take the product
    if len(axes) == 2 and len(order) >= 2:
        a0, a1 = axes
        for i in order:
            if shape[i] % _axis_size(mesh, a0) == 0:
                for j in order:
                    if j != i and shape[j] % _axis_size(mesh, a1) == 0:
                        new = list(used)
                        new[i], new[j] = a0, a1
                        return P(*new)
    return spec


# weights consumed INSIDE a per-timestep loop: FSDP-sharding them would
# gather them EVERY timestep.  They are small — keep them replicated.
_SCAN_RESIDENT = ("r_zifo", "b_zifo")


def param_specs(params_shapes: Any, mesh, *, fsdp: bool = True,
                layout: str = "hybrid") -> Any:
    """Tree of specs matching a tree of tensors (``meta`` ones will do).

    layout="hybrid": TP rules + FSDP over `data` on stack weights.
    layout="dp":     no TP — everything FSDP over ("data", "model").

    FSDP is applied ONLY to layer-stack weights in the hybrid layout:
    sharding the embedding's d_model over `data` would collide with the
    batch's data sharding at the first gather."""
    def one(names, leaf):
        if layout == "dp":
            # EVERYTHING is FSDP over (data, model) — including embeddings
            if names[-1] in _SCAN_RESIDENT:
                return P()
            stacked = any("cycles" in n for n in names)
            eff = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
            spec = _add_fsdp(P(), eff, mesh, axes=("data", "model"))
            if stacked:
                spec = P(None, *spec)
            return spec
        spec = param_spec(names, tuple(leaf.shape), mesh)
        if (fsdp and "stack" in names
                and names[-1] not in ("embed", "lm_head") + _SCAN_RESIDENT):
            spec = _add_fsdp(spec, tuple(leaf.shape), mesh)
        return spec
    return tree_map_with_path(one, params_shapes)


def activation_rules(cfg, mesh, kind: str,
                     layout: str = "hybrid") -> dict[str, tuple]:
    """Activation sharding hints (DESIGN.md §6), read by `ctx.constrain`.

    * residual: pin the residual stream to batch-over-(pod,data) at every
      block boundary.
    * seq-parallel attention for head counts that do not divide the model
      axis: shard the query-seq dim of q/scores/attn-out over `model`.
    """
    if layout == "dp":
        all_axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
        return {"residual": P(all_axes, None, None)}
    baxes = batch_axes(mesh)
    rules: dict[str, tuple] = {}
    if baxes:
        rules["residual"] = P(baxes, None, None)        # (b, s, d)
    n_model = _axis_size(mesh, "model")
    if n_model > 1 and cfg.n_heads % n_model != 0:
        rules["attn_q"] = P(baxes, "model", None, None)        # (b, s, h, hd)
        rules["attn_scores"] = P(baxes, None, "model", None)   # (b, h, s, t)
        rules["attn_out"] = P(baxes, "model", None, None)      # (b, s, h, hd)
    return rules


# ----------------------------------------------------------- batch rules
def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_spec(batch_shapes: Any, mesh, *, global_batch: int,
               layout: str = "hybrid") -> Any:
    """tokens/labels (b, s) -> (pod,data) on b; embeds (b, s, d) likewise;
    mrope positions (3, b, s) on axis 1.  Falls back to replication when the
    batch does not divide the data axes (e.g. long_500k's batch=1)."""
    if layout == "dp":
        baxes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    else:
        baxes = batch_axes(mesh)
    bsize = int(np.prod([_axis_size(mesh, a) for a in baxes]))
    shard_batch = global_batch % bsize == 0 and bsize > 1

    def one(names, leaf):
        name = names[-1] if names else ""
        nd = len(leaf.shape)
        if not shard_batch:
            return P()
        if name == "positions" and nd == 3:
            return P(None, baxes, None)
        if name == "enc_embeds" or name == "inputs_embeds":
            return P(baxes, None, None)
        if nd >= 1 and leaf.shape[0] == global_batch:
            return P(baxes, *([None] * (nd - 1)))
        return P()

    return tree_map_with_path(one, batch_shapes)


# ----------------------------------------------------------- cache rules
def cache_spec(cache_shapes: Any, mesh, *, batch: int,
               seq_shard: bool = False) -> Any:
    """KV caches (b, len, m, hd) & recurrent states.

    seq_shard=True (long_500k, batch=1): shard the cache length dim over
    `data` and recurrent widths over `model`; otherwise batch over
    (pod, data) and KV length replicated."""
    baxes = batch_axes(mesh)
    bsize = int(np.prod([_axis_size(mesh, a) for a in baxes]))

    def one(names, leaf):
        shape = tuple(leaf.shape)
        stacked = any("cycles" in n for n in names)
        eff = shape[1:] if stacked else shape
        pre = (None,) if stacked else ()
        if len(eff) == 0:
            return P()
        if not seq_shard and batch % bsize == 0 and bsize > 1 and eff[0] == batch:
            spec = [baxes] + [None] * (len(eff) - 1)
            # KV caches (b, L, m, hd): also shard kv-heads (else head_dim)
            # over model — a long cache replicated over the model axis
            # costs model-size times the memory.
            if len(eff) == 4:
                if _fits(eff[2], mesh, "model"):
                    spec[2] = "model"
                elif _fits(eff[3], mesh, "model"):
                    spec[3] = "model"
            elif len(eff) >= 2 and _fits(eff[-1], mesh, "model"):
                spec[-1] = "model"      # recurrent state width
            return P(*pre, *spec)
        if seq_shard:
            # (b, L, m, hd): L -> data when divisible; recurrent (b, w): w -> model
            if len(eff) == 4 and _fits(eff[1], mesh, "data"):
                spec = [None, "data", None, None]
                if _fits(eff[2], mesh, "model"):
                    spec[2] = "model"
                elif _fits(eff[3], mesh, "model"):
                    spec[3] = "model"
                return P(*pre, *spec)
            if len(eff) >= 2 and _fits(eff[-1], mesh, "model"):
                return P(*pre, *([None] * (len(eff) - 1)), "model")
        return P(*pre, *([None] * len(eff)))

    return tree_map_with_path(one, cache_shapes)


# ------------------------------------------------------------- optimizer
def opt_specs(pspecs: Any) -> Any:
    """Moments mirror parameter specs; the scalar step is replicated."""
    from repro_torch.optim.adamw import OptState
    return OptState(mu=pspecs, nu=pspecs, step=P())


def named(tree_specs: Any, mesh) -> Any:
    """Each spec of ``tree_specs`` as a
    :class:`~repro_torch.sharding.place.NamedSharding` on ``mesh``, the
    record :func:`~repro_torch.sharding.place.place` consumes."""
    from repro_torch.sharding.place import NamedSharding
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s),
                              tree_specs, is_leaf=is_spec)


__all__ = ["spec_fits", "is_spec", "tree_map_with_path", "choose_layout",
           "param_spec", "param_specs", "activation_rules", "batch_axes",
           "batch_spec", "cache_spec", "opt_specs", "named"]
