"""Block assembly and the layer stack of the port
(``repro.models.transformer`` in the reference).

The layer pattern (cfg.layer_pattern) is cycled to n_layers.  Full cycles
are STACKED, each leaf on a leading n_cycles axis, as in the reference,
so parameter trees are the same tree; where the reference runs them
under one ``lax.scan``, the port loops over the cycles.  Remainder layers
are ``rem_{r}``.

Modes: "train" (no cache), "prefill" (build cache), "decode" (consume
cache, s == 1).  Caches mirror the parameter stacking.  In "train" mode
with ``remat=True`` each cycle runs under
``torch.utils.checkpoint.checkpoint`` (the reference's
``jax.checkpoint(cycle_body)``): its activations are recomputed in the
backward instead of kept.

Ported block kinds: "ga" (global attention + dense FFN) and "la"
(sliding-window attention + dense FFN).  The MoE, recurrent, xLSTM and
encoder-decoder kinds raise NotImplementedError (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import ffn as ffn_mod
from .layers import apply_norm, init_norm

PORTED_KINDS = ("ga", "la")
UNPORTED_KINDS = ("gm", "rg", "ml", "sl", "enc")


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""
    mode: str                       # train | prefill | decode
    cos: Optional[torch.Tensor]     # rotary angles for current positions
    sin: Optional[torch.Tensor]
    q_pos: torch.Tensor             # (b, s) absolute positions of the inputs
    pos: Optional[int]              # decode write offset
    max_len: int                    # global-attn cache capacity (decode)
    q_chunk: Optional[int] = None   # prefill attention chunking


def _check_kind(cfg, kind: str, decoder: bool = False) -> None:
    if kind not in PORTED_KINDS + UNPORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind in UNPORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: ROADMAP A13 (the port "
            f"runs the kinds {PORTED_KINDS})")
    if decoder and cfg.is_encoder_decoder:
        raise NotImplementedError(
            "cross-attention (encoder-decoder) is not ported yet: ROADMAP A13")


def _stack_trees(trees: list) -> Any:
    """Trees of equal structure -> one tree, each leaf stacked on axis 0."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in t0}
    return torch.stack(trees)


def _index_tree(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------- block: init
def init_block(cfg, gen, kind: str, *, decoder: bool = False,
               device=None) -> dict:
    _check_kind(cfg, kind, decoder)
    d = cfg.d_model
    return {"norm1": init_norm(cfg, d, device),
            "attn": attn.init_attention(cfg, gen, device=device),
            "norm2": init_norm(cfg, d, device),
            "ffn": ffn_mod.init_ffn(cfg, gen, device=device)}


def init_block_cache(cfg, kind: str, batch: int, max_len: int,
                     *, decoder: bool = False, device=None) -> dict:
    _check_kind(cfg, kind, decoder)
    if kind == "la":
        return attn.init_window_cache(cfg, batch, device)
    return attn.init_global_cache(cfg, batch, max_len, device)


# ------------------------------------------------------------ block: apply
def _self_attention_sublayer(cfg, p, x, kind, ctx: Ctx, cache):
    h = apply_norm(cfg, p["norm1"], x)
    window = cfg.window_size if kind == "la" else None
    q = attn.project_q(cfg, p["attn"], h, ctx.cos, ctx.sin)
    k_new, v_new = attn.project_kv(cfg, p["attn"], h, ctx.cos, ctx.sin)
    new_cache = cache
    b, dev = x.shape[0], x.device
    if ctx.mode == "decode":
        # Mask against the cache in ABSOLUTE slot coordinates: the query
        # side is the write position ctx.pos, not the rope stream position
        # (they differ once M-RoPE image tokens share a t).
        q_pos = torch.full((b, x.shape[1]), int(ctx.pos), dtype=torch.int32,
                           device=dev)
        if kind == "la":
            new_cache = {**cache,
                         **attn.window_cache_update(cache, k_new, v_new,
                                                    ctx.pos)}
            w = cfg.window_size
            slot_pos = attn.window_slot_positions(ctx.pos, w, dev)   # (W,)
            k_pos = slot_pos[None].expand(b, w)
            k_valid = ((slot_pos >= 0) & (slot_pos <= ctx.pos))[None].expand(
                b, w)
        else:
            new_cache = {**cache,
                         **attn.global_cache_update(cache, k_new, v_new,
                                                    ctx.pos)}
            t = torch.arange(ctx.max_len, dtype=torch.int32, device=dev)
            k_pos = t[None].expand(b, ctx.max_len)
            k_valid = (t <= ctx.pos)[None].expand(b, ctx.max_len)
        o = attn.attention(cfg, q, new_cache["k"], new_cache["v"],
                           q_pos=q_pos, k_pos=k_pos, causal=True,
                           window=window, k_valid=k_valid)
    else:
        o = attn.attention(cfg, q, k_new, v_new, q_pos=ctx.q_pos,
                           k_pos=ctx.q_pos, causal=True, window=window,
                           q_chunk=ctx.q_chunk)
        if ctx.mode == "prefill" and cache is not None:
            if kind == "la":
                ring = attn.prefill_to_window_cache(cfg, k_new, v_new,
                                                    x.shape[1])
                new_cache = {**cache, **ring}
            else:
                new_cache = {**cache,
                             **attn.global_cache_update(cache, k_new, v_new,
                                                        0)}
    return x + attn.out_proj(p["attn"], o), new_cache


def apply_block(cfg, p, kind: str, x, ctx: Ctx, cache=None,
                *, decoder: bool = False):
    """Returns (x, new_cache, aux); aux is 0 for the ported kinds."""
    _check_kind(cfg, kind, decoder)
    x, cache = _self_attention_sublayer(cfg, p, x, kind, ctx, cache)
    h = apply_norm(cfg, p["norm2"], x)
    f = ffn_mod.apply_ffn(cfg, p["ffn"], h)
    return x + f, cache, torch.zeros((), dtype=torch.float32,
                                     device=x.device)


# ----------------------------------------------------------- stack: init
def init_stack(cfg, gen, *, decoder: bool = False, device=None) -> dict:
    n_cycles, rem = cfg.cycles()
    pattern = cfg.layer_pattern
    params: dict = {}
    if n_cycles > 0:
        params["cycles"] = tuple(
            _stack_trees([init_block(cfg, gen, kind, decoder=decoder,
                                     device=device)
                          for _ in range(n_cycles)])
            for kind in pattern)
    for r in range(rem):
        params[f"rem_{r}"] = init_block(cfg, gen, pattern[r],
                                        decoder=decoder, device=device)
    return params


def init_stack_cache(cfg, batch: int, max_len: int, *, decoder: bool = False,
                     device=None) -> dict:
    n_cycles, rem = cfg.cycles()
    pattern = cfg.layer_pattern
    cache: dict = {}
    if n_cycles > 0:
        cache["cycles"] = tuple(
            _stack_trees([init_block_cache(cfg, kind, batch, max_len,
                                           decoder=decoder, device=device)
                          for _ in range(n_cycles)])
            for kind in pattern)
    for r in range(rem):
        cache[f"rem_{r}"] = init_block_cache(cfg, pattern[r], batch, max_len,
                                             decoder=decoder, device=device)
    return cache


# ---------------------------------------------------------- stack: apply
def apply_stack(cfg, params: dict, x, ctx: Ctx, cache: Optional[dict] = None,
                *, decoder: bool = False, remat: bool = True):
    """Returns (x, new_cache_or_None, aux_sum)."""
    n_cycles, rem = cfg.cycles()
    pattern = cfg.layer_pattern
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {}

    def cycle(xc, aux, c: int):
        caches = []
        for j, kind in enumerate(pattern):
            cj = None if cache is None else _index_tree(cache["cycles"][j], c)
            xc, cj_new, a = apply_block(
                cfg, _index_tree(params["cycles"][j], c), kind, xc, ctx, cj,
                decoder=decoder)
            aux = aux + a
            caches.append(cj_new)
        return xc, aux, caches

    if n_cycles > 0:
        per_cycle = []
        for c in range(n_cycles):
            if remat and ctx.mode == "train":
                x, aux_total, caches = checkpoint(cycle, x, aux_total, c,
                                                  use_reentrant=False)
            else:
                x, aux_total, caches = cycle(x, aux_total, c)
            per_cycle.append(caches)
        if cache is not None:
            new_cache["cycles"] = tuple(
                _stack_trees([caches[j] for caches in per_cycle])
                for j in range(len(pattern)))

    for r in range(rem):
        kind = pattern[r]
        cj = None if cache is None else cache[f"rem_{r}"]
        x, cj_new, a = apply_block(cfg, params[f"rem_{r}"], kind, x, ctx, cj,
                                   decoder=decoder)
        aux_total = aux_total + a
        if cache is not None:
            new_cache[f"rem_{r}"] = cj_new

    return x, (new_cache if cache is not None else None), aux_total
