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
``jax.checkpoint(cycle_body)``), or under a mesh ``parallel.remat``: its
activations are recomputed in the backward instead of kept.

Block kinds: "ga" / "la" (global / sliding-window attention + dense
FFN), "gm" (global attention + MoE FFN), "rg" (Griffin RG-LRU + dense
FFN), "ml" / "sl" (xLSTM mLSTM / sLSTM) and "enc" (bidirectional
attention + dense FFN, the encoder's).  With ``decoder=True`` an
encoder-decoder config's attention blocks also get a cross-attention
sublayer over ``Ctx.enc_out``.

In "train" mode without a cache, full cycles start their recurrent
blocks from a ZERO state (the reference's ``_train_cache_stub``, whose
mLSTM / sLSTM stabiliser m is 0), while remainder layers get None and so
start from ``init_*_cache``'s (m = -1e9).  The stabiliser cancels in
exact arithmetic but not in rounding (``max(|den|, exp(-m))`` picks its
branch at another scale), so the port keeps both starts as they are.

Under a (data, model) mesh (``Ctx.run`` set; parameters, caches and the
residual stream are ``Sharded``) each block is handed to
``repro_torch.sharding.parallel.apply_block``, which runs the code below
on each position's piece.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import parallel, place

from . import attention as attn
from . import ffn as ffn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import xlstm as xlstm_mod
from .layers import apply_norm, init_norm


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""
    mode: str                       # train | prefill | decode
    cos: Optional[torch.Tensor]     # rotary angles for current positions
    sin: Optional[torch.Tensor]
    q_pos: torch.Tensor             # (b, s) absolute positions of the inputs
    pos: Optional[int]              # decode write offset
    max_len: int                    # global-attn cache capacity (decode)
    enc_out: Optional[torch.Tensor] = None   # encoder hidden states (enc-dec)
    q_chunk: Optional[int] = None   # prefill attention chunking
    run: Any = None                 # sharding.parallel.MeshRun under a mesh


ATTN_KINDS = ("ga", "la", "gm", "enc")


def _has_cross(cfg, kind: str, decoder: bool) -> bool:
    return decoder and cfg.is_encoder_decoder and kind != "enc"


def _stack_trees(trees: list) -> Any:
    """Trees of equal structure -> one tree, each leaf stacked on axis 0."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, place.Sharded):
        return place.stack(trees)
    return torch.stack(trees)


def _index_tree(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------- block: init
def init_block(cfg, gen, kind: str, *, decoder: bool = False,
               device=None) -> dict:
    d = cfg.d_model
    if kind in ATTN_KINDS:
        p = {"norm1": init_norm(cfg, d, device),
             "attn": attn.init_attention(cfg, gen, device=device),
             "norm2": init_norm(cfg, d, device)}
        if kind == "gm":
            p["moe"] = moe_mod.init_moe(cfg, gen, device=device)
        else:
            p["ffn"] = ffn_mod.init_ffn(cfg, gen, device=device)
        if _has_cross(cfg, kind, decoder):
            p["cross_norm"] = init_norm(cfg, d, device)
            p["cross"] = attn.init_attention(cfg, gen, cross=True,
                                             device=device)
        return p
    if kind == "rg":
        return {"norm1": init_norm(cfg, d, device),
                "rglru": rglru_mod.init_rglru_block(cfg, gen, device=device),
                "norm2": init_norm(cfg, d, device),
                "ffn": ffn_mod.init_ffn(cfg, gen, device=device)}
    if kind == "ml":
        return {"norm1": init_norm(cfg, d, device),
                "mlstm": xlstm_mod.init_mlstm_block(cfg, gen, device=device)}
    if kind == "sl":
        return {"norm1": init_norm(cfg, d, device),
                "slstm": xlstm_mod.init_slstm_block(cfg, gen, device=device)}
    raise ValueError(f"unknown block kind {kind!r}")


_RECURRENT_CACHES = {"rg": rglru_mod.init_rglru_cache,
                     "ml": xlstm_mod.init_mlstm_cache,
                     "sl": xlstm_mod.init_slstm_cache}


def init_block_cache(cfg, kind: str, batch: int, max_len: int,
                     *, decoder: bool = False, device=None) -> dict:
    if kind in ("ga", "gm", "enc"):
        c = attn.init_global_cache(cfg, batch, max_len, device)
    elif kind == "la":
        c = attn.init_window_cache(cfg, batch, device)
    elif kind in _RECURRENT_CACHES:
        c = _RECURRENT_CACHES[kind](cfg, batch, device)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if _has_cross(cfg, kind, decoder):
        shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        c["ck"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
        c["cv"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return c


def _train_cache_stub(cfg, kind: str, batch: int, device):
    """A full cycle's initial state of one block in train mode without a
    cache: zeros of the recurrent kinds' cache leaves (m included), None
    for the attention kinds, whose train path reads no cache."""
    if kind not in _RECURRENT_CACHES:
        return None
    return {k: torch.zeros_like(v) for k, v in
            _RECURRENT_CACHES[kind](cfg, batch, device).items()}


# ------------------------------------------------------------ block: apply
def _self_attention_sublayer(cfg, p, x, kind, ctx: Ctx, cache):
    h = apply_norm(cfg, p["norm1"], x)
    o, new_cache = self_attention(cfg, p["attn"], h, kind, ctx, cache)
    return x + o, new_cache


@dataclasses.dataclass
class KV:
    """What a block's queries attend to: keys and values (b, sk, m, hd),
    the masking of :func:`attention.attention` and the new cache."""
    k: torch.Tensor
    v: torch.Tensor
    q_pos: torch.Tensor
    k_pos: torch.Tensor
    causal: bool
    window: Optional[int]
    k_valid: Optional[torch.Tensor]
    q_chunk: Optional[int]
    cache: Any


def attend(cfg, q, kv: KV) -> torch.Tensor:
    return attn.attention(cfg, q, kv.k, kv.v, q_pos=kv.q_pos, k_pos=kv.k_pos,
                          causal=kv.causal, window=kv.window,
                          k_valid=kv.k_valid, q_chunk=kv.q_chunk)


def self_kv(cfg, pa, h, kind, ctx: Ctx, cache) -> KV:
    """The keys and values of normed ``h`` (decode: the updated cache's)
    and the new cache.  Head counts are read from the weights."""
    causal = kind != "enc"
    window = cfg.window_size if kind == "la" else None
    k_new, v_new = attn.project_kv(cfg, pa, h, ctx.cos, ctx.sin)
    new_cache = cache
    b, dev = h.shape[0], h.device
    if ctx.mode == "decode":
        # Mask against the cache in ABSOLUTE slot coordinates: the query
        # side is the write position ctx.pos, not the rope stream position
        # (they differ once M-RoPE image tokens share a t).
        q_pos = torch.full((b, h.shape[1]), int(ctx.pos), dtype=torch.int32,
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
        return KV(new_cache["k"], new_cache["v"], q_pos, k_pos, causal,
                  window, k_valid, None, new_cache)
    if ctx.mode == "prefill" and cache is not None:
        if kind == "la":
            ring = attn.prefill_to_window_cache(cfg, k_new, v_new, h.shape[1])
            new_cache = {**cache, **ring}
        else:
            new_cache = {**cache,
                         **attn.global_cache_update(cache, k_new, v_new, 0)}
    return KV(k_new, v_new, ctx.q_pos, ctx.q_pos, causal, window, None,
              ctx.q_chunk, new_cache)


def self_attention(cfg, pa, h, kind, ctx: Ctx, cache):
    """The self-attention of normed ``h`` with the attention parameters
    ``pa``, projected out (b, s, d), and the new cache.  Head counts are
    read from the weights, so a model-axis position runs it on its own
    heads and returns its partial sum."""
    q = attn.project_q(cfg, pa, h, ctx.cos, ctx.sin)
    kv = self_kv(cfg, pa, h, kind, ctx, cache)
    return attn.out_proj(pa, attend(cfg, q, kv)), kv.cache


def cross_q(cfg, pc, h, ctx: Ctx):
    return attn.project_q(cfg, pc, h, None, None)      # no rope on cross


def cross_kv(cfg, pc, h, ctx: Ctx, cache) -> KV:
    """The encoder's keys and values for the decoder's queries ``h``: no
    rope, not causal, query positions 0.  Prefill projects them into the
    cache's ``ck`` / ``cv``; decode reads them."""
    new_cache = cache
    if ctx.mode == "decode":
        ck, cv = cache["ck"], cache["cv"]
    else:
        ck, cv = attn.project_kv(cfg, pc, ctx.enc_out, None, None)
        if ctx.mode == "prefill" and cache is not None:
            new_cache = {**cache, "ck": ck.to(cache["ck"].dtype),
                         "cv": cv.to(cache["cv"].dtype)}
    b, t = h.shape[0], ck.shape[1]
    k_pos = torch.arange(t, dtype=torch.int32, device=h.device)[None].expand(
        b, t)
    return KV(ck, cv, torch.zeros_like(ctx.q_pos), k_pos, False, None, None,
              ctx.q_chunk, new_cache)


def cross_attention(cfg, pc, h, ctx: Ctx, cache):
    """Attention of the decoder's normed ``h`` over the encoder's output
    (:func:`cross_kv`), projected out, and the new cache."""
    kv = cross_kv(cfg, pc, h, ctx, cache)
    return attn.out_proj(pc, attend(cfg, cross_q(cfg, pc, h, ctx), kv)), \
        kv.cache


def _cross_attention_sublayer(cfg, p, x, ctx: Ctx, cache):
    h = apply_norm(cfg, p["cross_norm"], x)
    o, new_cache = cross_attention(cfg, p["cross"], h, ctx, cache)
    return x + o, new_cache


def apply_block(cfg, p, kind: str, x, ctx: Ctx, cache=None,
                *, decoder: bool = False):
    """Returns (x, new_cache, aux); aux is the MoE's load-balancing loss
    for "gm" and 0 otherwise."""
    x = shctx.constrain(x, "residual")
    if isinstance(x, place.Sharded):
        return parallel.apply_block(cfg, p, kind, x, ctx, cache,
                                    decoder=decoder)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ATTN_KINDS:
        x, cache = _self_attention_sublayer(cfg, p, x, kind, ctx, cache)
        if _has_cross(cfg, kind, decoder):
            x, cache = _cross_attention_sublayer(cfg, p, x, ctx, cache)
        h = apply_norm(cfg, p["norm2"], x)
        if kind == "gm":
            f, aux = moe_mod.apply_moe(cfg, p["moe"], h)
        else:
            f = ffn_mod.apply_ffn(cfg, p["ffn"], h)
        return x + f, cache, aux
    if kind == "rg":
        h = apply_norm(cfg, p["norm1"], x)
        o, new_rec = rglru_mod.apply_rglru_block(cfg, p["rglru"], h,
                                                 cache=cache, pos=ctx.pos)
        x = x + o
        h2 = apply_norm(cfg, p["norm2"], x)
        return x + ffn_mod.apply_ffn(cfg, p["ffn"], h2), new_rec, aux
    if kind in ("ml", "sl"):
        h = apply_norm(cfg, p["norm1"], x)
        apply = (xlstm_mod.apply_mlstm_block if kind == "ml"
                 else xlstm_mod.apply_slstm_block)
        o, new_state = apply(cfg, p["mlstm" if kind == "ml" else "slstm"], h,
                             cache=cache, pos=ctx.pos)
        return x + o, new_state, aux
    raise ValueError(f"unknown block kind {kind!r}")


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
    """The stack's caches.  As in the reference, every leaf of the full
    cycles' stacked caches is ZERO (an mLSTM / sLSTM stabiliser m
    included), while remainder layers get ``init_block_cache``'s values
    (m = -1e9)."""
    n_cycles, rem = cfg.cycles()
    pattern = cfg.layer_pattern
    cache: dict = {}
    if n_cycles > 0:
        cache["cycles"] = tuple(
            {k: v.new_zeros((n_cycles,) + tuple(v.shape))
             for k, v in init_block_cache(cfg, kind, batch, max_len,
                                          decoder=decoder,
                                          device=device).items()}
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

    def cycle(xc, aux, c: int, cycles, ctx: Ctx):
        caches = []
        for j, kind in enumerate(pattern):
            if cache is None:   # train: recurrent kinds start from zeros
                cj = _train_cache_stub(cfg, kind, x.shape[0], x.device)
            else:
                cj = _index_tree(cache["cycles"][j], c)
            xc, cj_new, a = apply_block(
                cfg, _index_tree(cycles[j], c), kind, xc, ctx, cj,
                decoder=decoder)
            aux = aux + a
            caches.append(cj_new)
        return xc, aux, caches

    if n_cycles > 0:
        per_cycle = []
        for c in range(n_cycles):
            if remat and ctx.mode == "train" and ctx.run is not None:
                x, aux_total, caches = parallel.remat(
                    cycle, x, aux_total, c, params["cycles"], ctx)
            elif remat and ctx.mode == "train":
                x, aux_total, caches = checkpoint(
                    cycle, x, aux_total, c, params["cycles"], ctx,
                    use_reentrant=False)
            else:
                x, aux_total, caches = cycle(x, aux_total, c,
                                             params["cycles"], ctx)
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
