"""Attention of the port (``repro.models.attention`` in the reference):
GQA/MQA/MHA, global and sliding-window, self and cross, with KV caches
(append cache for global, ring buffer for windowed layers).

Numerics: logits are a bf16 product cast to fp32, softmax in fp32,
probabilities cast to the values' dtype, values in bf16 — the reference's
cast points.  Cache updates return new tensors, as the reference's
``dynamic_update_slice`` does, so a cache handed back by one call is never
changed by a later one.  The sharding hints of the reference
(``sharding.ctx.constrain`` on q, the scores and the output) sit where
the reference has them; they return a plain tensor as it is, since under
a (data, model) mesh the executor (``repro_torch.sharding.blocks``)
hands this module each position's piece already laid out: its query
heads (and KV heads, or the KV heads they read), or its query rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import ctx as shctx

from .flash import flash_attention
from .layers import (COMPUTE_DTYPE, PARAM_DTYPE, apply_rope, dense_init,
                     rms_head_norm)

NEG_INF = -1e30

# Attention without a validity mask or query chunking switches to the
# flash forward (models/flash.py) at this many score elements: it never
# materializes the (sq, sk) buffer.  Small shapes keep the exact
# materializing path.
FLASH_MIN_ELEMS = 2 ** 28


# ----------------------------------------------------------------- params
def init_attention(cfg, gen, *, cross: bool = False, device=None) -> dict:
    """Projections; qk-norm scales when ``cfg.qk_norm``, except for
    cross-attention, which has none (as in the reference)."""
    d, h, m, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, hd), device=device),
        "wk": dense_init(gen, (d, m, hd), device=device),
        "wv": dense_init(gen, (d, m, hd), device=device),
        "wo": dense_init(gen, (h, hd, d), scale=(h * hd) ** -0.5,
                         device=device),
    }
    if cfg.qk_norm and not cross:
        p["q_scale"] = torch.ones((hd,), dtype=PARAM_DTYPE, device=device)
        p["k_scale"] = torch.ones((hd,), dtype=PARAM_DTYPE, device=device)
    return p


# -------------------------------------------------------------- projections
def project_q(cfg, params, x, cos, sin):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    if "q_scale" in params:
        q = rms_head_norm(q, params["q_scale"], cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
    return q


def project_kv(cfg, params, x, cos, sin):
    k = torch.einsum("bsd,dmk->bsmk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dmk->bsmk", x, params["wv"].to(x.dtype))
    if "k_scale" in params:
        k = rms_head_norm(k, params["k_scale"], cfg.norm_eps)
    if cos is not None:
        k = apply_rope(k, cos, sin)
    return k, v


def out_proj(params, o):
    return torch.einsum("bshk,hkd->bsd", o, params["wo"].to(o.dtype))


# ---------------------------------------------------------------- core math
def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int],
               k_valid=None) -> torch.Tensor:
    """(b, sq, sk) additive fp32 bias from absolute positions."""
    d = q_pos[:, :, None] - k_pos[:, None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def _repeat_kv(k, v, h: int):
    """k/v from m to h heads, each kv head repeated h/m times in place
    (``jnp.repeat`` along the head axis)."""
    m = k.shape[2]
    if m == h:
        return k, v
    return (torch.repeat_interleave(k, h // m, dim=2),
            torch.repeat_interleave(v, h // m, dim=2))


def _sdpa(q, k, v, bias):
    """q: (b,sq,h,hd)  k/v: (b,sk,m,hd)  bias: (b,sq,sk) -> (b,sq,h,hd)."""
    hd = q.shape[-1]
    k, v = _repeat_kv(k, v, q.shape[2])
    q = shctx.constrain(q, "attn_q")          # seq-parallel hint (policy)
    logits = torch.einsum("bshk,bthk->bhst", q, k).float()
    logits = shctx.constrain(logits, "attn_scores")
    logits = logits * (hd ** -0.5) + bias[:, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhst,bthk->bshk", probs, v)
    return shctx.constrain(o, "attn_out")


def attention(cfg, q, k, v, *, q_pos, k_pos, causal=True, window=None,
              k_valid=None, q_chunk: Optional[int] = None):
    """Masked GQA attention.  If q_chunk is set, loop over query chunks
    (prefill path: bounds live score memory to (b, h, q_chunk, sk))."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if (k_valid is None and q_chunk is None
            and b * h * sq * sk >= FLASH_MIN_ELEMS and sq > 1):
        k, v = _repeat_kv(k, v, h)
        o = flash_attention(shctx.constrain(q, "attn_q"), k, v, q_pos, k_pos,
                            causal, window, 1024)
        return shctx.constrain(o, "attn_out")
    if q_chunk is None or sq <= q_chunk:
        return _sdpa(q, k, v, _mask_bias(q_pos, k_pos, causal=causal,
                                         window=window, k_valid=k_valid))
    if sq % q_chunk:
        raise ValueError(f"query length {sq} is not a multiple of q_chunk "
                         f"{q_chunk}")
    outs = []
    for i in range(0, sq, q_chunk):
        pi = q_pos[:, i:i + q_chunk]
        bias = _mask_bias(pi, k_pos, causal=causal, window=window,
                          k_valid=k_valid)
        outs.append(_sdpa(q[:, i:i + q_chunk], k, v, bias))
    return torch.cat(outs, dim=1)


# -------------------------------------------------------------------- caches
def init_global_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    m, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, m, hd), dtype=COMPUTE_DTYPE,
                         device=device),
        "v": torch.zeros((batch, max_len, m, hd), dtype=COMPUTE_DTYPE,
                         device=device),
    }


def init_window_cache(cfg, batch: int, device=None) -> dict:
    m, hd, w = cfg.n_kv_heads, cfg.head_dim, cfg.window_size
    return {
        "k": torch.zeros((batch, w, m, hd), dtype=COMPUTE_DTYPE,
                         device=device),
        "v": torch.zeros((batch, w, m, hd), dtype=COMPUTE_DTYPE,
                         device=device),
    }


def _write(buf: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """A copy of ``buf`` with ``new`` written at [start, start + len) of
    axis 1; the start is clamped so the write fits, as
    ``dynamic_update_slice`` clamps it."""
    start = max(0, min(int(start), buf.shape[1] - new.shape[1]))
    return torch.slice_scatter(buf, new.to(buf.dtype), dim=1, start=start,
                               end=start + new.shape[1])


def global_cache_update(cache: dict, k_new, v_new, pos) -> dict:
    """Write s_new entries at [pos, pos+s_new)."""
    return {"k": _write(cache["k"], k_new, pos),
            "v": _write(cache["v"], v_new, pos)}


def window_cache_update(cache: dict, k_new, v_new, pos) -> dict:
    """Ring-buffer write of ONE token at slot pos % W (decode path)."""
    slot = int(pos) % cache["k"].shape[1]
    return {"k": _write(cache["k"], k_new, slot),
            "v": _write(cache["v"], v_new, slot)}


def window_slot_positions(pos, w: int, device=None) -> torch.Tensor:
    """Absolute position of the latest write in each ring slot, given that
    the token at `pos` has just been written: slot s holds position
    pos - ((pos - s) mod W); slots never written are masked by the caller
    via position > pos or < 0 checks."""
    s = torch.arange(w, dtype=torch.int32, device=device)
    return int(pos) - torch.remainder(int(pos) - s, w)  # non-negative mod


def prefill_to_window_cache(cfg, k_full, v_full, seq_len: int) -> dict:
    """Convert full-length prefill K/V into the ring buffer holding the last
    W positions, laid out so slot s holds absolute position p with
    p % W == s."""
    w = cfg.window_size
    b, s, m, hd = k_full.shape
    if s < w:
        pad = k_full.new_zeros((b, w - s, m, hd))
        return {"k": torch.cat([k_full, pad], 1),
                "v": torch.cat([v_full, pad.to(v_full.dtype)], 1)}
    # absolute positions s-w .. s-1 ; slot of position p is p % W
    roll = (s - w) % w
    return {"k": torch.roll(k_full[:, s - w:], roll, dims=1),
            "v": torch.roll(v_full[:, s - w:], roll, dims=1)}
