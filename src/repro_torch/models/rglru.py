"""Griffin recurrent block of the port (``repro.models.rglru`` in the
reference): a temporal conv1d and the RG-LRU.

RG-LRU (arXiv:2402.19427 eq. 1-4):
    r_t = sigmoid(W_a x_t)                   (recurrence gate)
    i_t = sigmoid(W_x x_t)                   (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the recurrence as ``jax.lax.associative_scan``; torch
has no associative scan outside ``torch.compile``, so :func:`_lru_scan`
is a log-depth doubling (Hillis-Steele) scan over the sequence axis on
plain tensors: the same linear recurrence combined in another tree
order, equal to the reference's to fp32 rounding.  Decode carries
(conv_state bf16, h fp32) in the cache.  The block wraps the LRU with
the Griffin gated-linear-unit structure:
out = W_out( GELU(W_gate x) * LRU(conv1d(W_branch x)) ).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .layers import COMPUTE_DTYPE, PARAM_DTYPE, dense_init, gelu, sigmoid

_C = 8.0


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    """fp32 draws uniform in [lo, hi) from ``gen`` (a ``torch.Generator``
    on ``device`` or a numpy ``Generator``)."""
    if isinstance(gen, np.random.Generator):
        u = torch.from_numpy(gen.random(shape, dtype=np.float32)).to(device)
    else:
        u = torch.rand(shape, generator=gen, dtype=PARAM_DTYPE,
                       device=device)
    return u * (hi - lo) + lo


def init_rglru_block(cfg, gen, device=None) -> dict:
    d, w = cfg.d_model, cfg.rnn_width
    # Lambda init so that a^c in [0.9, 0.999] (griffin appendix)
    u = _uniform(gen, (w,), 0.9, 0.999, device)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log(u)/c)
    return {
        "w_branch": dense_init(gen, (d, w), device=device),
        "w_gate": dense_init(gen, (d, w), device=device),
        "conv_w": dense_init(gen, (cfg.conv_width, w),
                             scale=cfg.conv_width ** -0.5, device=device),
        "conv_b": torch.zeros((w,), dtype=PARAM_DTYPE, device=device),
        "wa": dense_init(gen, (w, w), device=device),
        "wx": dense_init(gen, (w, w), device=device),
        "lam": lam,
        "w_out": dense_init(gen, (w, d), device=device),
    }


def _causal_conv(params, x, state=None):
    """Depthwise causal conv1d of width cw.  x: (b, s, w); state:
    (b, cw-1, w) prior context (decode) or None (zero padding).  The taps
    are summed in bf16 in the reference's order.  Returns (out,
    new_state): the last cw-1 inputs, the next call's context."""
    cw = params["conv_w"].shape[0]
    wt = params["conv_w"].to(x.dtype)
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (b, s+cw-1, w)
    s = x.shape[1]
    out = xp[:, 0:s] * wt[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * wt[i]
    new_state = xp[:, xp.shape[1] - (cw - 1):]
    return out + params["conv_b"].to(x.dtype), new_state


def _rg_lru_gates(params, x, x_out=None):
    """(a, gated input) of the recurrence, fp32: the gates of ``x``
    (their columns that ``wa`` / ``wx`` hold) applied to ``x_out``, the
    same channels of the input (default x itself)."""
    xf = x.float()
    r = sigmoid(xf @ params["wa"].float())
    i = sigmoid(xf @ params["wx"].float())
    log_a = -_C * F.softplus(params["lam"]) * r               # (b, s, w)
    a = torch.exp(log_a)
    xo = xf if x_out is None else x_out.float()
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xo)
    return a, gated_x


def _lru_scan(a, gx, h0=None):
    """h_t = a_t h_{t-1} + gx_t over the sequence axis, as a doubling
    scan: after the pass with offset d, each position holds the
    composition of the (up to) 2d steps ending there.
    a, gx: (b, s, w) fp32; h0: (b, w) initial state or None."""
    if h0 is not None:
        gx = torch.cat([gx[:, :1] + a[:, :1] * h0[:, None], gx[:, 1:]], 1)
    s = a.shape[1]
    d = 1
    while d < s:
        # (a1, b1) earlier then (a2, b2) later -> (a1 a2, a2 b1 + b2)
        gx = torch.cat([gx[:, :d], a[:, d:] * gx[:, :-d] + gx[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return gx                                             # (b, s, w)


def apply_rglru_block(cfg, params, x, *, cache=None, pos=None):
    """x: (b, s, d).  Returns (out, new_cache).

    cache=None starts from the zero state; the returned cache carries
    (conv_state, h_last) for the next call.  Decode: cache={"conv":
    (b,cw-1,w), "h": (b,w)}, s may be 1."""
    gate = gelu(x @ params["w_gate"].to(x.dtype))
    branch = x @ params["w_branch"].to(x.dtype)
    conv_state = None if cache is None else cache["conv"]
    branch, new_conv = _causal_conv(params, branch, conv_state)
    a, gx = _rg_lru_gates(params, branch)
    h0 = None if cache is None else cache["h"].float()
    h = _lru_scan(a, gx, h0)
    new_cache = {"conv": new_conv.to(COMPUTE_DTYPE),
                 "h": h[:, -1, :].float()}
    out = (gate * h.to(x.dtype)) @ params["w_out"].to(x.dtype)
    return out, new_cache


def init_rglru_cache(cfg, batch: int, device=None) -> dict:
    w = cfg.rnn_width
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=COMPUTE_DTYPE, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device)}
