"""Dense FFN of the port: SwiGLU (silu), GeGLU (geglu) or plain-GELU MLP
(gelu), the activations composed op by op as ``jax.nn``'s are
(:mod:`.layers`)."""
from __future__ import annotations

import torch

from .layers import dense_init, gelu, silu


def is_gated(act: str) -> bool:
    return act in ("silu", "geglu")


def init_ffn(cfg, gen, d_ff: int | None = None, device=None) -> dict:
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    p = {"w_in": dense_init(gen, (d, ff), device=device),
         "w_out": dense_init(gen, (ff, d), device=device)}
    if is_gated(cfg.act):
        p["w_gate"] = dense_init(gen, (d, ff), device=device)
    return p


def apply_ffn(cfg, params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["w_in"].to(x.dtype)
    if is_gated(cfg.act):
        g = x @ params["w_gate"].to(x.dtype)
        act = silu if cfg.act == "silu" else gelu
        h = act(g) * h
    else:
        h = gelu(h)
    return h @ params["w_out"].to(x.dtype)
