"""Shared layer primitives of the port: norms, initializers, RoPE / M-RoPE,
activations (``repro.models.layers`` in the reference).

Compute dtype is bf16 and parameters are stored fp32, cast at use; every
function rounds where the reference rounds, so the port's bf16 results
follow the reference's to bf16 precision.
"""
from __future__ import annotations

import numpy as np
import torch

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def _truncated_normal(gen, shape, device) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2], fp32, on ``device``.

    ``gen`` is a ``torch.Generator`` (on ``device``) or a numpy
    ``Generator``; the latter draws on the host with rejection, so a tree
    built from ``numpy.random.default_rng(seed)`` is the same on every
    host and card (:func:`repro_torch.models.numpy_params`).  Neither
    reproduces ``jax.random.truncated_normal``'s draws, only its
    distribution.
    """
    if isinstance(gen, np.random.Generator):
        x = gen.standard_normal(shape, dtype=np.float32)
        bad = np.abs(x) > 2.0
        while bad.any():
            x[bad] = gen.standard_normal(int(bad.sum()), dtype=np.float32)
            bad = np.abs(x) > 2.0
        return torch.from_numpy(x).to(device)
    t = torch.empty(shape, dtype=PARAM_DTYPE, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen, shape, scale: float | None = None,
               device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    return _truncated_normal(gen, shape, device) * scale


def embed_init(gen, shape, device=None) -> torch.Tensor:
    # d_model^-0.5 keeps (tied-)head logits O(1) at init; d_model is the
    # smaller dim for both (vocab, d) embeddings and (d, vocab) heads
    scale = min(shape) ** -0.5 if len(shape) >= 2 else 0.02
    return _truncated_normal(gen, shape, device) * scale


# --------------------------------------------------------------------- norms
def init_norm(cfg, dim: int, device=None) -> dict:
    p = {"scale": torch.ones((dim,), dtype=PARAM_DTYPE, device=device)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros((dim,), dtype=PARAM_DTYPE, device=device)
    return p


def apply_norm(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * params["scale"] + params["bias"]
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * params["scale"]
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """qk-norm: RMS over the head dim."""
    xf = x.float()
    out = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps) * scale
    return out.to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def _freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., s) int -> cos/sin of shape (..., s, head_dim//2),
    fp32."""
    ang = positions.float()[..., None] * _freq(head_dim, theta,
                                               positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); cos/sin: (b, s, hd//2) or (s, hd//2).  Half-split
    rotation (not interleaved), cos/sin cast to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int],
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE: positions (3, b, s) for (t, h, w) streams; the
    rotary half-dim is split into `sections` (sum = head_dim//2), each
    section using its own position stream."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to {half}")
    freq = _freq(head_dim, theta, positions.device)
    cos_parts, sin_parts = [], []
    start = 0
    for sec_id, width in enumerate(sections):
        f = freq[start:start + width]
        ang = positions[sec_id].float()[..., None] * f      # (b, s, width)
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
        start += width
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def positions_to_angles(cfg, positions: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (b, s) — or (3, b, s) when cfg.mrope_sections is set."""
    if cfg.mrope_sections is not None:
        if positions.ndim == 2:   # text-only stream: all three sections aligned
            positions = positions[None].expand((3,) + positions.shape)
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


# ---------------------------------------------------------------- activations
# The reference's jax.nn activations are compositions of elementwise ops,
# each rounding to its input's dtype; the port composes the same ops in
# the same order, so on bf16 inputs it rounds where the reference rounds
# (a fused torch kernel rounds once, and lands a bf16 step away from the
# reference for a third of the inputs).
class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)) op by op, with the
    reference's derivative g * (ans * (1 - ans)) in its order, which
    stays finite where exp(-x) overflows."""

    @staticmethod
    def forward(ctx, x):
        ans = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * (ans * (1 - ans))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, op by op with
    its constants in x's dtype."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def act_fn(name: str):
    return {"silu": silu, "gelu": gelu, "geglu": gelu}[name]
