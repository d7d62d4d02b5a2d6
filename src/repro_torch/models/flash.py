"""Flash-style attention of the port with its backward (``repro.models.flash``
in the reference, whose custom VJP becomes a ``torch.autograd.Function``).

Neither pass materializes the (sq, sk) score matrix: the forward streams KV
chunks with an online softmax in fp32 and saves only (o, lse); the backward
recomputes each chunk's probabilities from (q, k, lse) and accumulates dq,
emitting dk and dv chunk by chunk.  Only (b, h, sq, kv_chunk) scores are
live at a time.  Masking is positional (causal and/or sliding window),
matching attention._mask_bias.  GQA is handled by the caller (repeat-kv).

``FlashAttention.forward_calls`` / ``backward_calls`` count the passes run
(a remat'd layer runs its forward twice per training step).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunk_bias(q_pos, k_pos, causal, window):
    """(b, sq_c, sk_c) additive f32 bias from absolute positions."""
    d = q_pos[:, :, None] - k_pos[:, None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window is not None:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _n_chunks(sk: int, kv_chunk: int) -> int:
    nc = max(1, sk // min(kv_chunk, sk))
    if sk % nc:
        raise ValueError(f"kv length {sk} does not split into {nc} chunks")
    return nc


def _flash_fwd_inner(q, k, v, q_pos, k_pos, causal, window, kv_chunk):
    """(o in q.dtype, lse (b, h, sq) fp32)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    nc = _n_chunks(sk, kv_chunk)
    cs = sk // nc
    scale = hd ** -0.5
    qf = q.float()
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * cs, (c + 1) * cs)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, sl].float()) * scale
        s = s + _chunk_bias(q_pos, k_pos[:, sl], causal, window)[:, None]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bhqk,bkhd->bhqd", p, v[:, sl].float()))
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    o = (acc / l_safe[..., None]).transpose(1, 2)          # (b,sq,h,hd)
    lse = m + torch.log(l_safe)                             # (b,h,sq)
    return o.to(q.dtype), lse


def _flash_bwd_inner(q, k, v, q_pos, k_pos, o, lse, do, causal, window,
                     kv_chunk):
    """(dq, dk, dv) in the dtypes of (q, k, v): the reference's ``_bwd``."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    nc = _n_chunks(sk, kv_chunk)
    cs = sk // nc
    scale = hd ** -0.5
    qf = q.float()
    dof = do.float()
    # delta_q = rowsum(do * o): (b,h,sq)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    dq = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c in range(nc):
        sl = slice(c * cs, (c + 1) * cs)
        kc, vc = k[:, sl].float(), v[:, sl].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        s = s + _chunk_bias(q_pos, k_pos[:, sl], causal, window)[:, None]
        p = torch.exp(s - lse[..., None])                   # (b,h,sq,kc)
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, dof))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vc)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """The flash forward and its recomputing backward (the reference's
    ``jax.custom_vjp``).  Positions and the static arguments get no
    gradient."""

    forward_calls = 0
    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, kv_chunk):
        FlashAttention.forward_calls += 1
        o, lse = _flash_fwd_inner(q, k, v, q_pos, k_pos, causal, window,
                                  kv_chunk)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, lse)
        ctx.static = (causal, window, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        FlashAttention.backward_calls += 1
        q, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_inner(q, k, v, q_pos, k_pos, o, lse, do,
                                      *ctx.static)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, causal=True, window=None,
                    kv_chunk=1024):
    """q: (b,sq,h,hd), k/v: (b,sk,h,hd) (same head count — repeat-kv before),
    q_pos: (b,sq), k_pos: (b,sk).  Returns (b,sq,h,hd) in q.dtype;
    differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window,
                                kv_chunk)
