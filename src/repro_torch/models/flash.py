"""Flash-style attention forward of the port (``repro.models.flash`` in the
reference, without its custom-VJP backward, which comes with training).

The forward streams KV chunks with an online softmax in fp32 and never
materializes the (sq, sk) score matrix: only (b, h, sq, kv_chunk) scores
are live at a time.  Masking is positional (causal and/or sliding window),
matching attention._mask_bias.  GQA is handled by the caller (repeat-kv).
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


@torch.no_grad()
def flash_attention(q, k, v, q_pos, k_pos, causal=True, window=None,
                    kv_chunk=1024):
    """q: (b,sq,h,hd), k/v: (b,sk,h,hd) (same head count — repeat-kv before),
    q_pos: (b,sq), k_pos: (b,sk).  Returns (b,sq,h,hd) in q.dtype."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    nc = max(1, sk // min(kv_chunk, sk))
    if sk % nc:
        raise ValueError(f"kv length {sk} does not split into {nc} chunks")
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
    return o.to(q.dtype)
