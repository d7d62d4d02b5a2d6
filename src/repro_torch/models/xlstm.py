"""xLSTM blocks of the port (``repro.models.xlstm`` in the reference,
arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

mLSTM — matrix-memory cell with exponential gating:
    C_t = f_t C_{t-1} + i_t v_t k_t^T,   n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t^T q_t|, exp(-m_t))
Train and prefill use the stabilized CHUNKWISE form (intra-chunk parallel
through the log-gate decay matrix D, inter-chunk recurrent state, O(C^2)
score tiles); decode keeps (C, n, m) state.  Block: up-projection (x2)
-> mLSTM heads -> output RMS norm -> learnable skip -> down-projection.

sLSTM — scalar memory with memory mixing and exponential gating with the
stabilizer m_t, a loop over time; its input projection is hoisted out of
the loop into one matmul.  Block: sLSTM -> RMS norm -> gated post-MLP.

Where the reference contracts three operands in one einsum, the port
contracts them pairwise, in an order that never builds a
(b, u, h, dk, dv) tensor (at dh = 1024 that would be gigabytes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import PARAM_DTYPE, dense_init, sigmoid, silu

NEG_INF = -1e30
MLSTM_CHUNK = 256


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 RMS norm over the last axis (eps 1e-6), cast back to x's
    dtype."""
    xf = x.float()
    return (xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
            * scale).to(x.dtype)


# ==================================================================== mLSTM
def init_mlstm_block(cfg, gen, device=None) -> dict:
    d = cfg.d_model
    di = int(d * cfg.xlstm_proj_factor)        # inner width
    h = cfg.n_heads
    dh = di // h
    return {
        "w_up": dense_init(gen, (d, di), device=device),
        "w_up_gate": dense_init(gen, (d, di), device=device),
        "wq": dense_init(gen, (di, h, dh), device=device),
        "wk": dense_init(gen, (di, h, dh), device=device),
        "wv": dense_init(gen, (di, h, dh), device=device),
        # per-head scalar gates from the inner stream
        "w_i": dense_init(gen, (di, h), scale=di ** -0.5, device=device),
        "w_f": dense_init(gen, (di, h), scale=di ** -0.5, device=device),
        "b_i": torch.zeros((h,), dtype=PARAM_DTYPE, device=device),
        # forget-gate bias: remember
        "b_f": torch.full((h,), 3.0, dtype=PARAM_DTYPE, device=device),
        "skip_scale": torch.ones((di,), dtype=PARAM_DTYPE, device=device),
        "w_down": dense_init(gen, (di, d), device=device),
        "out_norm_scale": torch.ones((di,), dtype=PARAM_DTYPE,
                                     device=device),
    }


def _mlstm_chunk_step(state, q, k, v, log_i, log_f):
    """One chunk of the stabilized chunkwise mLSTM.

    state: {c: (b,h,dk,dv), n: (b,h,dk), m: (b,h)}, stabilized so the true
      state is (c, n) * exp(m).
    q, k, v: (b,C,h,dh) fp32 (q pre-scaled by dh^-0.5); log_i, log_f:
      (b,C,h) fp32.
    Returns (new_state, h_out (b,C,h,dh))."""
    C = q.shape[1]
    c0, n0, m0 = state["c"], state["n"], state["m"]
    Fc = torch.cumsum(log_f, dim=1)                        # (b,C,h) inclusive
    # intra-chunk decay matrix D[t,u] = F_t - F_u + log_i_u  (u <= t)
    dmat = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=q.device))
    dmat = torch.where(tri[None, :, :, None], dmat,
                       torch.full((), NEG_INF, device=q.device))
    intra_max = torch.amax(dmat, dim=2)                    # (b,t,h)
    # stabilizer per position: max(cross-chunk carry, intra contributions)
    m_t = torch.maximum(Fc + m0[:, None, :], intra_max)    # (b,C,h)
    dexp = torch.exp(dmat - m_t[:, :, None, :])            # (b,t,u,h)
    scores = torch.einsum("bthd,buhd->btuh", q, k)
    w = scores * dexp                                      # masked: dexp = 0
    carry_scale = torch.exp(Fc + m0[:, None, :] - m_t)     # (b,C,h)
    num = (torch.einsum("btuh,buhd->bthd", w, v)
           + carry_scale[..., None] * torch.einsum("bthk,bhkv->bthv", q, c0))
    den_intra = w.sum(2)                                   # (b,t,h)
    den_carry = torch.einsum("bthk,bhk->bth", q, n0)
    den = den_intra + carry_scale * den_carry
    h_out = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    # end-of-chunk state update (t = C-1 formulas)
    m_new = m_t[:, -1, :]                                  # (b,h)
    decay_u = torch.exp(Fc[:, -1:, :] - Fc + log_i - m_new[:, None, :])
    kv = torch.einsum("buhk,buhv->bhkv", decay_u[..., None] * k, v)
    f_end = torch.exp(Fc[:, -1, :] + m0 - m_new)           # (b,h)
    c_new = f_end[..., None, None] * c0 + kv
    n_new = (f_end[..., None] * n0
             + torch.einsum("buh,buhk->bhk", decay_u, k))
    return {"c": c_new, "n": n_new, "m": m_new}, h_out


def _mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk=MLSTM_CHUNK):
    """Run the sequence's chunks through _mlstm_chunk_step in order.
    q, k, v: (b,s,h,dh) any dtype; s must be a multiple of min(chunk, s).
    Returns (h_out (b,s,h,dh) fp32, final state)."""
    s = q.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"mLSTM sequence length {s} is not a multiple of "
                         f"its chunk {c}")
    q, k, v = q.float(), k.float(), v.float()
    hs = []
    for i in range(0, s, c):
        sl = slice(i, i + c)
        state, hi = _mlstm_chunk_step(state, q[:, sl], k[:, sl], v[:, sl],
                                      log_i[:, sl], log_f[:, sl])
        hs.append(hi)
    return torch.cat(hs, dim=1), state


def _mlstm_recurrent_step(state, q, k, v, log_i, log_f):
    """One decode step.  state: {c (b,h,dk,dv), n (b,h,dk), m (b,h)};
    q, k, v: (b,h,dh) fp32; log_i, log_f: (b,h)."""
    c, n, m = state["c"], state["n"], state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    i_sc = torch.exp(log_i - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c_new = f_sc[..., None, None] * c + i_sc[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_sc[..., None] * n + i_sc[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c_new, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return {"c": c_new, "n": n_new, "m": m_new}, h


def mlstm_cell(q, k, v, log_i, log_f, state, dtype):
    """The mLSTM cell over a sequence: chunkwise when s > 1 (train,
    prefill), one recurrent step otherwise (decode).  Returns (h
    (b,s,h,dh) in ``dtype``, new state)."""
    if q.shape[1] > 1:
        hout, state = _mlstm_chunkwise(q, k, v, log_i, log_f, state)
        return hout.to(dtype), state
    state, h_t = _mlstm_recurrent_step(
        state, q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
        log_i[:, 0], log_f[:, 0])
    return h_t[:, None].to(dtype), state


def apply_mlstm_block(cfg, params, x, *, cache=None, pos=None):
    """x: (b, s, d) -> (out, new_cache)."""
    b, s, d = x.shape
    hh = cfg.n_heads
    up = x @ params["w_up"].to(x.dtype)                       # (b,s,di)
    gate = silu(x @ params["w_up_gate"].to(x.dtype))
    di = up.shape[-1]
    dh = di // hh
    # the scale in x's dtype, as the reference's weakly typed scalar
    q = torch.einsum("bsd,dhk->bshk", up, params["wq"].to(x.dtype)) * (
        torch.tensor(dh ** -0.5, dtype=x.dtype, device=x.device))
    k = torch.einsum("bsd,dhk->bshk", up, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", up, params["wv"].to(x.dtype))
    upf = up.float()
    log_i = upf @ params["w_i"].float() + params["b_i"]        # (b,s,h)
    log_f = F.logsigmoid(upf @ params["w_f"].float() + params["b_f"])

    state = cache if cache is not None else init_mlstm_cache(cfg, b,
                                                             x.device)
    hout, state = mlstm_cell(q, k, v, log_i, log_f, state, x.dtype)

    hflat = _rms(hout.reshape(b, s, di), params["out_norm_scale"])
    mixed = hflat * gate + params["skip_scale"].to(x.dtype) * up
    out = mixed @ params["w_down"].to(x.dtype)
    return out, dict(state)


def init_mlstm_cache(cfg, batch: int, device=None) -> dict:
    di = int(cfg.d_model * cfg.xlstm_proj_factor)
    h = cfg.n_heads
    dh = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), -1e9, **f32)}


# ==================================================================== sLSTM
def init_slstm_block(cfg, gen, device=None) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = int(d * cfg.slstm_mlp_factor)
    return {
        # input projections for the (z, i, f, o) gates
        "w_zifo": dense_init(gen, (d, 4, h, dh), device=device),
        # recurrent (per-head block-diagonal) weights
        "r_zifo": dense_init(gen, (4, h, dh, dh), scale=dh ** -0.5,
                             device=device),
        "b_zifo": torch.zeros((4, h, dh), dtype=PARAM_DTYPE, device=device),
        "w_mlp_in": dense_init(gen, (d, ff), device=device),
        "w_mlp_gate": dense_init(gen, (d, ff), device=device),
        "w_mlp_out": dense_init(gen, (ff, d), device=device),
        "norm_scale": torch.ones((d,), dtype=PARAM_DTYPE, device=device),
    }


def _slstm_step(r_zifo, b_zifo, state, zifo_x_t):
    """state: {c, n, m, h} each (b, heads, dh); zifo_x_t: (b, 4, h, dh)
    fp32, this step's pre-projected input gates; r_zifo, b_zifo fp32."""
    zifo_r = torch.einsum("bhk,ghkl->bghl", state["h"], r_zifo)
    return slstm_update(state, zifo_x_t + zifo_r + b_zifo)


def slstm_update(state, pre):
    """One step's state update from its gate pre-activations ``pre``
    (b, 4, h, dh) fp32: elementwise in (h, dh)."""
    c, n, m = state["c"], state["n"], state["m"]
    z = torch.tanh(pre[:, 0])
    i_log = pre[:, 1]                        # exponential input gate (log)
    f_log = F.logsigmoid(pre[:, 2])          # sigmoid forget gate, log space
    o = sigmoid(pre[:, 3])
    m_new = torch.maximum(f_log + m, i_log)
    i_sc = torch.exp(i_log - m_new)
    f_sc = torch.exp(f_log + m - m_new)
    c_new = f_sc * c + i_sc * z
    n_new = f_sc * n + i_sc
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def apply_slstm_block(cfg, params, x, *, cache=None, pos=None):
    b, s, d = x.shape
    state = cache if cache is not None else init_slstm_cache(cfg, b,
                                                             x.device)
    # hoisted input projection: ONE matmul for all timesteps
    zifo_x = torch.einsum("bsd,dghk->sbghk", x.float(),
                          params["w_zifo"].float())
    r_zifo, b_zifo = params["r_zifo"].float(), params["b_zifo"].float()
    hs = []
    for t in range(s):
        state = _slstm_step(r_zifo, b_zifo, state, zifo_x[t])
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    y = _rms(y, params["norm_scale"])
    # post MLP (gated)
    hmid = silu(y @ params["w_mlp_gate"].to(x.dtype)) * (
        y @ params["w_mlp_in"].to(x.dtype))
    out = hmid @ params["w_mlp_out"].to(x.dtype)
    return out, state


def init_slstm_cache(cfg, batch: int, device=None) -> dict:
    h = cfg.n_heads
    dh = cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h, dh), -1e9, **f32),
            "h": torch.zeros((batch, h, dh), **f32)}
