"""Mixture-of-Experts FFN of the port (``repro.models.moe`` in the
reference): top-k token-choice routing with per-chunk capacity, GShard
dispatch and combine as one-hot contractions, the Switch load-balancing
aux loss, and an optional parallel dense-residual branch (arctic).

Routing (:func:`route`) is a function of the fp32 router logits alone,
so it is held exactly equal to the reference's on equal logits:

* the top k come from a stable descending sort, so a tie goes to the
  lower expert index, as ``jax.lax.top_k`` breaks it (``torch.topk``
  promises no order among ties on the card);
* a (token, choice)'s place in its expert's queue is an exclusive
  cumulative sum of one-hots over the chunk's (token, choice) pairs in
  order, and it is kept when that place is below the capacity.

The sequence is cut into chunks of ``cfg.moe_chunk`` when it divides into
more than one, each with its own capacity, as in the reference.
"""
from __future__ import annotations

import torch

from .ffn import apply_ffn, init_ffn, is_gated
from .layers import dense_init, gelu, silu


def init_moe(cfg, gen, device=None) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_dff
    p = {
        "router": dense_init(gen, (d, e), scale=d ** -0.5, device=device),
        "w_in": dense_init(gen, (e, d, ff), device=device),
        "w_out": dense_init(gen, (e, ff, d), device=device),
    }
    if is_gated(cfg.act):
        p["w_gate"] = dense_init(gen, (e, d, ff), device=device)
    if cfg.dense_residual:
        p["residual"] = init_ffn(cfg, gen, d_ff=cfg.d_ff, device=device)
    return p


def _capacity(chunk: int, cfg) -> int:
    c = int(chunk * cfg.n_experts_per_token / cfg.n_experts
            * cfg.capacity_factor)
    return max(1, min(chunk, c))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of integer ``idx`` over ``n`` classes; an index
    outside [0, n) gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, a tie going to the lower index (a stable descending
    sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, logits: torch.Tensor, cap: int) -> dict:
    """Routing of one chunk from its fp32 router logits (b, t, e):
    ``probs`` (b,t,e), the renormalised ``gate_vals`` and ``gate_idx``
    of the top k (b,t,k), the expert one-hots ``onehot`` (b,t,k,e), each
    choice's ``pos_in_expert`` (b,t,k, fp32) and ``keep`` = pos < cap."""
    b, t, e = logits.shape
    topk = cfg.n_experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, topk)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = _one_hot(gate_idx, e)                               # (b,t,k,e)
    flat = onehot.reshape(b, t * topk, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, t, topk, e)
    pos_in_expert = (pos * onehot).sum(-1)                       # (b,t,k)
    return {"probs": probs, "gate_vals": gate_vals, "gate_idx": gate_idx,
            "onehot": onehot, "pos_in_expert": pos_in_expert,
            "keep": pos_in_expert < cap}


def _moe_chunk(cfg, params, x):
    """x: (b, t, d) one sequence chunk -> (out, aux loss of the chunk)."""
    b, t, d = x.shape
    e, topk = cfg.n_experts, cfg.n_experts_per_token
    cap = _capacity(t, cfg)
    logits = (x @ params["router"].to(x.dtype)).float()          # (b,t,e)
    r = route(cfg, logits, cap)
    onehot, keep = r["onehot"], r["keep"].float()
    slot_oh = _one_hot(r["pos_in_expert"].to(torch.int32), cap)  # (b,t,k,c)
    # dispatch (b,t,e,cap) and combine weights, contracted pairwise; each
    # expert appears at most once among a token's k choices, so every sum
    # over k has at most one nonzero term
    disp = torch.einsum("btke,btkc->btec", onehot * keep[..., None], slot_oh)
    comb = disp * torch.einsum("btke,btk->bte", onehot,
                               r["gate_vals"] * keep)[..., None]

    xe = torch.einsum("btec,btd->becd", disp.to(x.dtype), x)     # (b,e,c,d)
    h = torch.einsum("becd,edf->becf", xe, params["w_in"].to(x.dtype))
    if "w_gate" in params:
        g = torch.einsum("becd,edf->becf", xe, params["w_gate"].to(x.dtype))
        act = silu if cfg.act == "silu" else gelu
        h = act(g) * h
    else:
        h = gelu(h)
    ye = torch.einsum("becf,efd->becd", h, params["w_out"].to(x.dtype))
    out = torch.einsum("btec,becd->btd", comb.to(x.dtype), ye)

    # Switch aux loss terms of this chunk
    me = onehot.sum(2).mean(dim=(0, 1))      # fraction routed per expert
    ce = r["probs"].mean(dim=(0, 1))         # mean router prob per expert
    aux = (me * ce).sum() * e / topk
    return out, aux


def apply_moe(cfg, params, x):
    """x: (b, s, d) -> (out, aux loss).  The sequence is chunked for
    dispatch memory; capacity is enforced per chunk."""
    b, s, d = x.shape
    chunk = min(cfg.moe_chunk, s)
    if s % chunk == 0 and s // chunk > 1:
        outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, s, chunk):
            o, a = _moe_chunk(cfg, params, x[:, c:c + chunk])
            outs.append(o)
            aux = aux + a
        out = torch.cat(outs, dim=1)
        aux = aux / (s // chunk)
    else:
        out, aux = _moe_chunk(cfg, params, x)
    if "residual" in params:
        out = out + apply_ffn(cfg, params["residual"], x)
    return out, aux
