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


def dispatch(cfg, r: dict, cap: int, lo: int = 0, n: int | None = None):
    """Dispatch (b,t,n,cap) and combine weights of experts [lo, lo + n)
    (default: all) from a chunk's routing ``r``.  Each expert appears at
    most once among a token's k choices, so every sum over k has at most
    one nonzero term."""
    onehot = r["onehot"]
    n = onehot.shape[-1] - lo if n is None else n
    onehot = onehot[..., lo:lo + n]
    keep = r["keep"].float()
    slot_oh = _one_hot(r["pos_in_expert"].to(torch.int32), cap)  # (b,t,k,c)
    disp = torch.einsum("btke,btkc->btec", onehot * keep[..., None], slot_oh)
    comb = disp * torch.einsum("btke,btk->bte", onehot,
                               r["gate_vals"] * keep)[..., None]
    return disp, comb


def expert_act(cfg, h, g):
    """The experts' activation of their input projection ``h`` (and gate
    projection ``g`` when gated)."""
    if g is None:
        return gelu(h)
    act = silu if cfg.act == "silu" else gelu
    return act(g) * h


def expert_hidden(cfg, params, x, disp):
    """The activated hidden states (b, e, c, ff) of the experts whose
    input weights ``params`` holds, on the tokens ``disp`` sends them."""
    xe = torch.einsum("btec,btd->becd", disp.to(x.dtype), x)     # (b,e,c,d)
    h = torch.einsum("becd,edf->becf", xe, params["w_in"].to(x.dtype))
    g = (torch.einsum("becd,edf->becf", xe, params["w_gate"].to(x.dtype))
         if "w_gate" in params else None)
    return expert_act(cfg, h, g)


def aux_sums(r: dict) -> tuple:
    """The Switch aux loss's sums over a chunk's rows and tokens: routed
    one-hots per expert (e,), router probabilities per expert (e,), and
    the token count.  Sums, not means, so that batch shards' sums add up
    to the whole chunk's before :func:`aux_term` takes the product."""
    b, t, _ = r["probs"].shape
    return r["onehot"].sum(2).sum(dim=(0, 1)), r["probs"].sum(dim=(0, 1)), \
        b * t


def aux_term(cfg, routed, probs, n) -> torch.Tensor:
    """``sum(me * ce) * e / topk`` of a chunk from its :func:`aux_sums`:
    ``me`` the fraction routed per expert, ``ce`` the mean router
    probability per expert."""
    me = routed / n                          # fraction routed per expert
    ce = probs / n                           # mean router prob per expert
    return (me * ce).sum() * cfg.n_experts / cfg.n_experts_per_token


def _moe_chunk(cfg, params, x):
    """x: (b, t, d) one sequence chunk -> (out, aux sums of the chunk)."""
    cap = _capacity(x.shape[1], cfg)
    r = route(cfg, (x @ params["router"].to(x.dtype)).float(), cap)
    disp, comb = dispatch(cfg, r, cap)
    ye = torch.einsum("becf,efd->becd", expert_hidden(cfg, params, x, disp),
                      params["w_out"].to(x.dtype))
    return torch.einsum("btec,becd->btd", comb.to(x.dtype), ye), aux_sums(r)


def chunks(cfg, s: int) -> list[tuple[int, int]]:
    """The (start, end) of each dispatch chunk of a length-``s``
    sequence: ``cfg.moe_chunk`` each where it divides s into more than
    one, else the whole sequence."""
    chunk = min(cfg.moe_chunk, s)
    if s % chunk == 0 and s // chunk > 1:
        return [(c, c + chunk) for c in range(0, s, chunk)]
    return [(0, s)]


def apply_moe(cfg, params, x):
    """x: (b, s, d) -> (out, aux loss).  The sequence is chunked for
    dispatch memory; capacity is enforced per chunk, and the aux loss is
    the mean of the chunks' terms."""
    spans = chunks(cfg, x.shape[1])
    outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi in spans:
        o, sums = _moe_chunk(cfg, params, x[:, lo:hi] if len(spans) > 1
                             else x)
        outs.append(o)
        aux = aux + aux_term(cfg, *sums)
    out = torch.cat(outs, dim=1) if len(spans) > 1 else outs[0]
    if len(spans) > 1:
        aux = aux / len(spans)
    if "residual" in params:
        out = out + apply_ffn(cfg, params["residual"], x)
    return out, aux
