"""Every block kind's sublayers with their compute split over the
``model`` axis, the way ``sharding.policy`` splits their weights and
caches (the partitioning GSPMD derives in the reference from those
specs: Megatron column- then row-parallel projections, expert
parallelism, head- and width-parallel recurrences).

One batch shard's rows run on the positions of its :class:`Group`, one
per model coordinate, the first being the lead.  Each sublayer takes the
group's normed rows on the lead, sends them to the other positions (an
activation broadcast), lets each position compute the part its weight
blocks hold, and sums the (b, s, d) partials in mesh order onto the lead
(``place.all_reduce``).  A partial of a contraction split over model is
formed in fp32 from the bf16 operands (exact products, fp32 sums) and
the sum rounded once, as the unsharded product rounds the whole
contraction: the sharded step then differs from the unsharded one by
the order of fp32 sums, not by extra bf16 roundings, so an MoE routes
alike on both.  A leaf is gathered whole at use only where the policy
replicates it over ``model``; its sublayer then runs on the lead alone.

* **Attention** ("ga", "la", "gm", "enc"; self and cross): query heads
  and ``wo`` split over model.  KV heads split alike where they divide
  it; where the policy replicates the KV projections, each position
  projects the KV heads its query heads read (training), or the lead
  projects every KV head and keeps the cache, and each position reads
  its query heads' keys and values from it (serving).  Heads that do not
  divide model take sequence-parallel attention under an ``attn_q``
  rule (training) or run on the lead.
* **FFN**: the hidden dim column- then row-parallel; where it does not
  divide model, d_model row- then column-parallel (the pre-activations
  summed, the output's columns concatenated).  arctic's dense residual
  is such an FFN.
* **MoE**: every position routes the group's tokens on the whole router
  logits (column blocks concatenated, or row partials summed) — routing
  is a function of the logits alone, so every position routes alike —
  then runs its E/m experts (expert-parallel), or every expert's slice
  of the hidden dim (hidden-parallel), or of d_model.  Each chunk's
  Switch aux sums (:func:`moe.aux_sums`) are returned for the caller to
  reduce over batch shards before the product.
* **RG-LRU**: ``w_gate``, ``w_branch`` and the depthwise conv on the
  position's w/m channels; the conv output concatenated (``wa`` and
  ``wx`` contract over the whole width), each position computing its
  columns of the gates, its channels of the scan, and ``w_out``'s rows.
  A width that does not divide model splits d_model instead (and the
  conv's taps), the recurrence replicated on each position.
* **mLSTM**: ``w_up`` / ``w_up_gate`` column-parallel, ``up``
  concatenated for the head-split q/k/v and gates, the chunkwise (or
  recurrent) cell per head, the output norm's fp32 sum of squares
  all-reduced over the whole inner width, ``w_down`` row-parallel.
  Where the heads do not divide model (xlstm's 4 on the production
  axis of 16) the policy splits the inner width alone: q/k/v and the
  gates are partial sums over it, the cell runs on the lead.
* **sLSTM**: each position runs its heads' time loop; the post-norm's
  sum of squares all-reduced, its output concatenated for the post MLP,
  a SwiGLU FFN split as the FFN above.  The policy lays ``b_zifo`` out on
  dh (its generic 3-D rule) while the loop splits heads: each position
  reads its heads' block of it once a call, outside the loop.  Where
  the heads do not divide model the policy splits dh: each position
  keeps its dh columns of the state, and every timestep's recurrent
  product is summed over the positions' rows of ``r_zifo``.

Caches are read and written in the compute's layout — a position reads
the region of each cache leaf its heads or channels need from wherever
the policy's layout keeps it (the mLSTM / sLSTM states split on dh, the
KV caches on heads or head_dim) and its new pieces are re-laid to the
policy's layout; both moves count in ``place.traffic``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm
from repro_torch.models.ffn import apply_ffn
from repro_torch.models.layers import COMPUTE_DTYPE, apply_norm, gelu, silu
from repro_torch.sharding import place
from repro_torch.sharding.mesh import move_to


class Group:
    """Batch shard ``i`` of ``run``: its positions ``ranks`` (the lead
    first, model coordinates in order) and the moves among them."""

    def __init__(self, run, i: int, ctx):
        self.run, self.i, self.ctx = run, i, ctx
        self.ranks = run.groups[i]
        self.lead = self.ranks[0]

    def bcast(self, t: torch.Tensor, pos) -> torch.Tensor:
        """``t`` (held by the lead) on ``pos``: counted unless ``pos`` is
        the lead."""
        return t if pos == self.lead else place.broadcast(
            t, self.run.device(pos))

    def to_lead(self, t: torch.Tensor, pos) -> torch.Tensor:
        return t if pos == self.lead else place.broadcast(
            t, self.run.device(self.lead))

    def all_gather(self, parts: list, dim: int) -> list:
        """Each position's piece (in rank order, on its position)
        concatenated along ``dim``, on every position."""
        return [torch.cat([p if src == pos else place.broadcast(
            p, self.run.device(pos)) for src, p in zip(self.ranks, parts)],
            dim=dim) for pos in self.ranks]

    def all_reduce(self, parts: list, dtype=None) -> list:
        """The mesh-order sum of the positions' partials (rounded to
        ``dtype`` on the lead), on every position."""
        total = place.all_reduce(parts)
        total = total if dtype is None else total.to(dtype)
        return [self.bcast(total, pos) for pos in self.ranks]

    def span(self, n: int, pos) -> tuple[int, int]:
        """``pos``'s block of ``n`` split over the model axis."""
        k = n // len(self.ranks)
        m = self.run.model_index(pos)
        return m * k, (m + 1) * k

    def ctx_at(self, pos):
        return self.run.ctx_for(self.ctx, self.i, pos)

    def cache(self, cache, pos, dims=None, span=None):
        """The group's rows of each leaf of ``cache`` on ``pos``, cut to
        ``span`` on the leaf's dim in ``dims`` (key -> dim); None stays
        None."""
        if cache is None:
            return None
        rows = self.run.rows(self.i, next(iter(cache.values())).shape[0])
        return {k: self.run.region(v, {0: rows, **(
            {dims[k]: span} if dims else {})}, pos)
            for k, v in cache.items()}


def _lead_tiles(new_cache, lead) -> dict:
    """A sublayer's new cache computed whole on the lead, as tiles."""
    return {k: (None, {lead: v}) for k, v in (new_cache or {}).items()}


def _add_tiles(tiles: dict, new_cache, dim: int, pos) -> None:
    for k, v in (new_cache or {}).items():
        tiles.setdefault(k, (dim, {}))[1][pos] = v


def _partial(eq: str, x, w):
    """A position's part of a contraction split over model: ``x`` times
    ``w`` (cast to x's dtype, as the unsharded code casts it) with exact
    products and fp32 sums, so that :func:`_sum` rounds the whole
    contraction once, as the unsharded product rounds it."""
    return torch.einsum(eq, x.float(), w.to(x.dtype).float())


def _sum(parts: list, dtype):
    """The mesh-order sum of fp32 partials on the first one's position,
    rounded to ``dtype``."""
    return place.all_reduce(parts).to(dtype)


# ------------------------------------------------------------ attention
def _heads(cfg, pa: dict, h, g: Group, cache, kv_fn, q_fn):
    """Attention with its query heads split over model: (the sum of the
    positions' out-projected partials on the lead, cache tiles).
    ``kv_fn(params, h, ctx, cache) -> transformer.KV`` and ``q_fn(params,
    h, ctx)`` are the self- or cross-attention's."""
    run, lead = g.run, g.lead
    kv_split = run.split_on(pa["wk"], 1) and run.split_on(pa["wv"], 1)
    rest = [k for k in pa if k not in ("wq", "wk", "wv", "wo")]
    tiles: dict = {}
    shared = None
    if not kv_split and g.ctx.mode != "train":
        # the policy replicates the KV projections: the lead projects
        # every KV head and keeps the cache
        shared = kv_fn({k: run.full(pa[k], lead) for k in ("wk", "wv", *rest)},
                       h, g.ctx_at(lead), g.cache(cache, lead))
        tiles = _lead_tiles(shared.cache, lead)
    parts = []
    for pos in g.ranks:
        dev = run.device(pos)
        hm = g.bcast(h, pos)
        cx = g.ctx_at(pos)
        pm = {"wq": run.piece(pa["wq"], pos, 1),
              "wo": run.piece(pa["wo"], pos, 0),
              **{k: run.full(pa[k], pos) for k in rest}}
        if kv_split:
            pm["wk"] = run.piece(pa["wk"], pos, 1)
            pm["wv"] = run.piece(pa["wv"], pos, 1)
            span = g.span(pa["wk"].shape[1], pos)
            kv = kv_fn(pm, hm, cx, g.cache(cache, pos, dict.fromkeys(
                cache or (), 2), span))
            _add_tiles(tiles, kv.cache, 2, pos)
        else:
            # the KV head each local query head reads, in order
            hl = pm["wq"].shape[1]
            grp = pa["wq"].shape[1] // pa["wk"].shape[1]
            m = run.model_index(pos)
            idx = torch.arange(m * hl, (m + 1) * hl) // grp
            if shared is None:      # training: projected here
                for w in ("wk", "wv"):
                    pm[w] = run.full(pa[w], pos)[:, idx.to(dev)]
                kv = kv_fn(pm, hm, cx, None)
            else:
                sel = idx.to(shared.k.device)
                kv = dataclasses.replace(
                    shared, k=g.bcast(shared.k[:, :, sel], pos),
                    v=g.bcast(shared.v[:, :, sel], pos),
                    q_pos=move_to(shared.q_pos, dev),
                    k_pos=move_to(shared.k_pos, dev),
                    k_valid=None if shared.k_valid is None
                    else move_to(shared.k_valid, dev), cache=None)
        parts.append(_partial("bshk,hkd->bsd", tfm.attend(
            cfg, q_fn(pm, hm, cx), kv), pm["wo"]))
    return _sum(parts, h.dtype), tiles


def _seq(cfg, pa: dict, h, g: Group, kind: str):
    """Sequence-parallel attention (training, heads that do not divide
    model, replicated weights): each position's query rows against whole
    K/V, the rows concatenated on the lead."""
    run, lead = g.run, g.lead
    nm, s = len(g.ranks), h.shape[1]
    parts = []
    for m, pos in enumerate(g.ranks):
        hm = g.bcast(h, pos)
        p = run.full(pa, pos)
        cx = g.ctx_at(pos)
        lo, hi = m * s // nm, (m + 1) * s // nm     # this position's rows
        q = attn.project_q(cfg, p, hm[:, lo:hi], cx.cos[:, lo:hi],
                           cx.sin[:, lo:hi])
        k, v = attn.project_kv(cfg, p, hm, cx.cos, cx.sin)
        o = attn.attention(cfg, q, k, v, q_pos=cx.q_pos[:, lo:hi],
                           k_pos=cx.q_pos, causal=kind != "enc",
                           window=cfg.window_size if kind == "la" else None,
                           q_chunk=cx.q_chunk)
        parts.append(g.to_lead(attn.out_proj(p, o), pos))
    return torch.cat(parts, dim=1)


def self_attention(cfg, p: dict, kind: str, xi, g: Group, cache, mode: str):
    """x + the self-attention sublayer of group rows ``xi`` in ``mode``
    ("heads", "seq" or "gather"), and its cache tiles."""
    run, lead = g.run, g.lead
    h = apply_norm(cfg, run.full(p["norm1"], lead), xi)
    c = None if cache is None else {k: cache[k] for k in ("k", "v")}
    if mode == "heads":
        o, tiles = _heads(
            cfg, p["attn"], h, g, c,
            lambda pm, hm, cx, cm: tfm.self_kv(cfg, pm, hm, kind, cx, cm),
            lambda pm, hm, cx: attn.project_q(cfg, pm, hm, cx.cos, cx.sin))
    elif mode == "seq":
        o, tiles = _seq(cfg, p["attn"], h, g, kind), {}
    else:
        o, nc = tfm.self_attention(cfg, run.full(p["attn"], lead), h, kind,
                                   g.ctx_at(lead), g.cache(c, lead))
        tiles = _lead_tiles(nc, lead)
    return xi + o, tiles


def cross_attention(cfg, p: dict, xi, g: Group, cache):
    """x + the cross-attention sublayer over the encoder's output, and
    its ``ck`` / ``cv`` tiles."""
    run, lead = g.run, g.lead
    h = apply_norm(cfg, run.full(p["cross_norm"], lead), xi)
    pc = p["cross"]
    c = None if cache is None else {k: cache[k] for k in ("ck", "cv")}
    if run.split_on(pc["wq"], 1) and run.split_on(pc["wo"], 0):
        o, tiles = _heads(
            cfg, pc, h, g, c,
            lambda pm, hm, cx, cm: tfm.cross_kv(cfg, pm, hm, cx, cm),
            lambda pm, hm, cx: tfm.cross_q(cfg, pm, hm, cx))
    else:
        o, nc = tfm.cross_attention(cfg, run.full(pc, lead), h,
                                    g.ctx_at(lead), g.cache(c, lead))
        tiles = _lead_tiles(nc, lead)
    return xi + o, tiles


# ------------------------------------------------------------------ FFN
def _row_col(g: Group, cols: list, pre, post):
    """A d_model row- then column-parallel MLP: ``pre(cols[j], pos)`` a
    position's (input, gate or None) partial pre-activations from its
    d_model columns ``cols[j]`` of the input (fp32, :func:`_partial`),
    summed over model onto every position and rounded there;
    ``post(input, gate, pos)`` its columns of the output, concatenated
    on the lead."""
    ins, gates = zip(*(pre(c, pos) for c, pos in zip(cols, g.ranks)))
    dt = cols[0].dtype
    ins = g.all_reduce(list(ins), dt)
    gates = g.all_reduce(list(gates), dt) if gates[0] is not None else gates
    return torch.cat([g.to_lead(post(a, b, pos), pos) for a, b, pos in
                      zip(ins, gates, g.ranks)], dim=-1)


def _cols(g: Group, x, pos):
    """``pos``'s block of the last dim of ``x``."""
    lo, hi = g.span(x.shape[-1], pos)
    return x[..., lo:hi]


def ffn(cfg, pf: dict, h, g: Group, hs=None):
    """The dense FFN of group rows ``h`` (on the lead; ``hs``: already on
    every position, in rank order)."""
    run, lead = g.run, g.lead
    if hs is None:
        hs = [g.bcast(h, pos) for pos in g.ranks]
    ins = [w for w in pf if w != "w_out"]
    if all(run.split_on(pf[w], 1) for w in ins) and run.split_on(
            pf["w_out"], 0):
        parts = []
        for x, pos in zip(hs, g.ranks):
            pm = {w: run.piece(t, pos, 0 if w == "w_out" else 1)
                  for w, t in pf.items()}
            a = x @ pm["w_in"].to(x.dtype)
            b = x @ pm["w_gate"].to(x.dtype) if "w_gate" in pm else None
            parts.append(_partial("bsf,fd->bsd", moe_mod.expert_act(cfg, a, b),
                                  pm["w_out"]))
        return _sum(parts, h.dtype)
    if all(run.split_on(pf[w], 0) for w in ins) and run.split_on(
            pf["w_out"], 1):
        def pre(x, pos):
            return tuple(_partial("bsd,df->bsf", x, run.piece(pf[w], pos, 0))
                         if w in pf else None for w in ("w_in", "w_gate"))

        def post(a, b, pos):
            return moe_mod.expert_act(cfg, a, b) @ run.piece(
                pf["w_out"], pos, 1).to(a.dtype)
        return _row_col(g, [_cols(g, x, pos) for x, pos in zip(hs, g.ranks)],
                        pre, post)
    return apply_ffn(cfg, run.full(pf, lead), h)


# ------------------------------------------------------------------ MoE
def _moe_mode(run, pm: dict) -> str:
    ins = [w for w in ("w_in", "w_gate") if w in pm]
    for mode, di, do in (("experts", 0, 0), ("hidden", 2, 1),
                         ("d_model", 1, 2)):
        if all(run.split_on(pm[w], di) for w in ins) and run.split_on(
                pm["w_out"], do):
            return mode
    return "gather"


def _experts(cfg, w: dict, x, r: dict, cap: int, lo: int, mode: str):
    """A position's fp32 part of a chunk's MoE output: its experts [lo,
    lo + n) whole (expert-parallel; each expert's output rounded as the
    unsharded code rounds it) or every expert's slice of the hidden dim
    (hidden-parallel; the experts' outputs partial), combined with the
    bf16 combine weights."""
    disp, comb = moe_mod.dispatch(cfg, r, cap, lo, w["w_in"].shape[0])
    act = moe_mod.expert_hidden(cfg, w, x, disp)
    ye = (torch.einsum("becf,efd->becd", act, w["w_out"].to(x.dtype)).float()
          if mode == "experts" else _partial("becf,efd->becd", act,
                                             w["w_out"]))
    return torch.einsum("btec,becd->btd", comb.to(x.dtype).float(), ye)


def moe(cfg, pm: dict, h, g: Group):
    """The MoE FFN of group rows ``h`` (on the lead): (output on the
    lead, each chunk's :func:`moe.aux_sums`)."""
    run, lead = g.run, g.lead
    mode = _moe_mode(run, pm)
    ranks = g.ranks if mode != "gather" else [lead]
    e = cfg.n_experts
    xs = {pos: g.bcast(h, pos) for pos in ranks}
    dims = {"experts": (0, 0), "hidden": (2, 1), "d_model": (1, 2)}.get(mode)
    w = {}
    for pos in ranks:
        if dims is None:
            w[pos] = run.full({k: pm[k] for k in ("w_in", "w_gate", "w_out")
                               if k in pm}, pos)
        else:
            w[pos] = {k: run.piece(pm[k], pos, dims[k == "w_out"])
                      for k in ("w_in", "w_gate", "w_out") if k in pm}
    router = pm["router"]
    outs, sums = [], []
    spans = moe_mod.chunks(cfg, h.shape[1])
    for lo, hi in spans:
        xc = {pos: x[:, lo:hi] if len(spans) > 1 else x
              for pos, x in xs.items()}
        cap = moe_mod._capacity(hi - lo, cfg)
        if len(ranks) > 1 and run.split_on(router, 1):   # expert columns
            logits = g.all_gather([xc[pos] @ run.piece(router, pos, 1).to(
                xc[pos].dtype) for pos in ranks], -1)
        elif len(ranks) > 1 and run.split_on(router, 0):  # d_model rows
            logits = g.all_reduce([_partial(
                "btd,de->bte", _cols(g, xc[pos], pos),
                run.piece(router, pos, 0)) for pos in ranks], h.dtype)
        else:
            logits = [xc[pos] @ run.full(router, pos).to(xc[pos].dtype)
                      for pos in ranks]
        rs = {pos: moe_mod.route(cfg, lg.float(), cap)
              for pos, lg in zip(ranks, logits)}
        sums.append(moe_mod.aux_sums(rs[lead]))
        if mode == "d_model":
            def pre(x, pos, r=rs, c=cap):
                disp, _ = moe_mod.dispatch(cfg, r[pos], c)
                xe = torch.einsum("btec,btd->becd", disp.to(x.dtype), x)
                return tuple(None if k not in w[pos] else _partial(
                    "becd,edf->becf", xe, w[pos][k])
                    for k in ("w_in", "w_gate"))

            def post(a, b, pos, r=rs, c=cap):
                _, comb = moe_mod.dispatch(cfg, r[pos], c)
                ye = torch.einsum("becf,efd->becd", moe_mod.expert_act(
                    cfg, a, b), w[pos]["w_out"].to(a.dtype))
                return torch.einsum("btec,becd->btd", comb.to(a.dtype), ye)
            outs.append(_row_col(g, [_cols(g, xc[pos], pos) for pos in ranks],
                                 pre, post))
        else:
            parts = [_experts(cfg, w[pos], xc[pos], rs[pos], cap,
                              run.model_index(pos) * (e // len(ranks))
                              if mode == "experts" else 0, mode)
                     for pos in ranks]
            outs.append(_sum(parts, h.dtype))
    out = torch.cat(outs, dim=1) if len(spans) > 1 else outs[0]
    if "residual" in pm:
        out = out + ffn(cfg, pm["residual"], h, g)
    return out, sums


# --------------------------------------------------------------- mixers
def _rglru_d_model(cfg, pr: dict, h, g: Group, cache):
    """The RG-LRU where its width does not divide model and d_model does:
    the policy splits ``w_gate`` / ``w_branch`` by rows, ``w_out`` by
    columns and, where the taps divide model, ``conv_w`` by taps (its
    generic 2-D rule), and replicates the rest.  The gate and branch
    pre-activations and the conv are partial sums (over d_model, over
    taps); each position runs the replicated gates and scan over the
    whole width, as GSPMD runs a replicated op, and projects its d_model
    columns out."""
    run, lead = g.run, g.lead
    dt, s = h.dtype, h.shape[1]
    pre = [tuple(_partial("bsd,dw->bsw", g.bcast(_cols(g, h, pos), pos),
                          run.piece(pr[w], pos, 0))
                 for w in ("w_branch", "w_gate")) for pos in g.ranks]
    branch = g.all_reduce([x for x, _ in pre], dt)
    gate = g.all_reduce([x for _, x in pre], dt)
    states = [g.cache(cache, pos) for pos in g.ranks]
    if run.split_on(pr["conv_w"], 0):       # this position's taps
        cw = pr["conv_w"].shape[0]
        parts, pads = [], []
        for pos, x, cm in zip(g.ranks, branch, states):
            xp = torch.cat([x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
                            if cm is None else cm["conv"].to(dt), x], dim=1)
            lo, hi = g.span(cw, pos)
            w = run.piece(pr["conv_w"], pos, 0).to(dt).float()
            parts.append(sum(xp[:, lo + i:lo + i + s].float() * w[i]
                             for i in range(hi - lo)))
            pads.append(xp[:, xp.shape[1] - (cw - 1):])
        convs = [(t + run.full(pr["conv_b"], pos).to(dt).float()).to(dt)
                 for t, pos in zip(g.all_reduce(parts), g.ranks)]
    else:
        convs, pads = zip(*(rglru._causal_conv(
            run.full({k: pr[k] for k in ("conv_w", "conv_b")}, pos), x,
            None if cm is None else cm["conv"])
            for pos, x, cm in zip(g.ranks, branch, states)))
    out = []
    for pos, x, gt, conv, cm in zip(g.ranks, branch, gate, convs, states):
        a, gx = rglru._rg_lru_gates(
            run.full({k: pr[k] for k in ("wa", "wx", "lam")}, pos), conv)
        hs = rglru._lru_scan(a, gx, None if cm is None else cm["h"].float())
        if pos == lead:
            new = {"conv": pads[0].to(COMPUTE_DTYPE), "h": hs[:, -1].float()}
        out.append(g.to_lead((gelu(gt) * hs.to(dt)) @ run.piece(
            pr["w_out"], pos, 1).to(dt), pos))
    return torch.cat(out, dim=-1), _lead_tiles(new, lead)


def rglru_mixer(cfg, pr: dict, h, g: Group, cache):
    """The RG-LRU mixer of normed rows ``h``: (output on the lead, cache
    tiles) with the width split over model, or d_model where the width
    does not divide model (:func:`_rglru_d_model`)."""
    run, lead = g.run, g.lead
    if (all(run.split_on(pr[w], 0) for w in ("w_gate", "w_branch"))
            and run.split_on(pr["w_out"], 1)
            and not any(_on_model(pr[w]) for w in ("wa", "wx"))):
        return _rglru_d_model(cfg, pr, h, g, cache)
    cols = ("w_gate", "w_branch", "conv_w", "wa", "wx")
    if not (all(run.split_on(pr[w], 1) for w in cols)
            and run.split_on(pr["w_out"], 0)):
        o, nc = rglru.apply_rglru_block(cfg, run.full(pr, lead), h,
                                        cache=g.cache(cache, lead),
                                        pos=g.ctx.pos)
        return o, _lead_tiles(nc, lead)
    width = pr["lam"].shape[0]
    dims = {"conv": 2, "h": 1}
    gates, convs, states, tiles = [], [], [], {}
    for pos in g.ranks:
        hm = g.bcast(h, pos)
        lo, hi = g.span(width, pos)
        gates.append(gelu(hm @ run.piece(pr["w_gate"], pos, 1).to(hm.dtype)))
        branch = hm @ run.piece(pr["w_branch"], pos, 1).to(hm.dtype)
        cm = g.cache(cache, pos, dims, (lo, hi))
        conv, new_conv = rglru._causal_conv(
            {"conv_w": run.piece(pr["conv_w"], pos, 1),
             "conv_b": run.full(pr["conv_b"], pos)[lo:hi]}, branch,
            None if cm is None else cm["conv"])
        convs.append(conv)
        states.append(cm)
        _add_tiles(tiles, {"conv": new_conv.to(COMPUTE_DTYPE)}, 2, pos)
    parts = []
    for pos, gate, conv, whole, cm in zip(g.ranks, gates, convs,
                                          g.all_gather(convs, -1), states):
        lo, hi = g.span(width, pos)
        a, gx = rglru._rg_lru_gates(
            {"wa": run.piece(pr["wa"], pos, 1),
             "wx": run.piece(pr["wx"], pos, 1),
             "lam": run.full(pr["lam"], pos)[lo:hi]}, whole, conv)
        hs = rglru._lru_scan(a, gx, None if cm is None else cm["h"].float())
        _add_tiles(tiles, {"h": hs[:, -1, :].float()}, 1, pos)
        parts.append(_partial("bsw,wd->bsd", gate * hs.to(h.dtype),
                              run.piece(pr["w_out"], pos, 0)))
    return _sum(parts, h.dtype), tiles


def _head_state(cache, init, lo: int, hi: int, dim: int = 1):
    """A position's block [lo, hi) of a recurrent state along ``dim``
    (heads, or dh): the cache's region, or ``init``'s (the unsharded
    start) cut to it."""
    if cache is not None:
        return cache
    return {k: v.narrow(dim, lo, hi - lo) for k, v in init.items()}


def _rms_parts(g: Group, parts: list, scale, width: int) -> list:
    """``xlstm._rms`` of a vector split over the positions (each
    position's columns in ``parts``): the fp32 sums of squares summed in
    mesh order, each position normalising its own columns."""
    totals = g.all_reduce([(p.float() ** 2).sum(-1, keepdim=True)
                           for p in parts])
    out = []
    for pos, p, tot in zip(g.ranks, parts, totals):
        lo, hi = g.span(width, pos)
        out.append((p.float() * torch.rsqrt(tot / width + 1e-6)
                    * g.run.full(scale, pos)[lo:hi]).to(p.dtype))
    return out


def mlstm_mixer(cfg, p: dict, h, g: Group, cache):
    """The mLSTM block of normed rows ``h`` with its heads (and inner
    width) split over model, or its inner width alone where the heads do
    not divide model (:func:`_mlstm_inner`): (output on the lead, state
    tiles)."""
    run, lead = g.run, g.lead
    up = ("w_up", "w_up_gate")
    if (all(run.split_on(p[w], 1) for w in up)
            and all(run.split_on(p[w], 0) for w in ("w_i", "w_f", "w_down"))
            and not any(_on_model(p[w]) for w in ("wq", "wk", "wv"))):
        return _mlstm_inner(cfg, p, h, g, cache)
    if not (all(run.split_on(p[w], 1) for w in up + ("wq", "wk", "wv",
                                                     "w_i", "w_f"))
            and run.split_on(p["w_down"], 0)):
        o, nc = xlstm.apply_mlstm_block(cfg, run.full(p, lead), h,
                                        cache=g.cache(cache, lead),
                                        pos=g.ctx.pos)
        return o, _lead_tiles(nc, lead)
    b, s, _ = h.shape
    nh, di = p["b_i"].shape[0], p["w_down"].shape[0]
    dh = di // nh
    ups, gates = [], []
    for pos in g.ranks:
        hm = g.bcast(h, pos)
        ups.append(hm @ run.piece(p["w_up"], pos, 1).to(hm.dtype))
        gates.append(silu(hm @ run.piece(p["w_up_gate"], pos, 1).to(
            hm.dtype)))
    hflat, tiles = [], {}
    for pos, up in zip(g.ranks, g.all_gather(ups, -1)):
        lo, hi = g.span(nh, pos)
        dt = up.dtype
        q = torch.einsum("bsd,dhk->bshk", up,
                         run.piece(p["wq"], pos, 1).to(dt)) * (
            torch.tensor(dh ** -0.5, dtype=dt, device=up.device))
        k = torch.einsum("bsd,dhk->bshk", up, run.piece(p["wk"], pos, 1).to(dt))
        v = torch.einsum("bsd,dhk->bshk", up, run.piece(p["wv"], pos, 1).to(dt))
        upf = up.float()
        log_i = upf @ run.piece(p["w_i"], pos, 1).float() + run.full(
            p["b_i"], pos)[lo:hi]
        log_f = F.logsigmoid(upf @ run.piece(p["w_f"], pos, 1).float()
                             + run.full(p["b_f"], pos)[lo:hi])
        state = _head_state(
            g.cache(cache, pos, {"c": 1, "n": 1, "m": 1}, (lo, hi)),
            xlstm.init_mlstm_cache(cfg, b, up.device), lo, hi)
        hout, state = xlstm.mlstm_cell(q, k, v, log_i, log_f, state, dt)
        hflat.append(hout.reshape(b, s, (hi - lo) * dh))
        _add_tiles(tiles, dict(state), 1, pos)
    parts = []
    for pos, hn, gate, up in zip(g.ranks, _rms_parts(
            g, hflat, p["out_norm_scale"], di), gates, ups):
        lo, hi = g.span(di, pos)
        mixed = hn * gate + run.full(p["skip_scale"], pos)[lo:hi].to(
            up.dtype) * up
        parts.append(_partial("bsi,id->bsd", mixed,
                              run.piece(p["w_down"], pos, 0)))
    return _sum(parts, h.dtype), tiles


def _on_model(w) -> bool:
    """Whether a leaf's spec names the model axis on any dim."""
    return any("model" in (e if isinstance(e, tuple) else (e,))
               for e in getattr(w, "spec", ()))


def _mlstm_inner(cfg, p: dict, h, g: Group, cache):
    """The mLSTM with its inner width split over model and its heads
    whole (heads that do not divide model; ``wq``/``wk``/``wv``
    replicated): ``up`` and the gate as column blocks per position, q,
    k, v and the input and forget gates as partial sums over di reduced
    onto the lead, the cell there on every head, its normed output's
    column blocks sent back for the skip and the row-parallel
    down-projection."""
    run, lead = g.run, g.lead
    b, s, _ = h.shape
    nh, di = p["b_i"].shape[0], p["w_down"].shape[0]
    dt = h.dtype
    ups, gates = [], []
    parts: dict = {k: [] for k in ("wq", "wk", "wv", "w_i", "w_f")}
    for pos in g.ranks:
        hm = g.bcast(h, pos)
        lo, hi = g.span(di, pos)
        up = hm @ run.piece(p["w_up"], pos, 1).to(dt)
        ups.append(up)
        gates.append(silu(hm @ run.piece(p["w_up_gate"], pos, 1).to(dt)))
        for w in ("wq", "wk", "wv"):     # replicated: this position's rows
            parts[w].append(_partial("bsd,dhk->bshk", up,
                                     run.full(p[w], pos)[lo:hi]))
        for w in ("w_i", "w_f"):
            parts[w].append(up.float() @ run.piece(p[w], pos, 0).float())
    q = _sum(parts["wq"], dt) * torch.tensor((di // nh) ** -0.5, dtype=dt,
                                             device=h.device)
    k, v = _sum(parts["wk"], dt), _sum(parts["wv"], dt)
    log_i = place.all_reduce(parts["w_i"]) + run.full(p["b_i"], lead)
    log_f = F.logsigmoid(place.all_reduce(parts["w_f"])
                         + run.full(p["b_f"], lead))
    state = g.cache(cache, lead) or xlstm.init_mlstm_cache(cfg, b, h.device)
    hout, state = xlstm.mlstm_cell(q, k, v, log_i, log_f, state, dt)
    hn = xlstm._rms(hout.reshape(b, s, di), run.full(p["out_norm_scale"],
                                                     lead))
    out = []
    for pos, gate, up in zip(g.ranks, gates, ups):
        lo, hi = g.span(di, pos)
        mixed = g.bcast(hn[..., lo:hi], pos) * gate + run.full(
            p["skip_scale"], pos)[lo:hi].to(dt) * up
        out.append(_partial("bsi,id->bsd", mixed,
                            run.piece(p["w_down"], pos, 0)))
    return _sum(out, dt), _lead_tiles(dict(state), lead)


def _slstm_dh(cfg, p: dict, h, g: Group, cache):
    """The sLSTM with its state width dh split over model (heads that do
    not divide model): each position projects its dh columns of every
    head's gates and keeps its dh columns of the state; each timestep's
    recurrent product, over the whole dh, is a partial sum per position
    (``r_zifo``'s rows) reduced in mesh order and cut back to each
    position's columns.  The normed output is assembled on the lead for
    the post MLP."""
    run, lead = g.run, g.lead
    b, s, d = h.shape
    dh = p["r_zifo"].shape[2]
    zx, rz, bz, states = [], [], [], []
    for pos in g.ranks:
        lo, hi = g.span(dh, pos)
        hm = g.bcast(h, pos)
        zx.append(torch.einsum("bsd,dghk->sbghk", hm.float(),
                               run.piece(p["w_zifo"], pos, 3).float()))
        rz.append(run.piece(p["r_zifo"], pos, 2).float())
        bz.append(run.region(p["b_zifo"], {2: (lo, hi)}, pos).float())
        states.append(_head_state(
            g.cache(cache, pos, dict.fromkeys("cnmh", 2), (lo, hi)),
            xlstm.init_slstm_cache(cfg, b, hm.device), lo, hi, 2))
    hs: list = [[] for _ in g.ranks]
    for t in range(s):
        partial = [torch.einsum("bhk,ghkl->bghl", st["h"], r)
                   for st, r in zip(states, rz)]
        for j, pos in enumerate(g.ranks):
            lo, hi = g.span(dh, pos)
            zr = g.bcast(place.all_reduce([x[..., lo:hi] for x in partial]),
                         pos)
            states[j] = xlstm.slstm_update(states[j], zx[j][t] + zr + bz[j])
            hs[j].append(states[j]["h"])
    y = torch.cat([g.to_lead(torch.stack(hj, dim=1), pos)
                   for hj, pos in zip(hs, g.ranks)], dim=-1)
    y = xlstm._rms(y.reshape(b, s, d).to(h.dtype),
                   run.full(p["norm_scale"], lead))
    tiles: dict = {}
    for pos, st in zip(g.ranks, states):
        _add_tiles(tiles, st, 2, pos)
    return y, tiles


def slstm_mixer(cfg, p: dict, h, g: Group, cache):
    """The sLSTM block of normed rows ``h`` with its heads split over
    model, or its state width where the heads do not divide model
    (:func:`_slstm_dh`): (output on the lead, state tiles)."""
    run, lead = g.run, g.lead
    mlp = {"w_in": p["w_mlp_in"], "w_gate": p["w_mlp_gate"],
           "w_out": p["w_mlp_out"]}
    silu_cfg = dataclasses.replace(cfg, act="silu")
    if run.split_on(p["w_zifo"], 3) and run.split_on(p["r_zifo"], 2):
        y, tiles = _slstm_dh(cfg, p, h, g, cache)
        return ffn(silu_cfg, mlp, y, g), tiles
    if not (run.split_on(p["w_zifo"], 2) and run.split_on(p["r_zifo"], 1)):
        o, nc = xlstm.apply_slstm_block(cfg, run.full(p, lead), h,
                                        cache=g.cache(cache, lead),
                                        pos=g.ctx.pos)
        return o, _lead_tiles(nc, lead)
    b, s, d = h.shape
    nh = p["r_zifo"].shape[1]
    ys, tiles = [], {}
    for pos in g.ranks:
        lo, hi = g.span(nh, pos)
        hm = g.bcast(h, pos)
        zifo_x = torch.einsum("bsd,dghk->sbghk", hm.float(),
                              run.piece(p["w_zifo"], pos, 2).float())
        r_zifo = run.piece(p["r_zifo"], pos, 1).float()
        # the policy lays b_zifo out on dh: its heads' block, read once
        b_zifo = run.region(p["b_zifo"], {1: (lo, hi)}, pos).float()
        state = _head_state(
            g.cache(cache, pos, dict.fromkeys("cnmh", 1), (lo, hi)),
            xlstm.init_slstm_cache(cfg, b, hm.device), lo, hi)
        hs = []
        for t in range(s):
            state = xlstm._slstm_step(r_zifo, b_zifo, state, zifo_x[t])
            hs.append(state["h"])
        ys.append(torch.stack(hs, dim=1).reshape(b, s, -1).to(h.dtype))
        _add_tiles(tiles, state, 1, pos)
    y = g.all_gather(_rms_parts(g, ys, p["norm_scale"], d), -1)
    # the gated post MLP is a SwiGLU FFN: split as the policy splits it
    return ffn(silu_cfg, mlp, y[0], g, y), tiles


_MIXERS = {"rg": ("rglru", rglru_mixer), "ml": ("mlstm", mlstm_mixer),
           "sl": ("slstm", slstm_mixer)}


# ---------------------------------------------------------------- block
def block(cfg, p: dict, kind: str, xi, g: Group, cache, *, decoder: bool,
          mode=None):
    """``transformer.apply_block`` of group ``g``'s rows ``xi`` (on the
    lead): (x_i, cache tiles {key: (model-split dim or None, {pos:
    piece})}, the MoE's per-chunk aux sums or None).  ``mode`` is the
    self-attention's (``parallel._attn_mode``)."""
    run, lead = g.run, g.lead
    if kind in tfm.ATTN_KINDS:
        xi, tiles = self_attention(cfg, p, kind, xi, g, cache, mode)
        if tfm._has_cross(cfg, kind, decoder):
            xi, more = cross_attention(cfg, p, xi, g, cache)
            tiles.update(more)
        h = apply_norm(cfg, run.full(p["norm2"], lead), xi)
        if kind == "gm":
            f, sums = moe(cfg, p["moe"], h, g)
            return xi + f, tiles, sums
        return xi + ffn(cfg, p["ffn"], h, g), tiles, None
    if kind not in _MIXERS:
        raise ValueError(f"unknown block kind {kind!r}")
    name, mixer = _MIXERS[kind]
    h = apply_norm(cfg, run.full(p["norm1"], lead), xi)
    o, tiles = mixer(cfg, p[name], h, g, cache)
    xi = xi + o
    if kind == "rg":
        h2 = apply_norm(cfg, run.full(p["norm2"], lead), xi)
        xi = xi + ffn(cfg, p["ffn"], h2, g)
    return xi, tiles, None


__all__ = ["Group", "block", "self_attention", "cross_attention", "ffn",
           "moe", "rglru_mixer", "mlstm_mixer", "slstm_mixer"]
