"""The model under a (data, model) mesh: how the port runs the forward,
the loss and the serving steps on parameters, caches and batches laid
out by the sharding policy (``policy.param_specs``, ``cache_spec``,
``batch_spec``) as :class:`~repro_torch.sharding.place.Sharded` leaves.

The reference lets GSPMD partition one jitted program.  The port keeps
its one controller and says explicitly where each piece runs:

* **Batch shards** (:class:`MeshRun`).  The batch's spec names the axes
  its rows are split over: ``(pod, data)`` in the hybrid layout, every
  axis in the dp layout, none when the batch does not divide them.  Each
  batch shard is a *group* of positions; every group runs the same
  block on its rows, one after another in mesh order.
* **Model axis.**  Where the batch is not split over ``model``, a group
  holds one position per model coordinate, and every block kind splits
  its compute there as its leaves' specs say (:mod:`.blocks`): attention
  (self and cross) over heads, the dense FFN and arctic's residual over
  the hidden dim, MoE experts over E (or their hidden dim), the RG-LRU
  over its width, the xLSTM cells over heads; each position's (b, s, d)
  partial formed in fp32 and summed in mesh order
  (:func:`place.all_reduce`), the sum rounded once to the activation
  dtype.  The embedding's vocab rows are looked up
  with a mask and summed (exact); the loss head's vocab columns reduced
  by their max and sum of exponentials (:func:`group_xent`).  Heads that
  do not divide ``model`` take sequence-parallel attention in training
  where the active rules (``ctx.rules``) ask for ``attn_q``: each
  position computes its query rows against whole K/V.  A leaf is
  gathered at use onto the group's first position only where the policy
  replicates it over ``model``.
* **MoE aux.**  Each chunk's Switch term is taken once, from its
  per-expert sums reduced over the groups in mesh order: the whole
  batch's term, as GSPMD computes it.
* **FSDP.**  A weight split over ``data`` is gathered at use, one cycle
  at a time inside ``apply_stack``'s loop (and again in the backward of
  a rematerialised cycle, :func:`remat`), never the whole tree at once.
* **Backward.**  Autograd runs through the copies, concatenations and
  sums, so the gradient of a gathered weight lands on its shards summed
  over the groups (a reduce-scatter); copies of one block on distinct
  devices are summed in mesh order afterwards (``launch.steps``).

Neither ``torch.distributed`` nor DTensor nor ``torch.compile`` is used:
NCCL cannot put two ranks on one GPU, so one card could never hold a
mesh of several positions through it, and a collective in mesh order
under one controller makes every step deterministic on any number of
cards.  A copy between two cards of one host is a peer copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.placement import tree_flatten
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import aux_term
from repro_torch.sharding import blocks
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import place, sampling
from repro_torch.sharding.mesh import move_to
from repro_torch.sharding.place import Sharded, _entry_axes
from repro_torch.sharding.policy import batch_axes, tree_map_with_path

class MeshRun:
    """How one call lays its batch over ``mesh``: ``batch_entry`` the
    spec entry of the batch dim (axes, or None when replicated),
    ``groups`` the batch shards in mesh order, each a list of positions
    — one per model coordinate when the batch is not split over
    ``model``, else one — the first being the group's lead."""

    def __init__(self, mesh, batch_entry):
        axes = _entry_axes(batch_entry)
        self.mesh = mesh
        self.batch_entry = axes or None
        names = list(mesh.shape)
        self.split_model = (mesh.shape.get("model", 1) > 1
                            and "model" not in axes)
        groups: dict = {}
        for pos in place.positions(mesh):
            coords = dict(zip(names, pos))
            g = 0
            for a in axes:
                g = g * mesh.shape[a] + coords[a]
            ranks = groups.setdefault(g, [])
            if not ranks or (self.split_model and coords["model"] not in
                             {dict(zip(names, r))["model"] for r in ranks}):
                ranks.append(pos)
        self.groups = [groups[g] for g in sorted(groups)]

    def device(self, pos) -> torch.device:
        return place.position_device(self.mesh, pos)

    def each(self, fn: Callable) -> list:
        """``[fn(i) for each group i]``, in mesh order (in a dry run's
        ``sampling.sample``, stand-ins past its live groups)."""
        n = len(self.groups)
        live = sampling.live_groups(n)
        if live < n and any(torch.device(d).type != "meta"
                            for d in self.mesh.devices.flat):
            raise ValueError("only a mesh of meta positions may be sampled")
        outs = [fn(i) for i in range(live)]
        return outs + [sampling.stand_in(outs[0], dict(zip(
            self.groups[0], self.groups[i]))) for i in range(live, n)]

    def model_index(self, pos) -> int:
        return dict(zip(self.mesh.shape, pos))["model"]

    # ------------------------------------------------------- activations
    def rows(self, i: int, b: int) -> tuple[int, int]:
        n = b // len(self.groups)
        return i * n, (i + 1) * n

    def region(self, x, sel: dict, pos) -> Optional[torch.Tensor]:
        """The part of ``x`` selected by ``sel`` (dim -> (lo, hi); other
        dims whole) on ``pos``'s device.  ``x`` is a Sharded, a tensor
        (any device: an input the caller made) or None."""
        if x is None:
            return None
        dev = self.device(pos)
        if isinstance(x, Sharded):
            reg = [sel.get(d, (0, n)) for d, n in enumerate(x.shape)]
            return place.assemble(x, reg, dev, pos)
        for d, (lo, hi) in sel.items():
            x = x.narrow(d, lo, hi - lo)
        return move_to(x, dev)

    def local(self, x, i: int, pos=None, dim: int = 0):
        """Group ``i``'s rows (batch dim ``dim``) of ``x`` on ``pos``'s
        device (default: the group's lead); a tree of such leaves
        (cache dicts) row by row."""
        pos = self.groups[i][0] if pos is None else pos
        if isinstance(x, dict):
            return {k: self.local(v, i, pos, dim) for k, v in x.items()}
        if x is None:
            return None
        return self.region(x, {dim: self.rows(i, x.shape[dim])}, pos)

    def act(self, parts: list, dim: int = 0) -> Sharded:
        """Per-group pieces (each on its lead) as one activation split on
        ``dim`` over the batch axes and replicated over the rest: on
        every position of the group (one tensor per device)."""
        spec = (None,) * dim + (self.batch_entry,)
        shape = list(parts[0].shape)
        shape[dim] *= len(parts)
        tiles = {g[0]: p for g, p in zip(self.groups, parts)}
        return Sharded(self.mesh, spec, shape, parts[0].dtype,
                       tiles).relayout(spec)

    def from_tiles(self, tiles: dict, spec: tuple, shape, like=None):
        """A Sharded from pieces held by some positions (``tiles``: pos
        -> block of ``spec``), re-laid as ``like`` (a Sharded) is, or by
        ``spec``."""
        t0 = next(iter(tiles.values()))
        x = Sharded(self.mesh, spec, shape, t0.dtype, tiles)
        return x.relayout(like.spec if like is not None else x.spec)

    def ctx_for(self, ctx, i: int, pos):
        """``ctx`` with its batch-first tensors cut to group ``i``'s rows
        on ``pos``'s device, for the unsharded code."""
        return dataclasses.replace(
            ctx, run=None,
            cos=self.local(ctx.cos, i, pos), sin=self.local(ctx.sin, i, pos),
            q_pos=self.local(ctx.q_pos, i, pos),
            enc_out=self.local(ctx.enc_out, i, pos))

    # ---------------------------------------------------------- weights
    def full(self, tree, pos):
        """Every Sharded leaf of ``tree`` whole on ``pos``'s device (a
        gather at use); tensors moved there."""
        if isinstance(tree, dict):
            return {k: self.full(v, pos) for k, v in tree.items()}
        if isinstance(tree, Sharded):
            return place.assemble(tree, [(0, n) for n in tree.shape],
                                  self.device(pos), pos)
        return move_to(tree, self.device(pos))

    def piece(self, w: Sharded, pos, dim: int) -> torch.Tensor:
        """``pos``'s model-axis block of ``w`` along ``dim`` (the dim its
        spec splits over ``model``), gathered over every other axis."""
        n = w.shape[dim] // self.mesh.shape["model"]
        m = self.model_index(pos)
        return self.region(w, {dim: (m * n, (m + 1) * n)}, pos)

    def split_on(self, w, dim: int) -> bool:
        """Whether ``w``'s spec splits ``dim`` over ``model`` alone."""
        return (self.split_model and isinstance(w, Sharded)
                and w.spec[dim] == "model")


def run_for(params, batch: dict) -> Optional[MeshRun]:
    """The :class:`MeshRun` of a call on ``params`` (None when no leaf of
    them is Sharded).  A Sharded batch brings its batch spec; a plain
    one is split as ``policy.batch_spec``'s hybrid rule splits it."""
    mesh = next((x.mesh for x in tree_flatten(params)[0]
                 if isinstance(x, Sharded)), None)
    if mesh is None:
        return None
    lead = batch.get("tokens", batch.get("inputs_embeds"))
    if isinstance(lead, Sharded):
        return MeshRun(mesh, lead.spec[0])
    axes = batch_axes(mesh)
    n = int(np.prod([mesh.shape[a] for a in axes]))
    return MeshRun(mesh, axes if n > 1 and lead.shape[0] % n == 0 else None)


# ------------------------------------------------------------- remat
class _Remat(torch.autograd.Function):
    """One function of tensors run without keeping its activations and
    run again in the backward, once, inside this node's backward.
    ``torch.utils.checkpoint``'s non-reentrant frames cannot serve a
    region that spans several devices: the autograd engine runs each
    device's nodes on its own thread, two threads unpack the same frame
    and both start its recomputation."""

    @staticmethod
    def forward(ctx, run_fn, *tensors):
        ctx.run_fn = run_fn
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return run_fn(*tensors)

    @staticmethod
    def backward(ctx, *gouts):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.run_fn(*ins)
        ctx.run_fn = None           # its closure holds the inputs' shards
        used = [(o, g) for o, g in zip(outs, gouts)
                if o.requires_grad and g is not None]
        wants = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in used], wants, [g for _, g in used],
            allow_unused=True) if used else [None] * len(wants))
        return (None,) + tuple(next(grads) if t.requires_grad else None
                               for t in ins)


def remat(cycle, x: Sharded, aux, c: int, cycles, ctx):
    """``cycle(x, aux, c, cycles, ctx)`` (one cycle of ``apply_stack`` in
    training, its stacked parameters ``cycles``) with its activations
    recomputed in the backward: the role ``torch.utils.checkpoint``
    plays unsharded.  The shards of ``x``, ``aux``, the encoder's output
    ``ctx.enc_out`` and every parameter shard are the node's inputs, so
    their gradients come back through it.  Returns (x, aux, [None] *
    blocks): training keeps no cache."""
    xs = x.unique()
    enc = ctx.enc_out
    es = enc.unique() if isinstance(enc, Sharded) else []
    ps = list({id(t): t for leaf in tree_flatten(cycles)[0]
               for t in (leaf.unique() if isinstance(leaf, Sharded)
                         else [leaf])}.values())
    layout: dict = {}

    def run_fn(*ts):
        sub = {id(a): b for a, b in zip(xs + [aux] + es + ps, ts)}
        swap = (lambda leaf: leaf.map(lambda t: sub[id(t)])
                if isinstance(leaf, Sharded) else sub[id(leaf)])
        cx = dataclasses.replace(ctx, enc_out=swap(enc)) if es else ctx
        ox, oa, caches = cycle(x.map(lambda t: sub[id(t)]), ts[len(xs)], c,
                               tree_map_with_path(lambda _, leaf: swap(leaf),
                                                  cycles), cx)
        uniq = ox.unique()
        if not layout:      # the output's layout, not its tensors: keeping
            index = {id(t): i for i, t in enumerate(uniq)}   # them would
            layout.update(spec=ox.spec, shape=ox.shape,      # tie the node
                          blocks=len(caches), where={        # to itself
                              pos: index[id(t)]
                              for pos, t in ox.shards.items()})
        return tuple(uniq) + (oa,)

    outs = _Remat.apply(run_fn, *xs, aux, *es, *ps)
    ox = Sharded(x.mesh, layout["spec"], layout["shape"], outs[0].dtype,
                 {pos: outs[i] for pos, i in layout["where"].items()})
    return ox, outs[-1], [None] * layout["blocks"]


# ------------------------------------------------------------ blocks
def apply_block(cfg, p, kind: str, x: Sharded, ctx, cache, *,
                decoder: bool):
    """``transformer.apply_block`` on a Sharded residual stream: (x,
    new_cache, aux), each group's block run by :func:`blocks.block`.  A
    Sharded cache comes back laid out as it came; a plain one (training's
    zero stubs) gives None.  An MoE's aux is each chunk's Switch term of
    the groups' sums reduced in mesh order (the whole batch's), averaged
    over chunks; other kinds' is 0."""
    run = ctx.run
    mode = (_attn_mode(cfg, p["attn"], run, ctx, x)
            if kind in tfm.ATTN_KINDS else None)
    xs, tiles, sums = [], {}, []
    for xi, ti, si in run.each(lambda i: blocks.block(
            cfg, p, kind, run.local(x, i), blocks.Group(run, i, ctx), cache,
            decoder=decoder, mode=mode)):
        xs.append(xi)
        for k, (dim, t) in ti.items():
            tiles.setdefault(k, (dim, {}))[1].update(t)
        if si is not None:
            sums.append(si)
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    if sums:
        for chunk in zip(*sums):        # one chunk's sums of every group
            routed, probs, n = zip(*chunk)
            aux = aux + aux_term(cfg, place.all_reduce(list(routed)),
                                 place.all_reduce(list(probs)), sum(n))
        aux = aux / len(sums[0])
    new_cache = None
    if isinstance(cache, dict) and any(isinstance(v, Sharded)
                                       for v in cache.values()):
        new_cache = _cache_out(run, cache, tiles)
    return run.act(xs), new_cache, aux


def _cache_out(run: MeshRun, cache: dict, tiles: dict) -> dict:
    """The groups' new cache pieces (``tiles``: key -> (the dim split
    over model, or None for a piece whole on its lead; {pos: piece})) as
    Sharded leaves laid out like ``cache``'s."""
    out = {}
    for k, like in cache.items():
        dim, ts = tiles[k]
        spec = [run.batch_entry] + [None] * (like.ndim - 1)
        if dim is not None:
            spec[dim] = "model"
        out[k] = run.from_tiles(ts, tuple(spec), like.shape, like)
    return out


def _attn_mode(cfg, pa: dict, run: MeshRun, ctx, x: Sharded) -> str:
    """"heads" (query heads column-, wo row-parallel: heads that divide
    model), "seq" (query rows over model, training under an ``attn_q``
    rule) or "gather" (the policy replicates the projections)."""
    if run.split_on(pa["wq"], 1) and run.split_on(pa["wo"], 0):
        return "heads"
    shape = (x.shape[0], x.shape[1], cfg.n_heads, cfg.head_dim)
    if ctx.mode == "train" and shctx.spec_for("attn_q", shape) is not None:
        return "seq"
    return "gather"


def per_group(run: MeshRun, fn, x: Sharded, params) -> Sharded:
    """``fn(x_i, params)`` on each group's rows with ``params`` gathered
    at use on its lead (a norm, a cast), as one activation."""
    return run.act(run.each(lambda i: fn(run.local(x, i),
                                         run.full(params, run.groups[i][0]))))


# ----------------------------------------------------- embed and head
def embed(run: MeshRun, params, batch: dict, dtype) -> Sharded:
    """The embedding of the batch as a Sharded (b, s, d) activation.  A
    vocab split over ``model``: each position looks its rows up with a
    mask, and the groups' partials are summed (one nonzero: exact)."""
    if "inputs_embeds" in batch:
        return run.act(run.each(
            lambda i: run.local(batch["inputs_embeds"], i).to(dtype)))
    table = params["embed"]

    def part(i):
        ranks = run.groups[i]
        if not run.split_on(table, 0):
            return run.full(table, ranks[0])[
                run.local(batch["tokens"], i)].to(dtype)
        rows = []
        for pos in ranks:
            piece = run.piece(table, pos, 0)
            n = piece.shape[0]
            idx = run.local(batch["tokens"], i, pos).long() \
                - run.model_index(pos) * n
            ok = (idx >= 0) & (idx < n)
            r = piece[idx.clamp(0, n - 1)]
            rows.append(torch.where(ok[..., None], r, r.new_zeros(())))
        return place.all_reduce(rows).to(dtype)
    return run.act(run.each(part))


def head_pieces(run: MeshRun, model, params, i: int) -> list:
    """[(pos, (d, V_pos) head block, first vocab index)] of group ``i``:
    one per model position when the head's vocab is split over
    ``model``, else the whole head on the lead."""
    tied = model.cfg.tie_embeddings
    w = params["embed"] if tied else params["lm_head"]
    vdim = 0 if tied else 1
    ranks = run.groups[i]
    if run.split_on(w, vdim):
        out = []
        for pos in ranks:
            blk = run.piece(w, pos, vdim)
            n = blk.shape[vdim]
            out.append((pos, blk.T if tied else blk,
                        run.model_index(pos) * n))
        return out
    full = run.full(w, ranks[0])
    return [(ranks[0], full.T if tied else full, 0)]


def group_xent(run: MeshRun, cfg, h: torch.Tensor, labels: torch.Tensor,
               pieces: list) -> torch.Tensor:
    """Sum of ``logsumexp - logit[label]`` over group rows ``h`` (on the
    lead), chunked over the sequence by ``cfg.loss_chunk`` as
    ``Model.loss``: each head block's bf16 logits taken to fp32
    (softcapped), the max and the sum of exponentials reduced across the
    blocks in mesh order, the label's logit from the block holding it."""
    b, s, _ = h.shape
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    lead = h.device
    for c in range(0, s, chunk):
        hc, lab = h[:, c:c + chunk], labels[:, c:c + chunk].long()
        logits = []
        for pos, blk, _ in pieces:
            hm = hc if pos == pieces[0][0] else place.broadcast(
                hc, run.device(pos))
            lg = (hm @ blk.to(hm.dtype)).float()
            if cfg.logit_softcap:
                lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
            logits.append(lg)
        mx = logits[0].detach().amax(-1)
        for lg in logits[1:]:
            mx = torch.maximum(mx, move_to(lg.detach().amax(-1), lead))
        se = place.all_reduce([
            torch.exp(lg - move_to(mx, lg.device)[..., None]).sum(-1)
            for lg in logits])
        lls = []
        for (pos, blk, lo), lg in zip(pieces, logits):
            idx = move_to(lab, lg.device) - lo
            ok = (idx >= 0) & (idx < lg.shape[-1])
            v = torch.take_along_dim(lg, idx.clamp(0, lg.shape[-1] - 1)[
                ..., None], dim=-1)[..., 0]
            lls.append(torch.where(ok, v, v.new_zeros(())))
        ll = place.all_reduce(lls)
        total = total + (mx + torch.log(se) - ll).sum()
    return total


def loss(model, params, batch: dict, *, remat: bool = True):
    """``Model.loss`` over a Sharded model: each group's cross entropy
    summed in mesh order over the global token count; aux the groups'
    mean."""
    h, _, aux = model.forward(params, batch, "train", remat=remat)
    run = run_for(params, batch)
    totals = run.each(lambda i: group_xent(
        run, model.cfg, run.local(h, i), run.local(batch["labels"], i),
        head_pieces(run, model, params, i)))
    b, s = h.shape[0], h.shape[1]
    xent = place.all_reduce(totals) / (b * s)
    return xent + 0.01 * aux, {"xent": xent, "aux": aux}


def logits(run: MeshRun, model, params, h: Sharded, *,
           last: bool = False) -> Sharded:
    """fp32 logits of Sharded hidden states (b, s, d) (of the last
    position only with ``last``): each head block's bf16 product,
    concatenated over the vocab on the group's lead."""
    def part(i):
        lead = run.groups[i][0]
        hi = run.local(h, i)
        if last:
            hi = hi[:, -1:]
        outs = []
        for pos, blk, _ in head_pieces(run, model, params, i):
            hm = hi if pos == lead else place.broadcast(hi, run.device(pos))
            lg = (hm @ blk.to(hm.dtype)).float()
            outs.append(lg if pos == lead
                        else place.broadcast(lg, run.device(lead)))
        return torch.cat(outs, dim=-1)
    return run.act(run.each(part))


__all__ = ["MeshRun", "run_for", "apply_block", "per_group", "embed",
           "head_pieces", "group_xent", "loss", "logits"]
