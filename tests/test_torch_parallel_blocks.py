"""Port parity — every block kind's compute split over the ``model`` axis
(``repro_torch.sharding.blocks``): MoE experts (expert-, hidden- and
d_model-parallel), arctic's dense residual, the RG-LRU width, the
mLSTM / sLSTM heads, the encoder's attention and cross-attention; the
Switch aux loss over the global batch; microbatches cut from the global
batch; sharded serving of the four families; the bytes a forward moves.

Meshes are one-process meshes of CPU positions (``devices=["cpu"] *
n``), as in tests/test_torch_parallel.py, whose helpers and tolerances
this file reuses: the sharded steps are held against the port's and the
reference's UNSHARDED steps (the reference's own sharded path fails on
the installed jax, ROADMAP C).  Tolerances:

* loss within LOSS_ATOL = 1e-2, each gradient leaf within GRAD_RTOL =
  3e-2 relative L2 (the model axis sums bf16 partials in bf16); the
  configs are tests/test_torch_family_grads.py's, one layer per block
  kind, and its CANCELLING_LEAVES (xlstm's mLSTM gate biases and q/k
  projections, sums of mostly cancelling terms) are asserted finite;
* in float32 compute, where no bf16 rounding separates the sharded and
  unsharded steps, the loss within 1e-5 and EVERY gradient leaf within
  F32_RTOL = 1e-4;
* the MoE aux loss within AUX_RTOL = 1e-5 relative of the unsharded
  step's (fp32 rounding);
* logits within LOGIT_ATOL = 0.125, greedy tokens equal wherever the
  unsharded step's top-2 margin exceeds MARGIN = 0.25, recurrent states
  within LOGIT_ATOL;
* one block's bf16 output on unit-variance inputs within BLOCK_RTOL =
  1e-2 relative L2 (a few bf16 steps of 2^-8);
* bytes moved between positions: exact.
"""
import contextlib
import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Model as RModel
from repro_torch.core.placement import tree_flatten
from repro_torch.launch import steps as tsteps
from repro_torch.models import Model, numpy_params, params_from_numpy
from repro_torch.models import model as model_mod
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import positions_to_angles
from repro_torch.sharding import blocks, parallel, place, policy
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding.place import Sharded
from test_torch_family_grads import CANCELLING_LEAVES
from test_torch_models import RoutingReplay
from test_torch_parallel import (GRAD_RTOL, LOGIT_ATOL, LOSS_ATOL, MARGIN,
                                 cfgs, laid_batch, laid_state, lay, mesh_of,
                                 np_batch, rel_l2, t_batch, whole)

AUX_RTOL = 1e-5
F32_RTOL = 1e-4
BLOCK_RTOL = 1e-2

# (arch, overrides): tests/test_torch_family_grads.py's configs, one layer
# per block kind; arctic's reduced tree in float32 as there
KINDS = {
    "gm": ("granite-moe-1b-a400m", {}),
    "gm-residual": ("arctic-480b", {"param_dtype": "float32"}),
    "rg-la": ("recurrentgemma-2b", {}),
    "ml-sl": ("xlstm-1.3b", {}),
    "enc-cross": ("whisper-medium", {}),
    # 6 experts on model 4: the experts' hidden dim splits instead
    "gm-hidden": ("granite-moe-1b-a400m", {"n_experts": 6}),
    # neither 6 experts nor a hidden dim of 30 divide 4: d_model splits
    "gm-d_model": ("granite-moe-1b-a400m", {"n_experts": 6, "moe_dff": 30}),
    # a dense hidden dim of 66 on model 4: d_model row- then column-split
    "ffn-d_model": ("qwen3-4b", {"d_ff": 66}),
    # an RG-LRU width of 66 on model 4: the gate and branch by d_model rows
    "rg-d_model": ("recurrentgemma-2b", {"rnn_width": 66}),
}
MOE_MODE = {"gm": "experts", "gm-residual": "experts", "gm-hidden": "hidden",
            "gm-d_model": "d_model"}


def kind_cfgs(case):
    arch, over = KINDS[case]
    from test_torch_family_grads import smoke_cfgs
    return smoke_cfgs(arch, **over)


def family_batch(cfg, b=2, s=32, seed=3) -> dict:
    """tests/test_torch_family_grads.py's batch (2 x 32, seed 3), the one
    its configs hold GRAD_RTOL on; frame embeddings for whisper."""
    nb = np_batch(cfg, b=b, s=s, seed=seed)
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(seed + 1)
        nb["enc_embeds"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return nb


def ref_loss(rcfg, tree, nb) -> float:
    """The reference's unsharded ``Model.loss`` (weights >= 2-D in bf16,
    as the train step casts them)."""
    import jax
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16)
        if x.dtype == np.float32 and x.ndim >= 2 else jnp.asarray(x), tree)
    return float(RModel(rcfg).loss(params, {k: jnp.asarray(v)
                                            for k, v in nb.items()},
                                   remat=False)[0])


def leaf_names(params) -> list:
    return tree_flatten(policy.tree_map_with_path(
        lambda names, _: "".join(f"['{n}']" if not n.startswith("[")
                                 else n for n in names), params))[0]


class GatherSpy:
    """Records every Sharded leaf that ``MeshRun.full`` gathers whole
    whose spec splits a dim over ``model`` alone (a tensor-parallel
    split, not FSDP)."""

    def __init__(self, monkeypatch):
        self.hits = []
        real = parallel.MeshRun.full

        def full(run, tree, pos):
            if isinstance(tree, Sharded) and "model" in tree.spec:
                self.hits.append((tuple(tree.shape), tree.spec))
            return real(run, tree, pos)
        monkeypatch.setattr(parallel.MeshRun, "full", full)


class ModeSpy:
    def __init__(self, monkeypatch):
        self.modes = []
        real = blocks._moe_mode
        monkeypatch.setattr(blocks, "_moe_mode",
                            lambda *a: self.modes.append(real(*a))
                            or self.modes[-1])


class ShardReplay:
    """Routing is a discontinuous function of the router logits: where two
    experts' logits sit within the bf16 noise that the model axis's bf16
    partial sums put into the hidden states, the sharded and unsharded
    steps may pick different experts, and that token's output moves by a
    whole expert's share (test_torch_models.RoutingReplay, across the
    packages).  So the unsharded step's top-k calls are recorded
    (``calls``: (probs, choices) each); each top-k call of the sharded
    step — a batch shard's rows of one chunk — then checks its choices
    against the recorded rows nearest its probabilities (every token
    where they differ must be a near-tie there, the swapped experts'
    log-probabilities within LOGIT_ATOL) and replays the recorded
    choices, so the rest is compared on equal routing."""

    def __init__(self, calls: list, monkeypatch):
        real = moe.top_k

        def top_k(probs, k):
            _, own = real(probs, k)
            p = probs.detach().float().numpy()
            n = p.shape[0]
            cands = [(c, r) for c in calls if c[0].shape[1:] == p.shape[1:]
                     for r in range(0, c[0].shape[0] - n + 1, n)]
            (rp, ridx), r = min(cands, key=lambda cr: float(np.abs(
                cr[0][0][cr[1]:cr[1] + n] - p).max()))
            rp, ridx, own = rp[r:r + n], ridx[r:r + n], own.numpy()
            for at in zip(*np.nonzero((np.sort(own, -1)
                                       != np.sort(ridx, -1)).any(-1))):
                mine = set(own[at].tolist()) - set(ridx[at].tolist())
                theirs = set(ridx[at].tolist()) - set(own[at].tolist())
                gap = max(abs(float(np.log(rp[at][a]) - np.log(rp[at][b])))
                          for a in mine for b in theirs)
                assert gap <= LOGIT_ATOL, (at, mine, theirs, gap)
            idx = torch.from_numpy(ridx.astype(np.int64))
            return torch.gather(probs, -1, idx), idx
        monkeypatch.setattr(moe, "top_k", top_k)

    @staticmethod
    def recording(calls: list):
        """A context recording every top-k call's (probs, choices)."""
        real = moe.top_k

        def top_k(probs, k):
            vals, idx = real(probs, k)
            calls.append((probs.detach().float().numpy(), idx.numpy()))
            return vals, idx

        @contextlib.contextmanager
        def ctx():
            moe.top_k = top_k
            try:
                yield
            finally:
                moe.top_k = real
        return ctx()


_UNSHARDED: dict = {}


def unsharded(case):
    """The port's unsharded loss, grads and top-k calls and the
    reference's loss of a case, computed once; an MoE's unsharded step
    on the reference's routing (``RoutingReplay``)."""
    if case not in _UNSHARDED:
        tcfg, rcfg = kind_cfgs(case)
        tree = numpy_params(tcfg, 5)
        nb = family_batch(tcfg)
        params = params_from_numpy(tree, device="cpu")
        calls: list = []
        with pytest.MonkeyPatch.context() as mp:
            # an MoE's reference routing replayed into the port's
            ref_mode = RoutingReplay.for_cfg(tcfg, mp)
            with ref_mode():
                rloss = ref_loss(rcfg, tree, nb)
            with ShardReplay.recording(calls):
                loss, metrics, grads = tsteps.accumulate_grads(
                    Model(tcfg), params, t_batch(nb), 1)
        _UNSHARDED[case] = {
            "cfg": tcfg, "tree": tree, "nb": nb, "params": params,
            "loss": float(loss), "aux": float(metrics["aux"]),
            "grads": tree_flatten(grads)[0], "top_k": calls,
            "rloss": rloss}
    return _UNSHARDED[case]


TRAIN_CASES = ([(k, (2, 2), "hybrid") for k in ("gm", "gm-residual", "rg-la",
                                                 "ml-sl", "enc-cross")]
               + [(k, (1, 4), "hybrid") for k in KINDS]
               # xlstm's 4 heads on 8: the mLSTM's inner width and the
               # sLSTM's dh split instead (the production axis of 16)
               + [("ml-sl", (1, 8), "hybrid")]
               + [(k, (2, 2), "dp") for k in ("gm", "rg-la")])


@pytest.mark.parametrize("case,shape,layout", TRAIN_CASES)
def test_sharded_train_step_matches_unsharded_and_reference(
        case, shape, layout, monkeypatch):
    """Each block kind's sharded loss and grads (one microbatch) against
    the port's unsharded step (an MoE's routing replayed from it,
    :class:`ShardReplay`) and the reference's loss.  Under the
    hybrid layout no leaf the policy splits over ``model`` is gathered
    whole (``MeshRun.full``), and an MoE takes the candidate its specs
    name (experts, hidden, d_model)."""
    u = unsharded(case)
    cfg = u["cfg"]
    mesh = mesh_of(shape)
    state = laid_state(u["params"], mesh, layout)
    sb = laid_batch(t_batch(u["nb"]), mesh, layout)
    spy, modes = GatherSpy(monkeypatch), ModeSpy(monkeypatch)
    if cfg.n_experts:
        ShardReplay(u["top_k"], monkeypatch)
    with shctx.rules(mesh, policy.activation_rules(cfg, mesh, "train",
                                                   layout)):
        loss, metrics, grads = tsteps.accumulate_grads(
            Model(cfg), state["params"], sb, 1)
    assert abs(float(loss) - u["loss"]) <= LOSS_ATOL
    assert abs(float(loss) - u["rloss"]) <= LOSS_ATOL
    skip = CANCELLING_LEAVES.get(KINDS[case][0], ())
    for name, g, w in zip(leaf_names(u["params"]), whole(grads), u["grads"]):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        if not name.endswith(skip):
            assert rel_l2(g, w) <= GRAD_RTOL, name
    if layout == "hybrid":
        assert spy.hits == []
        if case in MOE_MODE:
            assert modes.modes and set(modes.modes) == {MOE_MODE[case]}


F32_CASES = [(k, (1, 4)) for k in ("gm", "gm-residual", "rg-la", "ml-sl",
                                    "enc-cross", "gm-hidden", "gm-d_model",
                                    "ffn-d_model", "rg-d_model")] + [
    ("ml-sl", (1, 8))]


@pytest.mark.parametrize("case,shape", F32_CASES)
def test_split_is_exact_in_float32(case, shape, monkeypatch):
    """With bf16 out of the way (weights and activations in float32), the
    sharded step is the unsharded step up to fp32 rounding: the loss
    within 1e-5 and every gradient leaf, xlstm's cancelling ones
    included, within F32_RTOL."""
    monkeypatch.setattr(tsteps, "_compute_copy", lambda x: x)
    monkeypatch.setattr(model_mod, "COMPUTE_DTYPE", torch.float32)
    tcfg, _ = kind_cfgs(case)
    params = params_from_numpy(numpy_params(tcfg, 5), device="cpu")
    nb = t_batch(family_batch(tcfg))
    model = Model(tcfg)
    loss, metrics, grads = tsteps.accumulate_grads(model, params, nb, 1)
    mesh = mesh_of(shape)
    state = laid_state(params, mesh, "hybrid")
    with shctx.rules(mesh, policy.activation_rules(tcfg, mesh, "train")):
        sl, sm, sg = tsteps.accumulate_grads(model, state["params"],
                                             laid_batch(nb, mesh), 1)
    assert abs(float(sl) - float(loss)) <= 1e-5
    np.testing.assert_allclose(float(sm["aux"]), float(metrics["aux"]),
                               rtol=AUX_RTOL)
    for name, g, w in zip(leaf_names(params), whole(sg),
                          tree_flatten(grads)[0]):
        assert rel_l2(g, w) <= F32_RTOL, name


# -------------------------------------------------------------- MoE aux
def quiet(tree) -> dict:
    """``tree`` with every attention ``wo`` and expert ``w_out`` zero:
    the blocks add nothing to the residual stream, so every layer's
    router sees the embedding, bit for bit, on every mesh, and the aux
    losses differ only by how the Switch term is reduced.  (With the
    real weights the hidden states already part by bf16 steps between a
    batch shard's rows and the whole batch's on the CPU's GEMMs, and the
    aux by up to 2e-5 relative.)"""
    out = copy.deepcopy(tree)
    for blk in out["stack"]["cycles"]:
        blk["attn"]["wo"][:] = 0
        blk["moe"]["w_out"][:] = 0
    return out


def aux_of(model, params, batch, n_micro) -> float:
    """The train step's aux (the microbatches' mean) from forwards only."""
    with torch.no_grad():
        return float(sum(model.loss(params, mb, remat=False)[1]["aux"]
                         for mb in tsteps._split_micro(batch, n_micro))
                     / n_micro)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("rows", ["iid", "shifted"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)])
def test_moe_aux_is_the_global_batch_term(shape, rows, n_micro):
    """The reduced granite-moe batch (8 rows x 32 tokens, seed 6): the
    sharded aux equals the unsharded one to fp32 rounding on (data=2,
    model=1), (2, 2) and (4, 2) — each chunk's Switch term taken once,
    from its per-expert sums reduced over the batch shards — with the
    rows i.i.d. and with half of them shifted to other tokens; with 2
    microbatches cut from the global batch in the reference's order.  A
    mean of the shards' terms is off by 0.4-5%."""
    tcfg, _ = cfgs("granite-moe-1b-a400m")
    model = Model(tcfg)
    nb = np_batch(tcfg, b=8, s=32, seed=6)
    if rows == "shifted":
        nb["tokens"][4:] %= 16
    mesh = mesh_of(shape)
    params = params_from_numpy(quiet(numpy_params(tcfg, 5)), device="cpu")
    want = aux_of(model, params, t_batch(nb), n_micro)
    sp = lay(params, mesh, policy.param_specs(params, mesh))
    got = aux_of(model, sp, laid_batch(t_batch(nb), mesh), n_micro)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=AUX_RTOL)


def test_microbatches_are_global_batch_slices():
    """``_split_micro`` cuts a laid-out batch into contiguous slices of
    the global batch, each re-laid over the batch axes (the rows that
    change position counted), as the reference cuts its microbatches."""
    mesh = mesh_of((4, 2))
    x = torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3)
    pos = torch.arange(3 * 8 * 3, dtype=torch.int32).reshape(3, 8, 3)
    batch = {"tokens": x, "positions": pos}
    sb = lay(batch, mesh, {"tokens": (("data",), None),
                           "positions": (None, ("data",), None)})
    place.traffic.reset()
    parts = tsteps._split_micro(sb, 2)
    for i, mb in enumerate(parts):
        assert mb["tokens"].spec == sb["tokens"].spec
        assert torch.equal(mb["tokens"].gather(), x[4 * i:4 * (i + 1)])
        assert torch.equal(mb["positions"].gather(),
                           pos[:, 4 * i:4 * (i + 1)])
        # data shard j of microbatch i holds global row 4 i + j
        assert torch.equal(mb["tokens"].shards[(1, 0)], x[4 * i + 1][None])
    # of each microbatch's 4 rows, 3 come from another shard
    assert place.traffic.gather_bytes == 2 * 3 * (3 * 4 + 3 * 3 * 4)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_expert_slices_change_no_routing(n):
    """Capacity and each choice's place in its expert's queue are per
    expert column, so a position's dispatch and combine weights of its
    E/n experts are the whole routing's, cut: slicing the experts changes
    no routing decision."""
    cfg, _ = cfgs("granite-moe-1b-a400m")
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal(
        (2, 16, cfg.n_experts)).astype(np.float32))
    cap = moe._capacity(16, cfg)
    r = moe.route(cfg, logits, cap)
    disp, comb = moe.dispatch(cfg, r, cap)
    k = cfg.n_experts // n
    for j in range(n):
        d, c = moe.dispatch(cfg, r, cap, j * k, k)
        assert torch.equal(d, disp[:, :, j * k:(j + 1) * k])
        assert torch.equal(c, comb[:, :, j * k:(j + 1) * k])


# ---------------------------------------------------------------- serving
SERVE = [("granite-moe-1b-a400m", (2, 2)), ("whisper-medium", (2, 2)),
         ("recurrentgemma-2b", (2, 2)), ("xlstm-1.3b", (2, 2)),
         ("whisper-medium", (1, 4)), ("recurrentgemma-2b", (1, 4)),
         ("xlstm-1.3b", (1, 4)), ("xlstm-1.3b", (1, 8))]


@pytest.mark.parametrize("arch,shape", SERVE)
def test_sharded_prefill_and_decode_per_family(arch, shape):
    """The four families' prefill and 3 decode steps on parameters laid
    out by the hybrid specs and caches by ``cache_spec`` (the mLSTM's
    ``c`` / ``n`` and the sLSTM's states split on dh, the RG-LRU's on its
    width, KV caches on heads or head_dim): logits within LOGIT_ATOL of
    the unsharded steps', greedy tokens equal where the unsharded top-2
    margin exceeds MARGIN, each returned cache laid out as
    ``cache_spec`` says and within LOGIT_ATOL of the unsharded cache."""
    tcfg, _ = kind_cfgs({"granite-moe-1b-a400m": "gm",
                         "whisper-medium": "enc-cross",
                         "recurrentgemma-2b": "rg-la",
                         "xlstm-1.3b": "ml-sl"}[arch])
    model = Model(tcfg)
    params = params_from_numpy(numpy_params(tcfg, 7), device="cpu")
    b, s, new = 4, 16, 4
    nb = family_batch(tcfg, b=b, s=s, seed=8)
    feed = np.random.default_rng(9).integers(0, tcfg.vocab_size,
                                             (new, b, 1)).astype(np.int32)
    batch = {k: torch.from_numpy(v) for k, v in nb.items() if k != "labels"}
    mesh = mesh_of(shape)
    sp = lay(params, mesh, policy.param_specs(params, mesh))
    prefill = tsteps.make_prefill_step(model, max_len=s + new, q_chunk=None)
    decode = tsteps.make_decode_step(model, max_len=s + new)
    (w, wc), (g, gc) = prefill(params, batch), prefill(
        sp, laid_batch(batch, mesh))
    specs = policy.cache_spec(wc, mesh, batch=b)
    for t in range(new):
        g = g.gather()
        assert float((g - w).abs().max()) <= LOGIT_ATOL
        top2 = w.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > MARGIN
        assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure])
        for got, want, spec in zip(tree_flatten(gc)[0], tree_flatten(wc)[0],
                                   tree_flatten(policy.tree_map_with_path(
                                       lambda _, x: repr(x), specs,
                                       is_leaf=policy.is_spec))[0]):
            assert repr(got.spec) == spec
            assert float((got.gather().float() - want.float()).abs().max()
                         ) <= LOGIT_ATOL
        if t == new - 1:
            break
        tok = torch.from_numpy(feed[t])
        w, wc = decode(params, wc, tok, s + t)
        g, gc = decode(sp, gc, tok, s + t)
    if arch == "xlstm-1.3b" and shape == (2, 2):    # states: dh on model
        c = gc["cycles"][0]["c"]
        assert c.spec[3] == "model" and gc["cycles"][1]["h"].spec[3] == "model"


# ---------------------------------------------------------------- traffic
def act_bytes(*shape, itemsize=2) -> int:
    return math.prod(shape) * itemsize


# (arch, kind, decoder): one block of each kind
PIN = {"ga": ("qwen3-4b", "ga", False), "gm": ("granite-moe-1b-a400m", "gm",
                                               False),
       "gm-residual": ("arctic-480b", "gm", False),
       "rg": ("recurrentgemma-2b", "rg", False),
       "la": ("recurrentgemma-2b", "la", False),
       "ml": ("xlstm-1.3b", "ml", False), "sl": ("xlstm-1.3b", "sl", False),
       "enc": ("whisper-medium", "enc", False),
       "ga-cross": ("whisper-medium", "ga", True)}


def ffn_bytes(b, s, d, ff, gated, m, given) -> int:
    """The bytes a dense FFN of hidden dim ``ff`` moves: its input sent
    to the m - 1 other positions (unless ``given`` there already); where
    ``ff`` does not divide m (d_model split), each position's d_model
    columns of the input instead, the summed pre-activations sent back
    out, and the output's columns sent to the lead."""
    o = m - 1
    if ff % m == 0:
        return 0 if given else o * act_bytes(b, s, d)
    return ((0 if given else o * act_bytes(b, s, d // m))
            + (2 if gated else 1) * o * act_bytes(b, s, ff)
            + o * act_bytes(b, s, d // m))


def pin_bytes(cfg, kind, decoder, p, b, s, m) -> int:
    """The bytes one training forward of a block moves between the m
    positions of one group (data = 1): each sublayer's bf16 input sent
    from the lead to the m - 1 others, the activations the split
    concatenates (router logits, the RG-LRU's conv output, the mLSTM's
    up-projection, the sLSTM's normed output), the fp32 sums of squares
    of the xLSTM norms sent back out, and an FFN's (:func:`ffn_bytes`);
    for the sLSTM also the only weight region: ``b_zifo``, which the
    policy lays out on dh, read by heads.  Partials summed onto the lead
    are reduced bytes, not these."""
    d, o = cfg.d_model, m - 1
    x = act_bytes(b, s, d)
    gated = cfg.act in ("silu", "geglu")
    if kind in tfm.ATTN_KINDS:
        n = o * x                           # self-attention's input
        if tfm._has_cross(cfg, kind, decoder):
            n += o * x
        if kind != "gm":
            return n + ffn_bytes(b, s, d, cfg.d_ff, gated, m, False)
        n += o * x                          # the MoE's input
        n += o * act_bytes(b, s, cfg.n_experts)   # router columns
        if cfg.dense_residual:
            n += ffn_bytes(b, s, d, cfg.d_ff, gated, m, False)
        return n
    if kind == "rg":                        # mixer, conv output, FFN
        return (o * x + o * act_bytes(b, s, cfg.rnn_width)
                + ffn_bytes(b, s, d, cfg.d_ff, gated, m, False))
    sums = o * act_bytes(b, s, 1, itemsize=4)
    if kind == "ml":
        return o * x + o * act_bytes(b, s, p["mlstm"]["w_up"].shape[1]) + sums
    bz = p["slstm"]["b_zifo"]
    return (2 * o * x + sums + o * bz.numel() // m * bz.element_size()
            + ffn_bytes(b, s, d, p["slstm"]["w_mlp_in"].shape[1], True, m,
                        True))


@pytest.mark.parametrize("case", list(PIN))
def test_a_forward_moves_no_weight_bytes(case, monkeypatch):
    """One training forward of one block of each kind on a (data=1,
    model=4) mesh, which has no FSDP: ``place.traffic.gather_bytes`` is
    exactly the activations the split moves (:func:`pin_bytes`) — no
    weight block is read by another position than its holder but
    ``b_zifo``'s (see there) — and the output is the unsharded block's
    within BLOCK_RTOL (an MoE on the unsharded block's routing)."""
    arch, kind, decoder = PIN[case]
    over = {"param_dtype": "float32"} if arch == "arctic-480b" else {}
    cfg, _ = cfgs(arch, **over)
    p = tfm.init_block(cfg, np.random.default_rng(0), kind, decoder=decoder,
                       device="cpu")
    mesh = mesh_of((1, 4))
    tree = {"stack": {"rem_0": p}}
    sp = lay(tree, mesh, policy.param_specs(tree, mesh))["stack"]["rem_0"]
    b, s, d = 2, 32, cfg.d_model
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(
        np.float32)).to(torch.bfloat16)
    enc = (torch.from_numpy(rng.standard_normal(
        (b, cfg.encoder_seq, d)).astype(np.float32)).to(torch.bfloat16)
        if decoder else None)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    cos, sin = positions_to_angles(cfg, pos)
    stub = tfm._train_cache_stub(cfg, kind, b, "cpu")
    calls: list = []
    with ShardReplay.recording(calls):
        want, _, _ = tfm.apply_block(
            cfg, p, kind, x, tfm.Ctx("train", cos, sin, pos, None, s,
                                     enc_out=enc), stub, decoder=decoder)
    if calls:
        ShardReplay(calls, monkeypatch)
    run = parallel.MeshRun(mesh, None)
    ctx = tfm.Ctx("train", cos, sin, pos, None, s, run=run,
                  enc_out=None if enc is None else run.act([enc]))
    place.traffic.reset()
    got, _, _ = tfm.apply_block(cfg, sp, kind, run.act([x]), ctx, stub,
                                decoder=decoder)
    assert place.traffic.gather_bytes == pin_bytes(cfg, kind, decoder, p, b,
                                                   s, 4)
    assert rel_l2(got.gather(), want) <= BLOCK_RTOL
