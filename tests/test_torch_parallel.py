"""Port parity — the model under a (data, model) mesh: placement
(``repro_torch.sharding.place``), the activation hints
(``repro_torch.sharding.ctx``), the mesh executor
(``repro_torch.sharding.parallel``), and the train, prefill and decode
steps of ``repro_torch.launch.steps`` on state laid out by the policy.

Every mesh here is a one-process mesh of CPU positions
(``devices=["cpu"] * n``).  The reference's own sharded path fails on
the installed jax (``with_sharding_constraint`` under an Explicit mesh,
ROADMAP C), so the sharded results are held against the UNSHARDED
reference and the port's own unsharded steps, on weights carried across
from one numpy tree.  Tolerances:

* loss within LOSS_ATOL = 1e-2 and each gradient leaf within GRAD_RTOL =
  3e-2 relative L2 (tests/test_torch_train.py's): the model axis sums
  each position's fp32 partial in mesh order and rounds the sum once to
  bf16, and the backward sums the bf16 cotangents of a broadcast input;
* logits within LOGIT_ATOL = 0.125 and greedy tokens equal wherever the
  reference's top-2 margin exceeds MARGIN = 0.25
  (tests/test_torch_models.py's);
* placement, gathers, the optimizer's bookkeeping, checkpoint files and
  restores: exact; two runs of a sharded step: bit-identical.
"""
import dataclasses
import hashlib
import math
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.launch import steps as rsteps
from repro.models import Model as RModel
from repro.optim import adamw as radamw
from repro_torch.checkpoint.msr_checkpoint import MSRCheckpointer
from repro_torch.configs import get_config
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.placement import tree_flatten
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import checked_mesh
from repro_torch.models import Model, numpy_params, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import parallel, place, policy
from repro_torch.sharding.mesh import P
from repro_torch.sharding.place import Sharded

LOSS_ATOL = 1e-2
GRAD_RTOL = 3e-2
LOGIT_ATOL = 0.125
MARGIN = 0.25
TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab_size=256, loss_chunk=16)


def mesh_of(shape, axes=("data", "model")):
    return checked_mesh(tuple(shape), axes, ["cpu"] * math.prod(shape))


def cfgs(arch="qwen3-4b", **over):
    return get_config(arch).reduced(**over), rget(arch).reduced(**over)


def np_batch(cfg, b=8, s=32, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def t_batch(nb: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in nb.items()}


def lay(tree, mesh, specs):
    return place.place(tree, policy.named(specs, mesh))


def laid_state(params, mesh, layout, opt_cfg=None):
    ps = policy.param_specs(params, mesh, layout=layout)
    state = {"params": params, "opt": adamw.init(params, opt_cfg)}
    return lay(state, mesh, {"params": ps, "opt": policy.opt_specs(ps)})


def laid_batch(batch, mesh, layout="hybrid"):
    b = next(iter(batch.values())).shape[0]
    return lay(batch, mesh, policy.batch_spec(batch, mesh, global_batch=b,
                                              layout=layout))


def rel_l2(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                     jnp.asarray(got, jnp.float32))
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else
                      jnp.asarray(want, jnp.float32))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def whole(tree) -> list:
    return [x.gather() if isinstance(x, Sharded) else x
            for x in tree_flatten(tree)[0]]


def micro_for(sb: dict, n: int) -> int:
    """``n``, or 1 where a batch shard holds fewer rows."""
    t = sb["tokens"]
    rows = t.block_shape()[0] if isinstance(t, Sharded) else t.shape[0]
    return n if rows % n == 0 else 1


def ref_grads(rcfg, np_params, nb, n_micro):
    """The reference's unsharded gradients of the train step's loss
    (weights >= 2-D cast to bf16 at use), averaged over ``n_micro``
    microbatches in order, and the mean loss."""
    model = RModel(rcfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)

    def loss_fn(p, b):
        pc = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16)
            if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
        return model.loss(pc, b)[0]
    gsum, lsum = None, 0.0
    b = nb["tokens"].shape[0] // n_micro
    for i in range(n_micro):
        mb = {k: jnp.asarray(v[i * b:(i + 1) * b]) for k, v in nb.items()}
        loss, g = jax.value_and_grad(loss_fn)(params, mb)
        lsum += float(loss)
        gsum = g if gsum is None else jax.tree_util.tree_map(
            lambda a, c: a + c, gsum, g)
    return lsum / n_micro, [x / n_micro for x in
                            jax.tree_util.tree_leaves(gsum)]


def ref_step_loss(rcfg, np_params, nb, n_micro, lr=1e-3) -> float:
    model = RModel(rcfg)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    opt = radamw.AdamWConfig(lr=lr)
    state = {"params": params, "opt": radamw.init(params, opt)}
    fn = jax.jit(rsteps.make_train_step(model, opt, n_micro))
    _, m = fn(state, {k: jnp.asarray(v) for k, v in nb.items()})
    return float(m["loss"])


def policy_bytes(params, mesh, layout) -> dict:
    """Bytes each position holds of a training state by the specs: each
    leaf's bytes over the product of the axes its spec names, for the
    parameters and both moments, and the int32 step."""
    specs = policy.param_specs(params, mesh, layout=layout)
    total = 0
    for x, s in zip(tree_flatten(params)[0], tree_flatten(
            policy.tree_map_with_path(lambda _, s: Spec(s), specs,
                                      is_leaf=policy.is_spec))[0]):
        n = math.prod(mesh.shape[a] for e in s.spec if e is not None
                      for a in (e if isinstance(e, tuple) else (e,)))
        total += x.numel() * x.element_size() // n
    return {pos: 3 * total + 4 for pos in place.positions(mesh)}


@dataclasses.dataclass
class Spec:
    """A spec held as a tree leaf (a tuple would be a node)."""
    spec: tuple


# ---------------------------------------------------------------- train
@pytest.fixture(scope="module")
def tiny():
    tcfg, rcfg = cfgs(**TINY)
    tree = numpy_params(tcfg, 0)
    nb = np_batch(tcfg)
    params = params_from_numpy(tree, device="cpu")
    loss, _, grads = tsteps.accumulate_grads(Model(tcfg), params,
                                             t_batch(nb), 2)
    rloss, rgrads = ref_grads(rcfg, tree, nb, 2)
    return {"cfg": tcfg, "rcfg": rcfg, "tree": tree, "nb": nb,
            "params": params, "loss": float(loss),
            "grads": tree_flatten(grads)[0], "rloss": rloss,
            "rgrads": rgrads, "rstep_loss": ref_step_loss(rcfg, tree, nb, 2)}


MESHES = {"data4_model2": ((4, 2), ("data", "model")),
          "data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("layout", ["hybrid", "dp"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_train_step_matches_unsharded_and_reference(tiny, mesh_name,
                                                            layout):
    """The reduced qwen3-4b of the reference's
    test_sharded_train_step_runs_on_host_mesh, batch 8 x 32, 2
    microbatches per batch shard where it holds 2 rows, on (data=4,
    model=2) (KV heads split), (data=2, model=4) (KV projections
    replicated: each position projects its query heads' KV heads) and
    (pod=2, data=2, model=2): loss and grads against the port's
    unsharded step and the reference's unsharded
    ``jax.jit(make_train_step(...))``; two runs bit-identical; the state
    stays laid out; ``device_bytes`` is the policy's."""
    cfg, mesh = tiny["cfg"], mesh_of(*MESHES[mesh_name])
    model = Model(cfg)
    opt = adamw.AdamWConfig(lr=1e-3)
    state = laid_state(tiny["params"], mesh, layout, opt)
    sb = laid_batch(t_batch(tiny["nb"]), mesh, layout)
    n = micro_for(sb, 2)
    rules = policy.activation_rules(cfg, mesh, "train", layout)
    with shctx.rules(mesh, rules):
        loss, metrics, grads = tsteps.accumulate_grads(
            model, state["params"], sb, n)
        step = tsteps.make_train_step(model, opt, n)
        (s1, m1), (s2, m2) = step(state, sb), step(state, sb)
    for want in (tiny["loss"], tiny["rloss"], tiny["rstep_loss"]):
        assert abs(float(loss) - want) <= LOSS_ATOL
    assert abs(float(m1["loss"]) - tiny["rstep_loss"]) <= LOSS_ATOL
    got = whole(grads)
    for g, w, r in zip(got, tiny["grads"], tiny["rgrads"]):
        assert g.dtype == torch.float32
        assert rel_l2(g, w) <= GRAD_RTOL
        assert rel_l2(g, r) <= GRAD_RTOL
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(whole(s1), whole(s2)))
    for a, b in zip(tree_flatten(s1)[0], tree_flatten(state)[0]):
        assert isinstance(a, Sharded) and a.spec == b.spec
    assert int(s1["opt"].step.gather()) == 1
    assert place.device_bytes(state) == policy_bytes(tiny["params"], mesh,
                                                     layout)


def test_remat_under_a_mesh_is_bit_identical_to_no_remat(tiny):
    """``Model.loss`` on sharded parameters with each cycle
    rematerialised (``parallel.remat``, a region spanning every position)
    and without: the loss and every shard's gradient bit-identical."""
    cfg, mesh = tiny["cfg"], mesh_of((2, 2))
    model = Model(cfg)
    sp = lay(tiny["params"], mesh, policy.param_specs(tiny["params"], mesh))
    sb = laid_batch(t_batch(tiny["nb"]), mesh)
    outs = []
    for remat in (True, False):
        leaves, tdef = tree_flatten(sp)
        req = {}
        tree = tdef.unflatten([x.map(lambda t: req.setdefault(
            id(t), t.detach().requires_grad_(True))) for x in leaves])
        loss, _ = model.loss(tree, sb, remat=remat)
        outs.append((loss.detach(), torch.autograd.grad(
            loss, list(req.values()))))
    (l1, g1), (l2, g2) = outs
    assert torch.equal(l1, l2)
    assert len(g1) == len(g2) > 0
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_fsdp_weights_are_gathered_at_use():
    """Widths where the policy's FSDP engages (leaves of 2^20 elements
    or more): the FFN's weights split over data in the hybrid layout,
    the embedding over (data, model) in the dp layout; the sharded
    grads equal the unsharded ones within tolerance and gathers move
    bytes between positions."""
    cfg, _ = cfgs(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=8192, vocab_size=8192, loss_chunk=16)
    model = Model(cfg)
    params = params_from_numpy(numpy_params(cfg, 1), device="cpu")
    batch = t_batch(np_batch(cfg, seed=2))
    loss, _, grads = tsteps.accumulate_grads(model, params, batch, 1)
    mesh = mesh_of((4, 2))
    for layout, path, want in (
            ("hybrid", ("stack", "cycles", 0, "ffn", "w_in"),
             (None, "data", "model")),
            ("dp", ("embed",), (("data", "model"), None))):
        ps = policy.param_specs(params, mesh, layout=layout)
        spec = ps
        for k in path:
            spec = spec[k]
        assert spec == want
        state = laid_state(params, mesh, layout)
        sb = laid_batch(batch, mesh, layout)
        place.traffic.reset()
        sl, _, sg = tsteps.accumulate_grads(model, state["params"], sb, 1)
        assert place.traffic.gather_bytes > 0
        assert abs(float(sl) - float(loss)) <= LOSS_ATOL
        for g, w in zip(whole(sg), tree_flatten(grads)[0]):
            assert rel_l2(g, w) <= GRAD_RTOL


def test_heads_that_do_not_divide_take_sequence_parallel_attention(
        monkeypatch):
    """6 heads on a model axis of 4: the rules ask for sequence-parallel
    attention (attn_q / attn_scores / attn_out), and each position
    computes its query rows; without the rules the attention is gathered
    at use.  Both within tolerance of the port's and the reference's
    unsharded loss and grads."""
    tcfg, rcfg = cfgs(n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
                      head_dim=8, d_ff=64, vocab_size=256, loss_chunk=16)
    tree = numpy_params(tcfg, 3)
    nb = np_batch(tcfg, seed=4)
    model = Model(tcfg)
    params = params_from_numpy(tree, device="cpu")
    loss, _, grads = tsteps.accumulate_grads(model, params, t_batch(nb), 1)
    rloss, rgrads = ref_grads(rcfg, tree, nb, 1)
    mesh = mesh_of((2, 4))
    rules = policy.activation_rules(tcfg, mesh, "train")
    assert {"attn_q", "attn_scores", "attn_out"} <= set(rules)
    modes = []
    real = parallel._attn_mode
    monkeypatch.setattr(parallel, "_attn_mode",
                        lambda *a: modes.append(real(*a)) or modes[-1])
    state = laid_state(params, mesh, "hybrid")
    sb = laid_batch(t_batch(nb), mesh)
    for use_rules, mode in ((True, "seq"), (False, "gather")):
        modes.clear()
        if use_rules:
            with shctx.rules(mesh, rules):
                sl, _, sg = tsteps.accumulate_grads(model, state["params"],
                                                    sb, 1)
        else:
            sl, _, sg = tsteps.accumulate_grads(model, state["params"], sb,
                                                1)
        assert modes and set(modes) == {mode}
        assert abs(float(sl) - float(loss)) <= LOSS_ATOL
        assert abs(float(sl) - rloss) <= LOSS_ATOL
        for g, w, r in zip(whole(sg), tree_flatten(grads)[0], rgrads):
            assert rel_l2(g, w) <= GRAD_RTOL
            assert rel_l2(g, r) <= GRAD_RTOL


@pytest.mark.parametrize("layout", ["hybrid", "dp"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "recurrentgemma-2b"])
def test_every_block_kind_runs_under_every_layout(arch, layout):
    """An MoE and a recurrent config (reduced) under both layouts on a
    (4, 2) mesh: under the hybrid layout the experts split over model,
    the RG-LRU and its convolution over their width, the "gm" and "la"
    blocks' attention over heads (tests/test_torch_parallel_blocks.py
    holds each kind); loss and grads within tolerance of the port's
    unsharded step, the loss of the reference's."""
    tcfg, rcfg = cfgs(arch)
    tree = numpy_params(tcfg, 5)
    nb = np_batch(tcfg, seed=6)
    model = Model(tcfg)
    params = params_from_numpy(tree, device="cpu")
    loss, _, grads = tsteps.accumulate_grads(model, params, t_batch(nb), 1)
    rloss, _ = ref_grads(rcfg, tree, nb, 1)
    mesh = mesh_of((4, 2))
    state = laid_state(params, mesh, layout)
    sb = laid_batch(t_batch(nb), mesh, layout)
    with shctx.rules(mesh, policy.activation_rules(tcfg, mesh, "train",
                                                   layout)):
        sl, _, sg = tsteps.accumulate_grads(model, state["params"], sb, 1)
    assert abs(float(sl) - float(loss)) <= LOSS_ATOL
    assert abs(float(sl) - rloss) <= LOSS_ATOL
    for g, w in zip(whole(sg), tree_flatten(grads)[0]):
        assert rel_l2(g, w) <= GRAD_RTOL


# -------------------------------------------------------------- serving
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4)])
def test_sharded_prefill_and_decode_match(shape):
    """``make_prefill_step`` / ``make_decode_step`` on parameters laid
    out by the hybrid specs and caches by ``cache_spec``: logits within
    0.125 of the unsharded steps' on the same tokens, and greedy tokens
    equal wherever the reference's top-2 margin exceeds 0.25."""
    tcfg, rcfg = cfgs(**TINY)
    tree = numpy_params(tcfg, 7)
    model, rmodel = Model(tcfg), RModel(rcfg)
    params = params_from_numpy(tree, device="cpu")
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    b, s, new = 4, 16, 4
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)
    feed = rng.integers(0, tcfg.vocab_size, (new, b, 1)).astype(np.int32)
    max_len = s + new
    mesh = mesh_of(shape)
    sp = lay(params, mesh, policy.param_specs(params, mesh))
    prefill = tsteps.make_prefill_step(model, max_len=max_len, q_chunk=None)
    decode = tsteps.make_decode_step(model, max_len=max_len)
    rprefill = rsteps.make_prefill_step(rmodel, max_len=max_len, q_chunk=None)
    rdecode = rsteps.make_decode_step(rmodel, max_len=max_len)
    batch = {"tokens": torch.from_numpy(prompt)}
    (w, wc), (g, gc) = prefill(params, batch), prefill(
        sp, laid_batch(batch, mesh))
    r, rc = rprefill(rparams, {"tokens": jnp.asarray(prompt)})
    assert isinstance(gc["cycles"][0]["k"], Sharded)
    assert gc["cycles"][0]["k"].spec == policy.cache_spec(
        wc, mesh, batch=b)["cycles"][0]["k"]
    for t in range(new):
        g = g.gather()
        assert float((g - w).abs().max()) <= LOGIT_ATOL
        rv = np.asarray(jnp.asarray(r, jnp.float32))
        top2 = np.sort(rv, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > MARGIN
        assert (g.argmax(-1).numpy() == rv.argmax(-1))[sure].all()
        if t == new - 1:
            break
        tok = torch.from_numpy(feed[t])
        w, wc = decode(params, wc, tok, s + t)
        g, gc = decode(sp, gc, tok, s + t)
        r, rc = rdecode(rparams, rc, jnp.asarray(feed[t]), s + t)


# ------------------------------------------------------------ optimizer
def test_global_norm_counts_each_block_once():
    """A sharded gradient tree's global norm equals the unsharded one's;
    counting every position's replica instead (the embedding and head
    are replicated over data) gives another norm, and moves the clip."""
    cfg, _ = cfgs(**TINY)
    params = params_from_numpy(numpy_params(cfg, 9), device="cpu")
    mesh = mesh_of((4, 2))
    state = laid_state(params, mesh, "hybrid")
    _, _, grads = tsteps.accumulate_grads(
        Model(cfg), state["params"], laid_batch(t_batch(np_batch(cfg)),
                                                mesh), 1)
    want = adamw.global_norm(place.gather(grads))
    got = adamw.global_norm(grads)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    twice = torch.sqrt(sum(torch.sum(torch.square(t.float()))
                           for x in tree_flatten(grads)[0]
                           for t in x.shards.values()))
    assert not torch.allclose(twice, want, rtol=1e-2)
    clip = adamw.AdamWConfig(grad_clip=float(want) / 2).grad_clip
    assert (min(1.0, clip / float(got)) - min(1.0, clip / float(twice))
            ) > 0.1


# ----------------------------------------------------------- checkpoint
def digest(step_dir: Path) -> str:
    """sha256 of a step directory: each file's name and bytes, an .npz by
    its members (its zip container carries the write time)."""
    h = hashlib.sha256()
    for f in sorted(step_dir.iterdir()):
        h.update(f.name.encode())
        if f.suffix == ".npz":
            with zipfile.ZipFile(f) as z:
                for m in sorted(z.namelist()):
                    h.update(m.encode() + z.read(m))
        else:
            h.update(f.read_bytes())
    return h.hexdigest()


def test_sharded_checkpoint_files_and_restore(tmp_path):
    """A sharded training state saved through ``MSRCheckpointer`` writes
    the files of an unsharded save of the same values byte for byte
    (sync and write-behind); restored with a node lost and re-placed, it
    equals the saved state bit for bit, and the next step from it equals
    the next step without the round trip."""
    cfg, _ = cfgs(**TINY)
    model = Model(cfg)
    opt = adamw.AdamWConfig(lr=1e-3)
    params = params_from_numpy(numpy_params(cfg, 10), device="cpu")
    mesh = mesh_of((2, 2))
    state = laid_state(params, mesh, "hybrid", opt)
    sb = [laid_batch(t_batch(np_batch(cfg, seed=i)), mesh) for i in (1, 2)]
    step = tsteps.make_train_step(model, opt)
    state, _ = step(state, sb[0])
    spec = CodeSpec.make(4, 257)
    dirs = {}
    for name, tree, asynchronous in (("sharded", state, False),
                                     ("async", state, True),
                                     ("whole", place.gather(state), False)):
        ck = MSRCheckpointer(tmp_path / name, spec, device="cpu")
        if asynchronous:
            ck.save_async(1, tree)
            ck.barrier()
        else:
            ck.save(1, tree)
        ck.close()
        dirs[name] = digest(tmp_path / name / "step_000001")
    assert dirs["sharded"] == dirs["async"] == dirs["whole"]
    ck = MSRCheckpointer(tmp_path / "sharded", spec, device="cpu")
    restored, rep = ck.restore(state, step=1, failed_nodes=[5])
    ck.close()
    assert rep.path != "systematic"
    assert not any(isinstance(x, Sharded) for x in tree_flatten(restored)[0])
    ps = policy.param_specs(params, mesh)
    back = lay(restored, mesh, {"params": ps, "opt": policy.opt_specs(ps)})
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(whole(back), whole(state)))
    nxt = [whole(step(s, sb[1])[0]) for s in (state, back)]
    assert all(torch.equal(a, b) for a, b in zip(*nxt))


# ------------------------------------------------- placement and hints
def test_constrain_is_x_outside_rules_and_relays_inside():
    mesh = mesh_of((2, 2))
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    sx = place.shard(x, mesh, P(("data",), None, None))
    assert shctx.constrain(x, "residual") is x
    assert shctx.constrain(sx, "residual") is sx
    assert not shctx.active()
    table = {"residual": P(("data",), None, None),
             "attn_q": P(("data",), "model", None), "odd": P(None, None,
                                                             "model")}
    with shctx.rules(mesh, table):
        assert shctx.active()
        assert shctx.constrain(x, "attn_q") is x         # a plain piece
        assert shctx.constrain(sx, "residual") is sx     # already laid out
        assert shctx.constrain(sx, "unknown") is sx
        q = shctx.constrain(sx, "attn_q")
        assert q.spec == (("data",), "model", None)
        assert torch.equal(q.gather(), x)
        assert q.shards[(1, 1)].shape == (2, 3, 8)
        assert torch.equal(q.shards[(1, 1)], x[2:, 3:])
        y = place.shard(torch.zeros(4, 6, 7), mesh, P())
        assert shctx.constrain(y, "odd") is y            # 7 % 2: skipped
    assert not shctx.active()


@pytest.mark.parametrize("spec", [P(), P("model"), P(None, "data"),
                                  P(("data", "model"), None),
                                  P(("pod", "data"), "model"),
                                  P("model", ("pod", "data"))])
def test_place_gather_and_relayout_round_trip(spec):
    """Blocks cut as GSPMD cuts them (several axes on one dim: the first
    major), one tensor per block and device, gathered and re-laid
    exactly; ``device_bytes`` counts each position's block."""
    mesh = mesh_of((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    sx = place.shard(x, mesh, spec)
    assert torch.equal(sx.gather(), x)
    n = math.prod(mesh.shape[a] for e in spec if e is not None
                  for a in (e if isinstance(e, tuple) else (e,)))
    assert len(sx.unique()) == n
    assert set(place.device_bytes({"x": sx}).values()) == {x.numel() * 4 // n}
    if spec == P(("pod", "data"), "model"):
        # position (pod 1, data 0, model 1): row block 2 of 4, column 1
        assert torch.equal(sx.shards[(1, 0, 1)], x[4:6, 6:])
    for other in (P(), P(None, ("model", "data")), P("pod", "data")):
        assert torch.equal(sx.relayout(other).gather(), x)
    with pytest.raises(ValueError, match="does not divide"):
        sx.relayout(P(None, ("model", "data", "pod")))
    for lead in (P(None) + spec, P("data")):       # a cycle of a stack
        stacked = place.shard(torch.stack([x, -x]), mesh, lead)
        assert torch.equal(stacked[1].gather(), -x)
    with pytest.raises(ValueError, match="does not divide"):
        place.shard(torch.zeros(3, 12), mesh, P("model"))


def test_place_follows_the_named_tree_and_leaves_others():
    cfg, _ = cfgs(**TINY)
    params = params_from_numpy(numpy_params(cfg, 11), device="cpu")
    mesh = mesh_of((2, 2))
    sp = lay(params, mesh, policy.param_specs(params, mesh))
    for a, b in zip(tree_flatten(sp)[0], tree_flatten(params)[0]):
        assert isinstance(a, Sharded) and torch.equal(a.gather(), b)
    wq = sp["stack"]["cycles"][0]["attn"]["wq"]
    assert wq.spec == (None, None, "model", None)
    assert wq.shards[(0, 1)] is wq.shards[(1, 1)]       # one CPU: shared
    assert wq.shards[(0, 0)] is not wq.shards[(0, 1)]
    assert place.gather({"a": 1, "b": None}) == {"a": 1, "b": None}
