"""Port parity -- the dry run (``repro_torch.launch.dryrun``).

* (i) every cell of ``configs.registry.cells()`` on both production meshes:
  ``n_params``, ``n_active_params``, ``layout``, ``n_microbatches``,
  ``tokens_per_step`` and the moment dtype equal the reference's
  functions (``count_params`` / ``count_active_params`` on
  ``jax.eval_shape``, ``choose_layout`` on a FakeMesh,
  ``pick_microbatches``), without running any step;
* (ii) ``memory.argument_bytes`` equal to the bytes per position that the
  reference's ``param_specs`` / ``batch_spec`` / ``cache_spec`` imply for
  each leaf, on a handful of cells (arctic-480b at full depth among them);
* (iii) the reference's reduced smoke cell (tests/test_hlo_stats.py)
  through ``lower_cell`` on a (4, 2) meta mesh, with the reference's
  invariants (train flops per position above half of 6 N T / devices,
  collectives > 0);
* (iv) the reductions exact: the counts extrapolated from reduced runs
  (depth and batch groups) equal to a plain full run, for a dense, an
  MoE and an xLSTM config at tiny widths, on (4, 2) and (2, 4);
* (v) the sampling hook reaches nothing but a dry run: it refuses a mesh
  of real devices, and a sharded step's loss and grads are bit-identical
  before and after a dry run.
Tolerance: none (counts are integers)."""
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget
from repro.launch import steps as rsteps
from repro.models import Model as RModel
from repro.optim import adamw as radamw
from repro.sharding import policy as rpolicy
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import cells
from repro_torch.core.placement import tree_flatten
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import checked_mesh
from repro_torch.models import Model
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import parallel, place, policy, sampling
from repro_torch.sharding.place import Sharded


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


PRODUCTION = {False: FakeMesh(data=16, model=16),
              True: FakeMesh(pod=2, data=16, model=16)}


@functools.cache
def ref_params(arch: str):
    rcfg = rget(arch)
    return jax.eval_shape(lambda: RModel(rcfg).init(jax.random.PRNGKey(0)))


@functools.cache
def port_mesh(multi_pod: bool):
    return dryrun.production_mesh(multi_pod)


# ------------------------------------------------------ (i) layout fields
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch,shape_name", cells())
def test_layout_fields_equal_reference(arch, shape_name, multi_pod):
    rcfg, rshape, fake = rget(arch), RSHAPES[shape_name], PRODUCTION[multi_pod]
    got = dryrun.layout_fields(get_config(arch), SHAPES[shape_name],
                               port_mesh(multi_pod))
    shapes = ref_params(arch)
    n_params = rsteps.count_params(shapes)
    layout = rpolicy.choose_layout(rcfg, fake, rshape)
    n_dev = math.prod(fake.shape.values())
    n_shards = n_dev if layout == "dp" else n_dev // fake.shape["model"]
    assert got["n_params"] == n_params
    assert got["n_active_params"] == rsteps.count_active_params(rcfg, shapes)
    assert got["layout"] == layout
    assert got["n_microbatches"] == (
        rsteps.pick_microbatches(rshape, n_shards)
        if rshape.kind == "train" else None)
    assert got["tokens_per_step"] == rshape.global_batch * (
        rshape.seq_len if rshape.kind != "decode" else 1)
    assert got["moment_dtype"] == ("bfloat16" if n_params > 100e9
                                   else "float32")
    assert got["n_devices"] == n_dev
    if arch == "arctic-480b":
        assert (got["n_params"], got["n_active_params"]) == (
            476_850_275_328, 11_980_674_048)


# ------------------------------------------------- (ii) argument bytes
def spec_bytes(leaves, specs, mesh) -> int:
    """Bytes one position holds of ``leaves`` laid out by ``specs``."""
    total = 0
    for x, spec in zip(leaves, specs):
        split = 1
        for e in tuple(spec):
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    split *= mesh.shape[a]
        assert math.prod(x.shape) % split == 0
        total += math.prod(x.shape) // split * np.dtype(x.dtype).itemsize
    return total


def ref_argument_bytes(arch, shape_name, fake) -> int:
    rcfg, shape = rget(arch), RSHAPES[shape_name]
    params = ref_params(arch)
    layout = rpolicy.choose_layout(rcfg, fake, shape)
    pspecs = rpolicy.param_specs(params, fake, layout=layout)
    is_p = lambda x: isinstance(x, rpolicy.P)       # noqa: E731
    flat = lambda t: jax.tree_util.tree_leaves(t, is_leaf=is_p)  # noqa
    if shape.kind == "train":
        n = rsteps.count_params(params)
        opt = jax.eval_shape(lambda: radamw.init(params, radamw.AdamWConfig(
            moment_dtype="bfloat16" if n > 100e9 else "float32")))
        batch = rsteps.input_specs(rcfg, shape)
        bspecs = rpolicy.batch_spec(batch, fake,
                                    global_batch=shape.global_batch,
                                    layout=layout)
        leaves = flat(params) + flat(opt.mu) + flat(opt.nu) + [opt.step] + \
            flat(batch)
        specs = flat(pspecs) * 3 + [rpolicy.P()] + flat(bspecs)
    elif shape.kind == "prefill":
        batch = rsteps.input_specs(rcfg, shape, labels=False)
        leaves = flat(params) + flat(batch)
        specs = flat(pspecs) + flat(rpolicy.batch_spec(
            batch, fake, global_batch=shape.global_batch))
    else:
        cache, tok, _ = rsteps.decode_input_specs(rcfg, shape, RModel(rcfg))
        cspecs = rpolicy.cache_spec(cache, fake, batch=shape.global_batch,
                                    seq_shard=shape.global_batch == 1)
        tspec = rpolicy.batch_spec({"tokens": tok}, fake,
                                   global_batch=shape.global_batch)["tokens"]
        leaves = flat(params) + flat(cache) + [tok]
        specs = flat(pspecs) + flat(cspecs) + [tspec]
    assert len(leaves) == len(specs)
    return spec_bytes(leaves, specs, fake)


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("arctic-480b", "train_4k", False),
    ("arctic-480b", "decode_32k", True),
    ("qwen3-4b", "prefill_32k", False),
    ("gemma3-27b", "long_500k", False),
    ("xlstm-1.3b", "train_4k", True),
    ("whisper-medium", "decode_32k", False),
    ("qwen2-vl-72b", "train_4k", False),
])
def test_argument_bytes_equal_reference_specs(arch, shape_name, multi_pod):
    cfg, shape, mesh = get_config(arch), SHAPES[shape_name], \
        port_mesh(multi_pod)
    fields = dryrun.layout_fields(cfg, shape, mesh)
    opt = dryrun.adamw.AdamWConfig(moment_dtype=fields["moment_dtype"])
    _, args, specs = dryrun.step_inputs(cfg, shape, mesh, fields["layout"],
                                        opt, Model(cfg))
    mem = dryrun.argument_bytes(args, specs, mesh)
    want = ref_argument_bytes(arch, shape_name, PRODUCTION[multi_pod])
    assert mem["argument_bytes"] == want
    assert mem["argument_bytes_mean"] == want     # every position alike


# ----------------------------------------------- (iii) the reduced cell
def test_reduced_cell_record_invariants():
    cfg = get_config("qwen3-4b").reduced(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=256, loss_chunk=16)
    shape = ShapeConfig("train_smoke", 64, 8, "train")
    mesh = dryrun.meta_mesh((4, 2), ("data", "model"))
    rec = dryrun.lower_cell("qwen3-4b", "train_smoke", cfg=cfg, shape=shape,
                            mesh=mesh)
    assert rec["n_devices"] == 8 and rec["mesh"] == "mesh4x2"
    assert rec["dynamic"]["collectives"]["total_bytes"] > 0
    model = 6 * rec["n_active_params"] * rec["tokens_per_step"] / 8
    assert rec["per_position"]["flops"] > 0.5 * model
    assert rec["dynamic"]["flops"] == rec["per_position"]["flops"] * 8
    assert rec["memory"]["argument_bytes"] > 0
    dyn = rec["dynamic"]
    assert dyn["depth_run"]["of"] == 2 and dyn["depth_run"]["run"] == [2]
    assert dyn["groups_run"] == {"run": [1, 2], "of": 8}
    assert dyn["steps_run"] == {"run": [1], "of": 1}


# ------------------------------------------------- (iv) exact reductions
TINY = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
            vocab_size=256, loss_chunk=8)
CONFIGS = {
    # dense: 4 cycles of (global, sliding-window) and one remainder layer,
    # as gemma3-27b's 10 cycles of 6 and 2 more
    "dense": lambda: get_config("qwen3-4b").reduced(
        n_layers=9, layer_pattern=("ga", "la"), window_size=4, **TINY),
    # MoE: 4 cycles of ("gm",), 4 experts
    "moe": lambda: get_config("granite-moe-1b-a400m").reduced(
        n_layers=4, **TINY),
    # xLSTM: 4 cycles of (ml, sl); 2 heads of dh 16, which a model axis
    # of 4 splits by dh (the production case's path)
    "xlstm": lambda: get_config("xlstm-1.3b").reduced(
        n_layers=8, layer_pattern=("ml", "sl"), d_model=32, n_heads=2,
        vocab_size=256, loss_chunk=8),
}
SEQ = 8
CASES = [("train", 4), ("train", 8), ("prefill", 8), ("decode", 8),
         ("decode", 1)]


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)],
                         ids=["data4_model2", "data2_model4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_reduced_counts_equal_full_run(name, mesh_shape):
    cfg = CONFIGS[name]()
    mesh = dryrun.meta_mesh(mesh_shape, ("data", "model"))
    opt = dryrun.opt_config(1)
    seen = set()
    for kind, batch in CASES:
        shape = ShapeConfig("tiny", SEQ, batch, kind)
        layout = policy.choose_layout(cfg, mesh, shape)
        got = dryrun.step_counts(cfg, shape, mesh, layout, opt)
        want = dryrun.step_counts(cfg, shape, mesh, layout, opt,
                                  reduce=False)
        for k in ("flops", "hbm_bytes", "collectives"):
            assert got[k] == want[k], (kind, batch, layout, k)
        assert got["depth_run"]["run"] == [1, 2, 3]
        seen.add((layout, got["groups_run"]["of"] > 2))
        if name == "xlstm" and kind != "decode":
            assert got["steps_run"] == {"run": [1, 2], "of": SEQ}
    assert ("dp", True) in seen           # groups sampled in every mesh
    assert ("hybrid", mesh_shape == (4, 2)) in seen


# -------------------------------------------- (v) hooks reach no real step
def test_sampling_refuses_real_devices():
    mesh = checked_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    run = parallel.MeshRun(mesh, ("data",))
    x = torch.zeros(3, 2)
    assert run.each(lambda i: i) == [0, 1, 2, 3]
    assert sampling.steps(5, x) == range(5)
    with sampling.sample(groups=1, steps=1):
        with pytest.raises(ValueError, match="meta"):
            run.each(lambda i: i)
        with pytest.raises(ValueError, match="meta"):
            sampling.steps(5, x)
        assert sampling.steps(5, x.to("meta")) == range(1)
    assert sampling._LIVE == (None, None)


def test_sharded_step_unchanged_by_a_dry_run():
    cfg = get_config("qwen3-4b").reduced(n_layers=2, **TINY)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = checked_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (8, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    sp = place.place(params, policy.named(policy.param_specs(params, mesh),
                                          mesh))
    sb = place.place(batch, policy.named(policy.batch_spec(
        batch, mesh, global_batch=8), mesh))
    rules = policy.activation_rules(cfg, mesh, "train")

    def step():
        with shctx.rules(mesh, rules):
            loss, _, grads = tsteps.accumulate_grads(model, sp, sb, 2)
        return float(loss), [g.gather() if isinstance(g, Sharded) else g
                             for g in tree_flatten(grads)[0]]

    before = step()
    dryrun.step_counts(cfg, ShapeConfig("t", 16, 8, "train"),
                       dryrun.meta_mesh((4, 2), ("data", "model")),
                       "hybrid", dryrun.opt_config(1))
    after = step()
    assert before[0] == after[0]
    assert all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
    unsharded, _, _ = tsteps.accumulate_grads(model, params, batch, 2)
    assert abs(before[0] - float(unsharded)) <= 1e-2
