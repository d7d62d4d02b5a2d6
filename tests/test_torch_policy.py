"""Port parity — the sharding policy (``repro_torch.sharding.policy``)
against the reference's (``repro.sharding.policy``), exactly.

Every assertion of tests/test_policy.py and of
tests/test_sharding.py::TestPolicySpecFits is twinned on the port's side;
then every config of the registry x every SHAPES entry, on
FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16, model=16) and
FakeMesh(data=4, model=2), holds ``param_specs`` (both layouts),
``choose_layout``, ``activation_rules``, ``batch_spec`` over
``input_specs``, ``cache_spec`` over ``decode_input_specs`` (with and
without ``seq_shard``), ``opt_specs``, ``count_params`` and
``count_active_params`` equal to the reference's.  Tolerance: none — a
spec is compared as a normalised tuple (the reference's PartitionSpec
writes a one-axis tuple as its axis name; the port's plain tuple keeps
it), shape stand-ins are ``jax.eval_shape`` trees against ``meta``
tensors.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs import SHAPES as RSHAPES
from repro.configs import get_config as rget
from repro.launch import steps as rsteps
from repro.models import Model as RModel
from repro.sharding import policy as rpolicy
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import _ARCH_MODULES
from repro_torch.core.placement import tree_flatten
from repro_torch.launch import steps as tsteps
from repro_torch.models import Model
from repro_torch.sharding import ctx
from repro_torch.sharding import policy
from repro_torch.sharding.mesh import P


class FakeMesh:
    """A light stand-in mesh: the policy only reads ``mesh.shape``."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESH = FakeMesh(data=16, model=16)
POD = FakeMesh(pod=2, data=16, model=16)
SMALL = FakeMesh(data=4, model=2)
MESHES = {"data16_model16": MESH, "pod2_data16_model16": POD,
          "data4_model2": SMALL}


def leaf(shape):
    return torch.empty(tuple(shape), dtype=torch.float32, device="meta")


def norm(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry written as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


# ------------------------------------------- tests/test_policy.py, twinned
def test_attention_head_sharding_when_divisible():
    spec = policy.param_spec(["stack", "cycles", "attn", "wq"],
                             (36, 2560, 32, 128), MESH)
    assert spec == P(None, None, "model", None)
    ps = policy.param_specs(
        {"stack": {"cycles": ({"attn": {"wq": leaf((36, 2560, 32, 128))}},)}},
        MESH)
    assert ps["stack"]["cycles"][0]["attn"]["wq"] == P(None, "data", "model",
                                                       None)


def test_attention_replicated_when_heads_dont_divide():
    spec = policy.param_spec(["stack", "cycles", "attn", "wq"],
                             (60, 7168, 56, 128), MESH)
    assert "model" not in str(spec)


def test_moe_expert_parallelism():
    spec = policy.param_spec(["stack", "cycles", "moe", "w_in"],
                             (35, 128, 7168, 4864), MESH)
    assert tuple(spec)[1] == "model"


def test_embed_vocab_sharding_and_fallback():
    assert policy.param_spec(["embed"], (262144, 5376), MESH) == P("model",
                                                                  None)
    assert policy.param_spec(["embed"], (51865, 1024), MESH) == P()


def test_norms_replicated():
    assert policy.param_spec(["stack", "cycles", "norm1", "scale"],
                             (36, 2560), MESH) == P(None)


def test_scan_resident_weights_never_fsdp():
    ps = policy.param_specs(
        {"stack": {"cycles": ({"slstm": {"r_zifo": leaf((6, 4, 4, 512,
                                                         512))}},)}},
        MESH)
    assert "data" not in str(ps["stack"]["cycles"][0]["slstm"]["r_zifo"])


def test_choose_layout_per_arch():
    train = SHAPES["train_4k"]
    dp = {a for a in ("qwen3-4b", "yi-34b", "starcoder2-7b", "xlstm-1.3b",
                      "recurrentgemma-2b", "granite-moe-1b-a400m",
                      "whisper-medium", "gemma3-27b")
          if policy.choose_layout(get_config(a), MESH, train) == "dp"}
    assert "qwen3-4b" in dp and "yi-34b" in dp
    assert policy.choose_layout(get_config("arctic-480b"), MESH,
                                train) == "hybrid"
    assert policy.choose_layout(get_config("qwen2-vl-72b"), MESH,
                                train) == "hybrid"
    assert policy.choose_layout(get_config("qwen3-4b"), MESH,
                                SHAPES["decode_32k"]) == "hybrid"


def test_batch_spec_layouts():
    b = {"tokens": leaf((256, 4096))}
    assert policy.batch_spec(b, MESH, global_batch=256)["tokens"] == P(
        ("data",), None)
    assert policy.batch_spec(b, MESH, global_batch=256, layout="dp")[
        "tokens"] == P(("data", "model"), None)
    one = policy.batch_spec({"tokens": leaf((1, 9))}, MESH, global_batch=1)
    assert one["tokens"] == P()


def test_cache_spec_kv_head_sharding():
    spec = policy.cache_spec({"k": leaf((128, 32768, 16, 128))}, MESH,
                             batch=128)
    assert spec["k"] == P(("data",), None, "model", None)
    spec = policy.cache_spec({"k": leaf((128, 32768, 8, 128))}, MESH,
                             batch=128)
    assert spec["k"] == P(("data",), None, None, "model")
    spec = policy.cache_spec({"k": leaf((1, 524288, 1, 256))}, MESH,
                             batch=1, seq_shard=True)
    assert spec["k"] == P(None, "data", None, "model")


def test_activation_rules():
    cfg = get_config("yi-34b")
    r = policy.activation_rules(cfg, MESH, "train")
    assert "attn_q" in r and r["residual"] == P(("data",), None, None)
    assert set(policy.activation_rules(cfg, MESH, "train",
                                       layout="dp")) == {"residual"}
    assert set(policy.activation_rules(get_config("qwen3-4b"), MESH,
                                       "train")) == {"residual"}


def test_pod_axis_joins_batch():
    spec = policy.batch_spec({"tokens": leaf((256, 4096))}, POD,
                             global_batch=256)
    assert spec["tokens"] == P(("pod", "data"), None)


# ------------------------- tests/test_sharding.py::TestPolicySpecFits, twinned
def test_shared_spec_fits():
    mesh = FakeMesh(data=4, model=2)
    assert policy.spec_fits(P(None, "model"), (3, 8), mesh)
    assert not policy.spec_fits(P(None, "model"), (3, 7), mesh)
    assert policy.spec_fits(P(("data", "model"),), (8,), mesh)
    assert not policy.spec_fits(P(("data", "model"),), (12,), mesh)
    unit = FakeMesh(model=1)
    assert policy.spec_fits(P(None, "model"), (3, 7), unit)
    assert not policy.spec_fits(P(None, "model"), (3, 8), unit,
                                require_multi=True)


def test_ctx_constrain_noop_outside_rules():
    x = torch.ones((4, 4))
    assert ctx.constrain(x, "residual") is x
    assert not ctx.active()


# -------------------------------- every config x shape x mesh, exactly
@functools.lru_cache(maxsize=None)
def trees(arch: str):
    """(port, reference) stand-ins of ``arch``: the training state and,
    per shape, the train/prefill batch and the decode (cache, tokens)."""
    tcfg, rcfg = get_config(arch), rget(arch)
    tm, rm = Model(tcfg), RModel(rcfg)
    out = {"state": (tsteps.state_specs(tm), rsteps.state_specs(rm))}
    for name, shape in SHAPES.items():
        rshape = RSHAPES[name]
        out[("batch", name)] = (tsteps.input_specs(tcfg, shape),
                                rsteps.input_specs(rcfg, rshape))
        out[("decode", name)] = (tsteps.decode_input_specs(tcfg, shape, tm),
                                 rsteps.decode_input_specs(rcfg, rshape, rm))
    return out


def spec_leaves(tree, *, ref: bool) -> list:
    if ref:
        return [norm(s) for s in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, RP))]
    out = []
    policy.tree_map_with_path(lambda _, s: out.append(norm(s)), tree,
                              is_leaf=policy.is_spec)
    return out


def same_specs(got, want) -> None:
    """Equal specs, leaf by leaf in the reference's flatten order (the
    port's tree flattens in the same order: sorted dict keys)."""
    g = [norm(s) for s in tree_flatten(
        policy.tree_map_with_path(lambda _, s: _Spec(s), got,
                                  is_leaf=policy.is_spec))[0]]
    w = spec_leaves(want, ref=True)
    assert w and g == w


class _Spec:
    """A spec held as a tree leaf (a plain tuple would be a node)."""

    def __init__(self, s):
        self.s = s

    def __iter__(self):
        return iter(self.s)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(_ARCH_MODULES))
def test_policy_equals_reference_for_every_config_shape_and_mesh(arch,
                                                                 mesh_name):
    mesh = MESHES[mesh_name]
    tcfg, rcfg = get_config(arch), rget(arch)
    t = trees(arch)
    tstate, rstate = t["state"]
    for layout in ("hybrid", "dp"):
        tp = policy.param_specs(tstate["params"], mesh, layout=layout)
        same_specs(tp, rpolicy.param_specs(rstate["params"], mesh,
                                           layout=layout))
        same_specs(policy.opt_specs(tp), rpolicy.opt_specs(
            rpolicy.param_specs(rstate["params"], mesh, layout=layout)))
    assert tsteps.count_params(tstate["params"]) == rsteps.count_params(
        rstate["params"])
    assert tsteps.count_active_params(tcfg, tstate["params"]) == \
        rsteps.count_active_params(rcfg, rstate["params"])
    for name, shape in SHAPES.items():
        rshape = RSHAPES[name]
        layout = policy.choose_layout(tcfg, mesh, shape)
        assert layout == rpolicy.choose_layout(rcfg, mesh, rshape)
        for lay in ("hybrid", "dp"):
            got = policy.activation_rules(tcfg, mesh, shape.kind, lay)
            want = rpolicy.activation_rules(rcfg, mesh, rshape.kind, lay)
            assert {k: norm(v) for k, v in got.items()} == \
                {k: norm(v) for k, v in want.items()}
            tb, rb = t[("batch", name)]
            same_specs(policy.batch_spec(tb, mesh,
                                         global_batch=shape.global_batch,
                                         layout=lay),
                       rpolicy.batch_spec(rb, mesh,
                                          global_batch=rshape.global_batch,
                                          layout=lay))
        (tc, ttok, _), (rc, rtok, _) = t[("decode", name)]
        assert tuple(ttok.shape) == tuple(rtok.shape)
        for seq_shard in (False, True):
            same_specs(policy.cache_spec(tc, mesh, batch=shape.global_batch,
                                         seq_shard=seq_shard),
                       rpolicy.cache_spec(rc, mesh,
                                          batch=rshape.global_batch,
                                          seq_shard=seq_shard))


def test_shape_stand_ins_match_the_reference():
    """``input_specs``, ``decode_input_specs`` and ``state_specs``: the
    same leaves in the same order, shapes and dtypes equal, and no
    memory allocated (meta tensors)."""
    for arch in ("qwen3-4b", "whisper-medium", "qwen2-vl-72b",
                 "xlstm-1.3b", "arctic-480b"):
        t = trees(arch)
        for key, (got, want) in t.items():
            gl = tree_flatten(got)[0]
            wl = jax.tree_util.tree_leaves(want)
            assert len(gl) == len(wl), (arch, key)
            for g, w in zip(gl, wl):
                assert tuple(g.shape) == tuple(w.shape), (arch, key)
                assert str(g.dtype).split(".")[-1] == str(w.dtype), (arch,
                                                                      key)
                assert g.device.type == "meta"


def test_named_wraps_every_spec():
    ps = policy.param_specs(trees("qwen3-4b")["state"][0]["params"], SMALL)
    named = policy.named(ps, SMALL)
    specs = spec_leaves(ps, ref=False)
    nl = []
    policy.tree_map_with_path(lambda _, n: nl.append(n), named)
    assert [norm(n.spec) for n in nl] == specs
    assert all(n.mesh is SMALL for n in nl)
    assert isinstance(named["stack"]["cycles"], tuple)


def test_specs_hold_arrays_too():
    """The policy reads only ``.shape``: numpy arrays and jax stand-ins
    give the same specs as meta tensors."""
    tree = {"embed": np.zeros((512, 64), np.float32),
            "stack": {"cycles": ({"ffn": {"w_in": jnp.zeros((2, 64, 128))}},)}}
    got = policy.param_specs(tree, SMALL)
    assert got["embed"] == P("model", None)
    assert got["stack"]["cycles"][0]["ffn"]["w_in"] == P(None, None, "model")
