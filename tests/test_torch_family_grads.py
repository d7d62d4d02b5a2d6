"""Port parity — gradients of the block kinds beyond dense attention.

Each family's ``Model.loss`` and train-step gradients against the JAX
reference's on carried weights, one layer per block kind (the
reference's own smoke-test convention), an MoE's routing replayed from
the reference where a near-tie parts the two packages; and every
block's gradients on identical inputs and an identical output
cotangent.  Tolerances are tests/test_torch_train.py's: loss within
1e-2, gradients within 3e-2 relative L2 per leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import Model as RModel
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro_torch import models as tmodels
from repro_torch.core import placement as tplace
from repro_torch.launch import steps as tsteps
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from test_torch_families import (both, cfgs, f32, numpy_tree, port_tree,
                                 ref_tree)
from test_torch_models import RoutingReplay

LOSS_ATOL = 1e-2            # tests/test_torch_train.py
GRAD_RTOL = 3e-2


# -------------------------------------------------------------- loss, grads
def ref_grads_of(model, params, batch, remat=True):
    """The reference train step's gradient (weights >= 2-D in bf16 at
    use), as tests/test_torch_train.py takes it."""
    def loss_fn(p):
        pc = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16)
            if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
        return model.loss(pc, batch, remat=remat)
    (loss, metrics), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return loss, metrics, g


def rel_l2(got, want) -> float:
    got, want = f32(got).ravel(), f32(want).ravel()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def smoke_cfgs(arch, **over):
    """tests/test_models_smoke.py's smoke_config in both packages: the
    reduced config with its layer pattern cut to one layer per block kind
    (at least two layers)."""
    pat = tuple(dict.fromkeys(rconfigs.get_config(arch).layer_pattern))
    return cfgs(arch, layer_pattern=pat, n_layers=max(2, len(pat)), **over)


def family_batch(cfg, seed=3, b=2, s=32):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


# arctic's reduced tree is bfloat16; the train step's fp32 master weights
# are what tests/test_torch_train.py's grads test holds, so it runs in float32
FAMILY_LOSS = {"granite-moe-1b-a400m": {}, "recurrentgemma-2b": {},
               "xlstm-1.3b": {}, "whisper-medium": {},
               "arctic-480b": {"param_dtype": "float32"}}
# Leaves whose whole-model gradient is not held to GRAD_RTOL: xlstm's
# mLSTM gate biases and q/k projections.  Their gradients are sums over
# every position of terms that mostly cancel, so the bf16 rounding of
# the backward's cotangents (each package rounds its own transposes)
# moves them by 4-7% relative L2 even at two layers, where the forward
# agrees to a bf16 step.  test_block_grads_match_reference holds every
# leaf of the same blocks within GRAD_RTOL on identical inputs and
# cotangents, and this test still asserts them finite and of the
# reference's structure.
CANCELLING_LEAVES = {"xlstm-1.3b": ("['b_i']", "['b_f']", "['wq']",
                                    "['wk']")}


@pytest.mark.parametrize("arch", list(FAMILY_LOSS))
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """``Model.loss`` (with 0.01 * the MoE aux loss) and the train step's
    grads, leaf by leaf, on carried weights, one layer per block kind;
    per-cycle remat on in both; an MoE config's routing replayed from the
    reference (test_torch_models.RoutingReplay)."""
    tcfg, rcfg = smoke_cfgs(arch, loss_chunk=16, **FAMILY_LOSS[arch])
    tree = tmodels.numpy_params(tcfg, 0)
    rp, tp = ref_tree(tree), port_tree(tree)
    batch = family_batch(tcfg)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tm, rm = TModel(tcfg), RModel(rcfg)
    ref_mode = RoutingReplay.for_cfg(tcfg, monkeypatch)
    with ref_mode():    # remat changes no value; it would trace the cycles
        lr_, mr = rm.loss(rp, rb, remat=False)
    lt, mt = tm.loss(tp, tb)
    assert abs(float(lt) - float(lr_)) <= LOSS_ATOL
    assert abs(float(mt["aux"]) - float(mr["aux"])) <= LOSS_ATOL
    if tcfg.n_experts:
        assert float(mt["aux"]) > 0
        np.testing.assert_allclose(float(lt), float(mt["xent"])
                                   + 0.01 * float(mt["aux"]), rtol=1e-6)
    else:
        assert float(mt["aux"]) == float(mr["aux"]) == 0.0

    with ref_mode():
        lr_, _, gr = ref_grads_of(rm, rp, rb, remat=not tcfg.n_experts)
    lt, _, gt = tsteps.grads_of(tm, tp, tb)
    assert abs(float(lt) - float(lr_)) <= LOSS_ATOL
    t_leaves, tdef = tplace.tree_flatten(gt)
    assert str(tdef) == str(jax.tree_util.tree_structure(gr))
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(gr)[0], t_leaves):
        key = jax.tree_util.keystr(path)
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        assert tuple(got.shape) == want.shape
        if key.endswith(CANCELLING_LEAVES.get(arch, ())):
            continue
        err = rel_l2(got, want)
        assert err <= GRAD_RTOL, (key, err)


BLOCK_GRADS = {
    # name: (arch, kind, decoder, state)
    "gm": ("granite-moe-1b-a400m", "gm", False, None),
    "gm-residual": ("arctic-480b", "gm", False, None),
    "rg": ("recurrentgemma-2b", "rg", False, None),
    "la": ("recurrentgemma-2b", "la", False, None),
    "ml-stub": ("xlstm-1.3b", "ml", False, "stub"),
    "ml-init": ("xlstm-1.3b", "ml", False, "init"),
    "sl-stub": ("xlstm-1.3b", "sl", False, "stub"),
    "sl-init": ("xlstm-1.3b", "sl", False, "init"),
    "enc": ("whisper-medium", "enc", False, None),
    "ga-cross": ("whisper-medium", "ga", True, None),
}


@pytest.mark.parametrize("case", list(BLOCK_GRADS))
def test_block_grads_match_reference(case):
    """One block's grads (every parameter leaf and the input), weights in
    bf16 at use as the train step casts them, on identical inputs and an
    identical output cotangent, in train mode: a full cycle's zero stub
    ("stub", m = 0) or a remainder's init state ("init", m = -1e9) for
    the xLSTM blocks; within GRAD_RTOL relative L2."""
    arch, kind, decoder, state = BLOCK_GRADS[case]
    tcfg, rcfg = cfgs(arch, param_dtype="float32")
    gen = np.random.default_rng(4)
    lp = numpy_tree(ttfm.init_block(tcfg, gen, kind, decoder=decoder,
                                    device="cpu"))
    rng = np.random.default_rng(5)
    b, s = 2, 32
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    rcos, rsin = rlayers.positions_to_angles(rcfg, jnp.asarray(pos))
    tcos, tsin = tlayers.positions_to_angles(tcfg, torch.from_numpy(pos))
    renc = tenc = None
    if decoder:
        renc, tenc = both(rng.standard_normal(
            (b, tcfg.encoder_seq, tcfg.d_model)), "bf16")
    rctx = rtfm.Ctx(mode="train", cos=rcos, sin=rsin, q_pos=jnp.asarray(pos),
                    pos=None, max_len=s, enc_out=renc)
    tctx = ttfm.Ctx(mode="train", cos=tcos, sin=tsin,
                    q_pos=torch.from_numpy(pos), pos=None, max_len=s,
                    enc_out=tenc)
    rcache = tcache = None
    if state == "stub":
        tcache = ttfm._train_cache_stub(tcfg, kind, b, "cpu")
        rcache = jax.tree_util.tree_map(
            jnp.zeros_like, rtfm.init_block_cache(rcfg, kind, b, s))
        assert float(tcache["m"].abs().max()) == 0.0

    def ref_loss(p, xx):
        pc = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a, p)
        o, _, aux = rtfm.apply_block(rcfg, pc, kind, xx, rctx, rcache,
                                     decoder=decoder)
        return (o.astype(jnp.float32) * ct).sum() + aux

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(ref_tree(lp),
                                                jnp.asarray(x, jnp.bfloat16))
    leaves, tdef = tplace.tree_flatten(port_tree(lp))
    leaves = [a.requires_grad_(True) for a in leaves]
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    o, _, aux = ttfm.apply_block(
        tcfg, tdef.unflatten([tsteps._compute_copy(a) for a in leaves]),
        kind, xt, tctx, tcache, decoder=decoder)
    ((o.float() * torch.from_numpy(ct)).sum() + aux).backward()
    assert rel_l2(xt.grad, gx) <= GRAD_RTOL, "input grad"
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(gp)[0], leaves):
        err = rel_l2(got.grad, want)
        assert err <= GRAD_RTOL, (jax.tree_util.keystr(path), err)
