"""Port parity — whole models of the block kinds beyond dense attention.

Every layer of each family's reduced config on the reference's own
input (two bf16 steps), the parameter and cache trees of each family
(structure, names, shapes, dtypes), and chip_smoke.py's known answers
and depth cuts of phase ``families``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import placement as rplace
from repro.models import Model as RModel
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.core import placement as tplace
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from test_torch_families import (both, cfgs, f32, port_tree, ref_tree,
                                 within_steps)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m", "whisper-medium"])
def test_each_layer_matches_reference_at_full_reduced_depth(arch):
    """Every layer of the reduced config on the reference's own input
    (prefill, with caches): the port's output within two bf16 steps at
    its magnitude.  (A whole stack amplifies one layer's bf16 rounding
    differences through its residual stream: 16 xLSTM layers reach four
    steps on the hidden states, so the whole-model tests run xlstm at 9
    layers; this test covers all 16, one layer at a time.)"""
    tcfg, rcfg = cfgs(arch)
    tree = tmodels.numpy_params(tcfg, 0)
    rng = np.random.default_rng(2)
    b, s = 2, 16
    x = (rng.standard_normal((b, s, tcfg.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    rcos, rsin = rlayers.positions_to_angles(rcfg, jnp.asarray(pos))
    tcos, tsin = tlayers.positions_to_angles(tcfg, torch.from_numpy(pos))
    enc = None
    if tcfg.is_encoder_decoder:
        enc = (rng.standard_normal((b, tcfg.encoder_seq, tcfg.d_model))
               ).astype(np.float32)
    renc, tenc = both(enc, "bf16") if enc is not None else (None, None)
    rctx = rtfm.Ctx(mode="prefill", cos=rcos, sin=rsin, q_pos=jnp.asarray(pos),
                    pos=None, max_len=s, enc_out=renc)
    tctx = ttfm.Ctx(mode="prefill", cos=tcos, sin=tsin,
                    q_pos=torch.from_numpy(pos), pos=None, max_len=s,
                    enc_out=tenc)
    dec = tcfg.is_encoder_decoder
    rx, _ = both(x, "bf16")
    n_cycles, rem = tcfg.cycles()
    layers = [(("cycles", j, c), kind)
              for c in range(n_cycles)
              for j, kind in enumerate(tcfg.layer_pattern)]
    layers += [((f"rem_{r}",), tcfg.layer_pattern[r]) for r in range(rem)]
    for where, kind in layers:
        lp = tree["stack"]
        for key in where[:2]:
            lp = lp[key]
        if where[0] == "cycles":
            lp = jax.tree_util.tree_map(lambda a: a[where[2]], lp)
        rcache = rtfm.init_block_cache(rcfg, kind, b, s, decoder=dec)
        tcache = ttfm.init_block_cache(tcfg, kind, b, s, decoder=dec,
                                       device="cpu")
        want, rc, raux = rtfm.apply_block(rcfg, ref_tree(lp), kind, rx, rctx,
                                          rcache, decoder=dec)
        tx = torch.from_numpy(f32(rx)).bfloat16()
        got, tc, taux = ttfm.apply_block(tcfg, port_tree(lp), kind, tx, tctx,
                                         tcache, decoder=dec)
        within_steps(got, want, 2, f"{arch} {where} {kind}")
        np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5,
                                   atol=1e-6)
        tl = tplace.tree_flatten(tc)[0]
        rl = jax.tree_util.tree_leaves(rc)
        assert [tuple(t.shape) for t in tl] == [r.shape for r in rl]
        rx = want


# ------------------------------------------------------------------ trees
FAMILY_TREES = {"granite-moe-1b-a400m": {}, "arctic-480b": {},
                "recurrentgemma-2b": {"n_layers": 4},   # a cycle + "rg"
                "xlstm-1.3b": {"n_layers": 9},          # a cycle + "ml"
                "whisper-medium": {}}


@pytest.mark.parametrize("arch", list(FAMILY_TREES))
def test_family_param_tree_matches_reference_structure(arch):
    """Model.init (torch.Generator) and numpy_params build the
    reference's tree: the same treedef string, leaf names, shapes and
    dtypes (placement's leaf metas); the caches too."""
    tcfg, rcfg = cfgs(arch, **FAMILY_TREES[arch])
    tp = TModel(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    rp = RModel(rcfg).init(jax.random.PRNGKey(0))
    _, ttd, tmeta = tplace.pytree_to_bytes(tp)
    _, rtd, rmeta = rplace.pytree_to_bytes(rp)
    assert str(ttd) == str(rtd) and tmeta == rmeta
    _, cdef, cmeta = tplace.pytree_to_bytes(
        port_tree(tmodels.numpy_params(tcfg, 1)))
    assert str(cdef) == str(rtd) and cmeta == rmeta
    tc = TModel(tcfg).init_cache(2, 24, device="cpu")
    rc = RModel(rcfg).init_cache(2, 24)
    tleaves, tcd = tplace.tree_flatten(tc)
    assert str(tcd) == str(jax.tree_util.tree_structure(rc))
    for x, y in zip(tleaves, jax.tree_util.tree_leaves(rc)):
        assert tuple(x.shape) == y.shape and str(x.dtype) == f"torch.{y.dtype}"
        np.testing.assert_array_equal(f32(x), f32(y))


# ------------------------------------------------------ chip_smoke's answers
@pytest.mark.parametrize("arch", list(chip_smoke.KA_FAMILY_LOGITS))
def test_family_known_answers_pinned(arch):
    """chip_smoke.KA_FAMILY_LOGITS are the reference's prefill logits of
    the reduced config on numpy_params(cfg, KA_MODEL_SEED) and the known
    batch, and the port on the CPU reproduces them within KA_MODEL_ATOL."""
    over = chip_smoke.KA_FAMILY_OVERRIDES.get(arch, {})
    tcfg, rcfg = cfgs(arch, **over)
    tree = tmodels.numpy_params(tcfg, chip_smoke.KA_MODEL_SEED)
    batch = chip_smoke.ka_family_batch(np, tcfg)
    rl, _ = RModel(rcfg).prefill(ref_tree(tree),
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 q_chunk=None)
    want = np.asarray(rl)[0, -1, chip_smoke.KA_MODEL_SLICE]
    np.testing.assert_array_equal(
        want, np.asarray(chip_smoke.KA_FAMILY_LOGITS[arch], np.float32))
    tl, _ = TModel(tcfg).prefill(
        port_tree(tree), {k: torch.from_numpy(v) for k, v in batch.items()},
        q_chunk=None)
    np.testing.assert_allclose(tl[0, -1, chip_smoke.KA_MODEL_SLICE].numpy(),
                               want, rtol=0, atol=chip_smoke.KA_MODEL_ATOL)


@pytest.mark.parametrize("arch", list(chip_smoke.FAMILIES))
def test_family_cuts_match_reference_param_bytes(arch):
    """The smoke's depth cuts: the port's tree (on the meta device) has
    the bytes the reference's Model.init has under eval_shape."""
    layers = chip_smoke.FAMILIES[arch]["layers"]
    rcfg = dataclasses.replace(rconfigs.get_config(arch), **layers)
    shapes = jax.eval_shape(RModel(rcfg).init, jax.random.PRNGKey(0))
    want = sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(shapes))
    assert want == chip_smoke.FAMILIES[arch]["param_bytes"]
    tcfg = chip_smoke.family_config(dataclasses, tconfigs.get_config, arch)
    assert chip_smoke.model_param_bytes(torch, tcfg) == want
