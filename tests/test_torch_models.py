"""Port parity — configs and the model stack.

repro_torch.configs / repro_torch.models against repro.configs /
repro.models on the CPU, the same seeded numpy inputs through both, the
reference's Pallas-free code run as its own tests run it.  Configs are
equal field for field.  Model math is held to a stated tolerance:

* fp32 paths (RoPE angles, activations, flash) to float32 rounding;
* bf16 paths to a few bf16 steps.  bf16 keeps 8 significant bits, so a
  value of magnitude 2-4 moves in steps of 2^-6..2^-5 (0.016-0.031).  XLA
  on the CPU evaluates chains of bf16 elementwise ops in fp32 and rounds
  once where torch rounds after each op, so the two packages sit a few
  steps apart: LOGIT_ATOL allows four steps at magnitude 4 (hidden
  states, cached keys and values, logits), and every argmax whose
  reference top-2 margin exceeds twice that must agree.

Weights are carried across: one tree from numpy.random.default_rng
(`repro_torch.models.numpy_params`) feeds both packages.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import no_cuda  # noqa: F401 (fixture)

from repro import configs as rconfigs
from repro.configs import paper_msr as rpaper
from repro.core import placement as rplace
from repro.models import Model as RModel
from repro.models import attention as rattn
from repro.models import ffn as rffn
from repro.models import flash as rflash
from repro.models import layers as rlayers
from repro_torch.models.frontend import mrope_positions
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.configs import paper_msr as tpaper
from repro_torch.core import placement as tplace
from repro_torch.models import Model as TModel
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

LOGIT_ATOL = 0.125
BF16_RTOL = 2.0 ** -7          # one bf16 step, relative
F32_TOL = 2e-5                 # the reference's own flash tolerance
SEQ = 32
BATCH = 2
STATE_RTOL = 4 * 2.0 ** -7     # four bf16 steps at a state's largest value
PORTED_ARCHS = tuple(rconfigs.registry._ARCH_MODULES)     # all eleven
# Whole-model parity runs MoE dropless, as tests/test_models_smoke.py's
# prefill/decode consistency does (capacity drops follow the chunking;
# tests/test_torch_families.py holds them exactly on identical inputs),
# and xlstm at one full cycle plus an mLSTM remainder: its 16 reduced
# layers amplify one layer's bf16 rounding differences through the
# residual stream to four steps on the hidden states
# (test_torch_families.py holds each of the 16 layers on the reference's
# own input instead).
MODEL_OVERRIDES = {"granite-moe-1b-a400m": {"capacity_factor": 1e9},
                   "arctic-480b": {"capacity_factor": 1e9},
                   "xlstm-1.3b": {"n_layers": 9}}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def both(a: np.ndarray, dtype=np.float32):
    """One numpy array as a JAX array and a CPU tensor, of ``dtype``
    (``"bf16"`` rounds both to bfloat16)."""
    if dtype == "bf16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def rng_normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def assert_bf16_close(got, want, atol=0.0, err_msg=""):
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 * BF16_RTOL,
                               atol=atol, err_msg=err_msg)


def assert_logits_close(got, want, err_msg=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                               err_msg=err_msg)
    top2 = np.sort(want, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure],
                                  err_msg=err_msg)


def arch_cfgs(arch):
    """(port cfg, reference cfg): reduced (with MODEL_OVERRIDES), except
    paper-tiny-lm at its own full size."""
    t, r = tconfigs.get_config(arch), rconfigs.get_config(arch)
    if arch == "paper-tiny-lm":
        return t, r
    over = MODEL_OVERRIDES.get(arch, {})
    return t.reduced(**over), r.reduced(**over)


def carried(cfg, seed=0):
    """One numpy parameter tree as the reference's and the port's."""
    tree = tmodels.numpy_params(cfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tmodels.params_from_numpy(tree, device="cpu"))


class RoutingReplay:
    """Whole-model parity of an MoE config.  Routing is a discontinuous
    function of the router logits: where two experts' logits sit within
    the bf16 noise the two packages' hidden states carry (a few steps),
    each package may pick a different one and that token's output moves
    by a whole expert's share.  So the reference runs first, with jit
    disabled, and its top-k choices are recorded; each of the port's
    top-k calls (the reference's run eagerly too, grads included, with
    remat off: jit and remat change its rounding) then checks its own
    choices against the reference's call on the nearest probabilities — every token where they differ must be
    a near-tie in the reference, its swapped experts' log-probabilities
    within LOGIT_ATOL — and replays the reference's choices, so the rest
    of the model is compared on equal routing.  Routing itself is held
    exactly on identical inputs in tests/test_torch_families.py."""

    def __init__(self, monkeypatch):
        self.ref: list = []
        real_ref, real_port = jax.lax.top_k, tmoe.top_k

        def ref_top_k(a, k):
            out = real_ref(a, k)
            idx = out[1]
            while hasattr(a, "primal"):     # an eager grad: its values
                a, idx = a.primal, getattr(idx, "primal", idx)
            self.ref.append((np.asarray(a, np.float32), np.asarray(idx)))
            return out

        def port_top_k(probs, k):
            _, own = real_port(probs, k)
            p = probs.detach().float().cpu().numpy()
            rp, ridx = min((r for r in self.ref if r[0].shape == p.shape),
                           key=lambda r: float(np.abs(r[0] - p).max()))
            own = own.cpu().numpy()
            for pos in zip(*np.nonzero((np.sort(own, -1)
                                        != np.sort(ridx, -1)).any(-1))):
                mine = set(own[pos].tolist()) - set(ridx[pos].tolist())
                theirs = set(ridx[pos].tolist()) - set(own[pos].tolist())
                logp = np.log(rp[pos])
                gap = max(abs(logp[a] - logp[b]) for a in mine for b in theirs)
                assert gap <= LOGIT_ATOL, (pos, mine, theirs, gap)
            idx = torch.from_numpy(ridx.astype(np.int64)).to(probs.device)
            return torch.gather(probs, -1, idx), idx

        monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
        monkeypatch.setattr(tmoe, "top_k", port_top_k)

    @staticmethod
    def for_cfg(cfg, monkeypatch):
        """The context for the reference's calls: for an MoE config, jit
        disabled with the replay installed; otherwise nothing."""
        if not cfg.n_experts:
            return contextlib.nullcontext
        RoutingReplay(monkeypatch)
        return jax.disable_jit


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list(rconfigs.registry._ARCH_MODULES))
def test_config_fields_match(arch):
    t, r = tconfigs.get_config(arch), rconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(r.reduced())
    over = {"head_dim": 32, "n_layers": 3}
    assert dataclasses.asdict(t.reduced(**over)) == \
        dataclasses.asdict(r.reduced(**over))
    for c, d in ((t, r), (t.reduced(), r.reduced())):
        assert c.expanded_pattern() == d.expanded_pattern()
        assert c.cycles() == d.cycles()
        assert c.is_subquadratic() == d.is_subquadratic()


def test_registry_and_shapes_match():
    assert tconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert tconfigs.cells() == rconfigs.cells()
    assert tconfigs.skipped_cells() == rconfigs.skipped_cells()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    for name in rconfigs.SHAPES:
        assert dataclasses.asdict(tconfigs.get_shape(name)) == \
            dataclasses.asdict(rconfigs.get_shape(name))
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
    with pytest.raises(ValueError):
        tconfigs.ModelConfig(name="x", family="dense", n_layers=1, d_model=8,
                             n_heads=3, n_kv_heads=2, d_ff=8, vocab_size=8)


def test_paper_code_presets_match():
    for name in ("CODE_4_2_F257", "CODE_6_3_F5", "CODE_16_8_F257"):
        t, r = getattr(tpaper, name), getattr(rpaper, name)
        assert (t.k, t.n, t.p, tuple(t.c)) == (r.k, r.n, r.p, tuple(r.c))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_apply_norm_matches(norm):
    cfg = dataclasses.replace(tconfigs.get_config("qwen3-4b").reduced(),
                              norm=norm)
    rx, tx = both(rng_normal((2, 7, 64), 0, 3.0), "bf16")
    params = {"scale": 1.0 + rng_normal((64,), 1, 0.1)}
    if norm == "layer":
        params["bias"] = rng_normal((64,), 2, 0.1)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got, want = tlayers.apply_norm(cfg, tp, tx), rlayers.apply_norm(cfg, rp, rx)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want)
    assert_bf16_close(tlayers.rms_head_norm(tx, tp["scale"], 1e-6),
                      rlayers.rms_head_norm(rx, rp["scale"], 1e-6))
    init_t = tlayers.init_norm(cfg, 64, device="cpu")
    init_r = rlayers.init_norm(cfg, 64)
    assert sorted(init_t) == sorted(init_r)
    for k in init_r:
        np.testing.assert_array_equal(init_t[k].numpy(), np.asarray(init_r[k]))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    pos = np.random.default_rng(3).integers(0, 64, (2, 9)).astype(np.int32)
    rc, rs = rlayers.rope_angles(jnp.asarray(pos), 16, theta)
    tc, ts = tlayers.rope_angles(torch.from_numpy(pos), 16, theta)
    assert tc.dtype == torch.float32 and tc.shape == (2, 9, 8)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=F32_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=F32_TOL)
    rx, tx = both(rng_normal((2, 9, 3, 16), 4), "bf16")
    assert_bf16_close(tlayers.apply_rope(tx, tc, ts),
                      rlayers.apply_rope(rx, rc, rs), atol=2 * BF16_RTOL)
    # (s, hd/2) angles broadcast over the batch
    assert_bf16_close(tlayers.apply_rope(tx, tc[0], ts[0]),
                      rlayers.apply_rope(rx, rc[0], rs[0]), atol=2 * BF16_RTOL)


def test_mrope_and_positions_to_angles_match():
    tcfg, rcfg = arch_cfgs("qwen2-vl-72b")
    assert tcfg.mrope_sections == rcfg.mrope_sections
    pos3 = np.asarray(mrope_positions(2, 12, image_tokens=4, grid_hw=(2, 2)))
    pos2 = np.random.default_rng(5).integers(0, 40, (2, 12)).astype(np.int32)
    for pos in (pos3, pos2):
        rc, rs = rlayers.positions_to_angles(rcfg, jnp.asarray(pos))
        tc, ts = tlayers.positions_to_angles(tcfg, torch.from_numpy(pos))
        np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=F32_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=F32_TOL)
    with pytest.raises(ValueError):
        tlayers.mrope_angles(torch.from_numpy(pos3), 16, 1e4, (1, 1, 1))


@pytest.mark.parametrize("name", ["silu", "gelu", "geglu"])
def test_activations_match(name):
    rx, tx = both(rng_normal((4, 33), 6, 3.0))
    np.testing.assert_allclose(tlayers.act_fn(name)(tx).numpy(),
                               np.asarray(rlayers.act_fn(name)(rx)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["silu", "gelu", "geglu"])
def test_bf16_activations_match_reference_bit_for_bit(name):
    """On bf16 inputs the reference's jax.nn activations round after each
    of their elementwise ops (sigmoid as 1 / (1 + exp(-x)), gelu's tanh
    form with its constants in bf16); the port composes the same ops, so
    every output is the reference's bf16 value, and sigmoid's derivative
    is the reference's g * (ans * (1 - ans)), rounded in its order."""
    x = rng_normal((4, 4096), 11, 4.0)
    x[0, :4] = (-100.0, 100.0, 0.0, -0.0)         # exp(-x) overflows
    rx, tx = both(x, "bf16")
    got = tlayers.act_fn(name)(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(rlayers.act_fn(name)(rx)))
    g = rng_normal((4, 4096), 12)
    rg, tg = both(g, "bf16")
    tx.requires_grad_(True)
    (tgot,) = torch.autograd.grad(tlayers.sigmoid(tx), tx, tg)
    _, vjp = jax.vjp(jax.nn.sigmoid, rx)
    (rgot,) = vjp(rg)
    assert bool(torch.isfinite(tgot).all())
    np.testing.assert_array_equal(f32(tgot), f32(rgot))


# ------------------------------------------------------------------- flash
def flash_inputs(b=2, sq=64, sk=64, h=4, hd=16, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    qkv = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
           for shape in ((b, sq, h, hd), (b, sk, h, hd), (b, sk, h, hd))]
    pos_q = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (b, sq))
    pos_k = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk))
    pairs = [both(x, dtype) for x in qkv] + [both(np.array(pos_q)),
                                              both(np.array(pos_k))]
    return [p[0] for p in pairs], [p[1] for p in pairs]


FLASH_CASES = {
    # name: (sq, sk, causal, window, kv_chunk, dtype)
    "causal-16": (64, 64, True, None, 16, np.float32),
    "causal-64": (64, 64, True, None, 64, np.float32),
    "bidir-16": (64, 64, False, None, 16, np.float32),
    "bidir-64": (64, 64, False, None, 64, np.float32),
    "window-16": (64, 64, True, 16, 16, np.float32),
    "window-64": (64, 64, True, 16, 64, np.float32),
    "one-query": (1, 96, True, None, 32, np.float32),
    "masked-chunk": (32, 128, True, 8, 32, np.float32),
    "bf16": (64, 64, True, None, 32, "bf16"),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_forward_matches(case):
    """The cases of tests/test_flash.py, gradients aside: the port's flash
    forward against the reference's flash and its materializing path."""
    sq, sk, causal, window, kv_chunk, dtype = FLASH_CASES[case]
    r, t = flash_inputs(sq=sq, sk=sk, dtype=dtype)
    got = tflash.flash_attention(*t, causal, window, kv_chunk)
    want = rflash.flash_attention(*r, causal, window, kv_chunk)
    plain = rattn._sdpa(r[0], r[1], r[2], rattn._mask_bias(
        r[3], r[4], causal=causal, window=window))
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    if dtype == "bf16":     # flash runs in fp32: one bf16 rounding at the end
        assert_bf16_close(got, want, atol=2 * BF16_RTOL)
        np.testing.assert_allclose(f32(got), f32(plain), rtol=3e-2, atol=3e-2)
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(f32(got), f32(plain), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_flash_rejects_ragged_chunks():
    _, t = flash_inputs(sq=4, sk=100)
    with pytest.raises(ValueError):     # 100 keys do not split into 3 chunks
        tflash.flash_attention(*t, True, None, 32)


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("path", ["plain", "q_chunk", "flash"])
def test_attention_paths_match(path, monkeypatch):
    """GQA attention (4 query heads over 2 kv heads) on each of its three
    paths.  The flash path is reached by lowering FLASH_MIN_ELEMS in both
    packages to this shape's score count (the real threshold, 2^28, is
    checked equal)."""
    assert tattn.FLASH_MIN_ELEMS == rattn.FLASH_MIN_ELEMS == 2 ** 28
    cfg = tconfigs.get_config("qwen3-4b").reduced()
    b, s, h, m, hd = 1, 2048 if path == "flash" else 64, 4, 2, 16
    rng = np.random.default_rng(7)
    q, k, v = [(rng.standard_normal((b, s, n, hd)) * 0.5).astype(np.float32)
               for n in (h, m, m)]
    (rq, tq), (rk, tk), (rv, tv) = (both(x, "bf16") for x in (q, k, v))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    rp, tp = both(pos)
    calls = []
    if path == "flash":
        elems = b * h * s * s
        monkeypatch.setattr(rattn, "FLASH_MIN_ELEMS", elems)
        monkeypatch.setattr(tattn, "FLASH_MIN_ELEMS", elems)
        real = tattn.flash_attention
        monkeypatch.setattr(tattn, "flash_attention",
                            lambda *a: calls.append(a[1].shape) or real(*a))
    q_chunk = 16 if path == "q_chunk" else None
    for window in (None, 24):
        got = tattn.attention(cfg, tq, tk, tv, q_pos=tp, k_pos=tp,
                              window=window, q_chunk=q_chunk)
        want = rattn.attention(cfg, rq, rk, rv, q_pos=rp, k_pos=rp,
                               window=window, q_chunk=q_chunk)
        assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, hd)
        assert_bf16_close(got, want, atol=4 * BF16_RTOL, err_msg=str(window))
    if path == "flash":     # repeat-kv before flash: h heads, not m
        assert calls == [(b, s, h, hd)] * 2
    if path == "q_chunk":
        with pytest.raises(ValueError):
            tattn.attention(cfg, tq, tk, tv, q_pos=tp, k_pos=tp, q_chunk=24)


def test_attention_validity_mask_matches():
    """The decode form: one query against a cache, invalid slots masked."""
    cfg = tconfigs.get_config("qwen3-4b").reduced()
    rng = np.random.default_rng(8)
    q = (rng.standard_normal((2, 1, 4, 16)) * 0.5).astype(np.float32)
    kv = (rng.standard_normal((2, 40, 2, 16)) * 0.5).astype(np.float32)
    (rq, tq), (rk, tk) = both(q, "bf16"), both(kv, "bf16")
    valid = np.arange(40)[None].repeat(2, 0) <= 29
    qp = np.full((2, 1), 29, np.int32)
    kp = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    got = tattn.attention(cfg, tq, tk, tk, q_pos=torch.from_numpy(qp),
                          k_pos=torch.from_numpy(kp),
                          k_valid=torch.from_numpy(valid))
    want = rattn.attention(cfg, rq, rk, rk, q_pos=jnp.asarray(qp),
                           k_pos=jnp.asarray(kp), k_valid=jnp.asarray(valid))
    assert_bf16_close(got, want, atol=4 * BF16_RTOL)


def test_window_cache_helpers_match():
    """Ring and append caches are data movement: exactly equal."""
    cfg = tconfigs.get_config("gemma3-27b").reduced(window_size=8)
    for pos in (0, 3, 7, 8, 13, 31):
        np.testing.assert_array_equal(
            tattn.window_slot_positions(pos, 8).numpy(),
            np.asarray(rattn.window_slot_positions(jnp.int32(pos), 8)))
    for s in (5, 8, 13, 16, 21):
        x = rng_normal((2, s, 2, 16), s)
        rk, tk = both(x, "bf16")
        rv, tv = both(x * 2, "bf16")
        got = tattn.prefill_to_window_cache(cfg, tk, tv, s)
        want = rattn.prefill_to_window_cache(cfg, rk, rv, s)
        for key in ("k", "v"):
            np.testing.assert_array_equal(f32(got[key]), f32(want[key]))
    tc = tattn.init_window_cache(cfg, 2, device="cpu")
    rc = rattn.init_window_cache(cfg, 2)
    tg = tattn.init_global_cache(cfg, 2, 12, device="cpu")
    rg = rattn.init_global_cache(cfg, 2, 12)
    for pos in (0, 9, 11):
        rn, tn = both(rng_normal((2, 1, 2, 16), 100 + pos), "bf16")
        tc = tattn.window_cache_update(tc, tn, tn, pos)
        rc = rattn.window_cache_update(rc, rn, rn, jnp.int32(pos))
        tg = tattn.global_cache_update(tg, tn, tn, pos)
        rg = rattn.global_cache_update(rg, rn, rn, jnp.int32(pos))
        for key in ("k", "v"):
            np.testing.assert_array_equal(f32(tc[key]), f32(rc[key]))
            np.testing.assert_array_equal(f32(tg[key]), f32(rg[key]))
    # a write past the end is clamped to fit, as dynamic_update_slice does
    rn, tn = both(rng_normal((2, 3, 2, 16), 9), "bf16")
    np.testing.assert_array_equal(
        f32(tattn.global_cache_update(tg, tn, tn, 11)["k"]),
        f32(rattn.global_cache_update(rg, rn, rn, jnp.int32(11))["k"]))


# --------------------------------------------------------------------- ffn
@pytest.mark.parametrize("act", ["silu", "gelu", "geglu"])
def test_apply_ffn_matches(act):
    cfg = dataclasses.replace(tconfigs.get_config("qwen3-4b").reduced(),
                              act=act)
    params = tffn.init_ffn(cfg, np.random.default_rng(0), device="cpu")
    assert ("w_gate" in params) == (act != "gelu")
    rp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    rx, tx = both(rng_normal((2, 5, 64), 1), "bf16")
    got, want = tffn.apply_ffn(cfg, params, tx), rffn.apply_ffn(cfg, rp, rx)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want, atol=4 * BF16_RTOL)


# ------------------------------------------------------------------- model
def model_batch(cfg, seq, seed, batch=BATCH):
    """A numpy batch: tokens, or for [vlm] embeddings and M-RoPE streams;
    an encoder-decoder's tokens come with frame embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_as_input and not cfg.is_encoder_decoder:
        out = {"inputs_embeds": rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)
                                      ).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        out["positions"] = np.asarray(
            mrope_positions(batch, seq, image_tokens=8, grid_hw=(2, 4)))
    return out


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_param_tree_matches_reference_structure():
    """Model.init builds the reference's tree: the same treedef string,
    leaf names, shapes and dtypes (placement's leaf metas), for a config
    with full cycles and a remainder layer."""
    for arch, over in (("qwen3-4b", {}), ("gemma3-27b", {"n_layers": 8}),
                       ("paper-tiny-lm", {"n_layers": 3}),
                       ("yi-34b", {"param_dtype": "bfloat16"})):
        tcfg = tconfigs.get_config(arch).reduced(**over)
        rcfg = rconfigs.get_config(arch).reduced(**over)
        tp = TModel(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
        rp = RModel(rcfg).init(jax.random.PRNGKey(0))
        _, ttd, tmeta = tplace.pytree_to_bytes(tp)
        _, rtd, rmeta = rplace.pytree_to_bytes(rp)
        assert str(ttd) == str(rtd) and tmeta == rmeta, arch
        assert isinstance(tp["stack"]["cycles"], tuple)
        assert ("lm_head" in tp) == (not tcfg.tie_embeddings)


def test_params_from_numpy_keeps_structure_and_dtypes():
    tcfg, rcfg = arch_cfgs("gemma3-27b")
    rp = jax.device_get(RModel(rcfg).init(jax.random.PRNGKey(1)))
    rp["extra_bf16"] = np.asarray(jnp.arange(6, dtype=jnp.bfloat16))
    tp = tmodels.params_from_numpy(rp, device="cpu")
    assert isinstance(tp["stack"]["cycles"], tuple)
    assert tp["extra_bf16"].dtype == torch.bfloat16
    assert tplace.pytree_to_bytes(tp)[0] == rplace.pytree_to_bytes(rp)[0]
    a, b = tmodels.numpy_params(tcfg, 3), tmodels.numpy_params(tcfg, 3)
    for x, y in zip(tplace.tree_flatten(a)[0], tplace.tree_flatten(b)[0]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.float32 and np.abs(x).max() <= 2.0


def assert_cache_close(got, want, err_msg=""):
    """Caches leaf by leaf: the reference's shapes and dtypes; bf16 leaves
    (keys and values) within LOGIT_ATOL, fp32 recurrent states within
    STATE_RTOL of their largest magnitude."""
    tleaves, _ = tplace.tree_flatten(got)
    rleaves = jax.tree_util.tree_leaves(want)
    assert len(tleaves) == len(rleaves)
    for x, y in zip(tleaves, rleaves):
        assert tuple(x.shape) == y.shape and str(x.dtype) == f"torch.{y.dtype}"
        atol = (LOGIT_ATOL if y.dtype == jnp.bfloat16
                else STATE_RTOL * float(np.abs(f32(y)).max()))
        np.testing.assert_allclose(f32(x), f32(y), rtol=0, atol=atol,
                                   err_msg=err_msg)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_model_matches_reference(arch, monkeypatch):
    """forward (train), prefill (global, ring, recurrent and cross caches)
    and three decode steps of each config, on carried weights (an MoE
    config's routing replayed from the reference: RoutingReplay)."""
    tcfg, rcfg = arch_cfgs(arch)
    rp, tp = carried(tcfg)
    rm, tm = RModel(rcfg), TModel(tcfg)
    seq, max_len = 40, 48       # gemma3's reduced window is 32 < seq
    batch = model_batch(tcfg, seq, 1)
    ref_mode = RoutingReplay.for_cfg(tcfg, monkeypatch)

    with ref_mode():
        h_r, _, aux_r = rm.forward(rp, to_ref(batch), "train", remat=False)
    h_t, c_t, aux = tm.forward(tp, to_port(batch), "train")
    assert c_t is None and h_t.dtype == torch.bfloat16
    assert (float(aux) > 0) == bool(tcfg.n_experts)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-3)
    np.testing.assert_allclose(f32(h_t), f32(h_r), rtol=0, atol=LOGIT_ATOL)

    with ref_mode():
        rl, rcache = rm.prefill(rp, to_ref(batch), max_len=max_len,
                                q_chunk=None)
    tl, tcache = tm.prefill(tp, to_port(batch), max_len=max_len, q_chunk=None)
    assert tl.dtype == torch.float32 and tl.shape == (BATCH, 1,
                                                      tcfg.vocab_size)
    assert_logits_close(tl, rl, arch)
    assert_cache_close(tcache, rcache, arch)

    tok = np.asarray(rl).argmax(-1).astype(np.int32)
    for step in range(3):
        with ref_mode():
            rl, rcache = rm.decode_step(rp, rcache, jnp.asarray(tok),
                                        jnp.asarray(seq + step, jnp.int32),
                                        max_len=max_len)
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                    seq + step, max_len=max_len)
        assert_logits_close(tl, rl, f"{arch} decode {step}")
        tok = np.asarray(rl).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b"])
def test_chunked_prefill_matches_reference(arch):
    tcfg, rcfg = arch_cfgs(arch)
    rp, tp = carried(tcfg, seed=2)
    batch = model_batch(tcfg, 48, 3)
    tl, _ = TModel(tcfg).prefill(tp, to_port(batch), max_len=56, q_chunk=16)
    rl, _ = RModel(rcfg).prefill(rp, to_ref(batch), max_len=56, q_chunk=16)
    assert_logits_close(tl, rl, arch)


def test_prefill_cache_is_not_aliased_by_decode():
    """A cache handed back by prefill stays as it was when decode steps run
    from it, so two engines may branch from one prefill."""
    tcfg, _ = arch_cfgs("gemma3-27b")
    _, tp = carried(tcfg)
    tm = TModel(tcfg)
    batch = to_port(model_batch(tcfg, 40, 4))
    _, cache = tm.prefill(tp, batch, max_len=48)
    before = [x.clone() for x in tplace.tree_flatten(cache)[0]]
    tok = torch.zeros((BATCH, 1), dtype=torch.int32)
    la, _ = tm.decode_step(tp, cache, tok, 40, max_len=48)
    lb, _ = tm.decode_step(tp, cache, tok + 1, 40, max_len=48)
    la2, _ = tm.decode_step(tp, cache, tok, 40, max_len=48)
    for x, y in zip(tplace.tree_flatten(cache)[0], before):
        assert torch.equal(x, y)
    assert torch.equal(la, la2) and not torch.equal(la, lb)


# ------------------------------------- mirrors of tests/test_models_smoke.py
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Teacher-forced consistency: decode_step(t_s at pos s) logits match a
    fresh full forward over s+1 tokens at the last position (the
    reference test's criteria)."""
    tcfg, _ = arch_cfgs(arch)
    _, tp = carried(tcfg, seed=4)
    tm = TModel(tcfg)
    full = to_port(model_batch(tcfg, SEQ + 1, 5))
    max_len = SEQ + 1
    prefix = {k: v if k == "enc_embeds" else
              v[..., :SEQ] if k != "inputs_embeds" else v[:, :SEQ]
              for k, v in full.items()}
    _, cache = tm.prefill(tp, prefix, max_len=max_len, q_chunk=16)
    if "tokens" in full:
        dec, _ = tm.decode_step(tp, cache, full["tokens"][:, SEQ:SEQ + 1],
                                SEQ, max_len=max_len)
    else:
        step = {"inputs_embeds": full["inputs_embeds"][:, SEQ:SEQ + 1],
                "positions": full["positions"][..., SEQ:SEQ + 1]}
        h1, _, _ = tm.forward(tp, step, "decode", cache, pos=SEQ,
                              max_len=max_len)
        dec = tm._logits(tp, h1)
    h, _, _ = tm.forward(tp, full, "train")
    ref = tm._logits(tp, h[:, -1:])
    dec, ref = f32(dec), f32(ref)
    np.testing.assert_array_equal(dec.argmax(-1), ref.argmax(-1), err_msg=arch)
    close = np.isclose(dec, ref, rtol=0.15, atol=0.15)
    assert close.mean() > 0.98, (arch, float(close.mean()))
    assert np.abs(dec - ref).max() < 1.0, arch


def test_window_attention_masks_past():
    """One local-attention layer: perturbing a token more than a window in
    the past leaves the last position's output unchanged."""
    cfg = tconfigs.get_config("gemma3-27b").reduced(
        n_layers=1, layer_pattern=("la",), window_size=8)
    tm = TModel(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, SEQ)).astype(np.int32))
    tok2 = tok.clone()
    tok2[0, 2] = (tok[0, 2] + 7) % cfg.vocab_size
    out1, _, _ = tm.forward(tp, {"tokens": tok}, "train")
    out2, _, _ = tm.forward(tp, {"tokens": tok2}, "train")
    np.testing.assert_allclose(f32(out1[:, -1]), f32(out2[:, -1]),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(f32(out1[:, 3]), f32(out2[:, 3]))


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b", "starcoder2-7b"])
def test_causality(arch):
    """Perturbing a future token does not change past hidden states."""
    cfg = tconfigs.get_config(arch).reduced()
    tm = TModel(cfg)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, SEQ)).astype(np.int32))
    tok2 = tok.clone()
    tok2[0, SEQ - 1] = (tok[0, SEQ - 1] + 3) % cfg.vocab_size
    o1, _, _ = tm.forward(tp, {"tokens": tok}, "train")
    o2, _, _ = tm.forward(tp, {"tokens": tok2}, "train")
    np.testing.assert_allclose(f32(o1[:, :SEQ - 1]), f32(o2[:, :SEQ - 1]),
                               rtol=1e-4, atol=1e-4, err_msg=arch)


def test_model_entry_points_default_to_the_card(no_cuda):
    cfg = tconfigs.get_config("qwen3-4b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TModel(cfg).init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmodels.params_from_numpy({"w": np.zeros(2, np.float32)})
