"""Port parity — the block kinds beyond dense attention and the
encoder-decoder path: MoE ("gm"), Griffin RG-LRU ("rg"), xLSTM ("ml",
"sl"), cross-attention and the encoder ("enc"), and the frontend stubs.

Each module of repro_torch.models against its twin in repro.models on
the CPU, the same seeded numpy inputs through both.  Tolerances:

* MoE routing (`gate_idx`, `pos_in_expert`, `keep`) EXACTLY equal on
  inputs whose router products sum exactly in fp32 in any order, so both
  packages see the same bf16 logits — ties included, which
  ``jax.lax.top_k`` and the port's stable sort both give to the lower
  expert index; the MoE output within two bf16 steps at its magnitude,
  the aux loss to fp32 rounding;
* fp32 recurrences (the LRU scan, mLSTM and sLSTM states) to fp32
  rounding: F32_RTOL relative to the largest magnitude of the compared
  tensor (the port's scan combines in another tree order);
* bf16 block outputs within two bf16 steps at their magnitude.

Gradients are in tests/test_torch_family_grads.py, each layer at full
reduced depth, the trees and the smoke's known answers in
tests/test_torch_family_models.py, whole-model parity of all eleven
configs in tests/test_torch_models.py.

Weights are carried across (`repro_torch.models.numpy_params`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import Model as RModel
from repro.models import frontend as rfront
from repro.models import moe as rmoe
from repro.models import rglru as rrg
from repro.models import transformer as rtfm
from repro.models import xlstm as rxl
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.core import placement as tplace
from repro_torch.models import Model as TModel
from repro_torch.models import attention as tattn
from repro_torch.models import frontend as tfront
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttfm
from repro_torch.models import xlstm as txl

LOGIT_ATOL = 0.125          # tests/test_torch_models.py
F32_RTOL = 1e-5
AUX_RTOL = 1e-6
BF16_STEP = 2.0 ** -7       # a bf16 step, relative to a value's magnitude


def f32(x) -> np.ndarray:
    """fp32 numpy copy (writable, so torch.from_numpy may take it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def both(a: np.ndarray, dtype=np.float32):
    """One numpy array as a JAX array and a CPU tensor (``"bf16"``: both
    rounded to bfloat16)."""
    if dtype == "bf16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def ref_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_tree(tree):
    return tmodels.params_from_numpy(tree, device="cpu")


def numpy_tree(params):
    leaves, tdef = tplace.tree_flatten(params)
    return tdef.unflatten([x.numpy() for x in leaves])


def within_steps(got, want, n=2, err_msg=""):
    """|got - want| <= n bf16 steps at the largest magnitude of want."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = n * BF16_STEP * max(float(np.abs(want).max()), 2.0 ** -126)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=err_msg)


def f32_close(got, want, err_msg=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_RTOL * scale,
                               err_msg=err_msg)


def states_close(got: dict, want: dict, err_msg=""):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        f32_close(got[k], want[k], err_msg=f"{err_msg} {k}")


def cfgs(arch, **over):
    return (tconfigs.get_config(arch).reduced(**over),
            rconfigs.get_config(arch).reduced(**over))


# --------------------------------------------------------------------- MoE
def exact_router_inputs(cfg, b, s, seed, tie=False):
    """x (b, s, d) and a router whose products are multiples of 2^-14 and
    whose sums stay below 2^4: every partial sum is exact in fp32, so the
    bf16 logits are the same in both packages whatever the summation
    order.  ``tie`` makes expert 2's router column a copy of expert 1's:
    their logits tie exactly, for every token."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-64, 65, (b, s, cfg.d_model)) / 64.0
    router = rng.integers(-64, 65, (cfg.d_model, cfg.n_experts)) / 256.0
    if tie:
        router[:, 2] = router[:, 1]
    return x.astype(np.float32), router.astype(np.float32)


class RefMoeCapture:
    """The reference's routing of each chunk, read from its own calls:
    ``jax.lax.top_k``'s indices and the two ``jax.nn.one_hot`` calls per
    chunk (experts, then queue positions), run with jit disabled so the
    chunk scan is a Python loop over concrete arrays."""

    def __init__(self, monkeypatch):
        self.top_k, self.one_hot = [], []
        real_top_k, real_one_hot = jax.lax.top_k, jax.nn.one_hot

        def top_k(a, k):
            out = real_top_k(a, k)
            self.top_k.append(np.asarray(out[1]))
            return out

        def one_hot(a, n, **kw):
            self.one_hot.append(np.asarray(a))
            return real_one_hot(a, n, **kw)

        monkeypatch.setattr(jax.lax, "top_k", top_k)
        monkeypatch.setattr(jax.nn, "one_hot", one_hot)

    @property
    def positions(self) -> list:
        """The second one-hot of each chunk: its queue positions."""
        return self.one_hot[1::2]


MOE_CASES = {
    # name: (arch, overrides, batch, seq, tie)
    "one-chunk": ("granite-moe-1b-a400m", {}, 2, 16, False),
    "two-chunks": ("granite-moe-1b-a400m", {}, 2, 32, False),
    "ties": ("granite-moe-1b-a400m", {}, 2, 32, True),
    "dropless": ("granite-moe-1b-a400m", {"capacity_factor": 1e9}, 2, 32,
                 False),
    "decode": ("granite-moe-1b-a400m", {}, 3, 1, False),
    "ragged": ("granite-moe-1b-a400m", {}, 1, 24, True),
    "arctic-residual": ("arctic-480b", {}, 2, 32, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case, monkeypatch):
    arch, over, b, s, tie = MOE_CASES[case]
    tcfg, rcfg = cfgs(arch, **over)
    params = tmoe.init_moe(tcfg, np.random.default_rng(1), device="cpu")
    assert ("residual" in params) == tcfg.dense_residual
    x, router = exact_router_inputs(tcfg, b, s, 2, tie)
    params["router"] = torch.from_numpy(router)
    rp = ref_tree(numpy_tree(params))
    rx, tx = both(x, "bf16")

    routes = []
    real_route = tmoe.route
    monkeypatch.setattr(tmoe, "route",
                        lambda *a: routes.append(real_route(*a)) or routes[-1])
    got, aux_t = tmoe.apply_moe(tcfg, params, tx)
    cap = RefMoeCapture(monkeypatch)
    with jax.disable_jit():
        want, aux_r = rmoe.apply_moe(rcfg, rp, rx)

    n_chunks = s // tcfg.moe_chunk if (s % tcfg.moe_chunk == 0
                                       and s > tcfg.moe_chunk) else 1
    assert len(routes) == len(cap.top_k) == n_chunks
    assert len(cap.one_hot) == 2 * n_chunks
    for idx, experts in zip(cap.top_k, cap.one_hot[0::2]):
        np.testing.assert_array_equal(experts, idx)
    kept = 0
    for r, idx, pos in zip(routes, cap.top_k, cap.positions):
        np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
        np.testing.assert_array_equal(r["pos_in_expert"].numpy(), pos)
        chunk = r["gate_idx"].shape[1]
        keep_r = pos < rmoe._capacity(chunk, rcfg)
        np.testing.assert_array_equal(r["keep"].numpy(), keep_r)
        kept += int(keep_r.sum())
    if tie:     # experts 1 and 2 tie for every token
        idx = np.concatenate([r["gate_idx"].numpy() for r in routes], 1)
        has1, has2 = (idx == 1).any(-1), (idx == 2).any(-1)
        assert not (has2 & ~has1).any(), "a tie goes to the lower index"
        assert (has1 & ~has2).any(), "a tie sat at the top-k boundary"
    if case in ("two-chunks", "ties"):
        assert kept < b * s * tcfg.n_experts_per_token, "capacity drops"
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, tcfg.d_model)
    within_steps(got, want, 2, case)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=AUX_RTOL,
                               atol=AUX_RTOL)


def test_route_breaks_ties_toward_the_lower_index():
    """Exact ties at and across the top-k boundary: the port's stable
    sort picks the experts ``jax.lax.top_k`` picks, in its order."""
    cfg, _ = cfgs("granite-moe-1b-a400m", n_experts=8,
                  n_experts_per_token=3)
    rng = np.random.default_rng(3)
    logits = rng.integers(-3, 4, (4, 64, 8)).astype(np.float32)
    logits[0, 0] = 1.0                                   # all eight tied
    rl, tl = both(logits)
    r = tmoe.route(cfg, tl, cap=5)
    _, want_idx = jax.lax.top_k(jax.nn.softmax(rl, axis=-1), 3)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), np.asarray(want_idx))
    assert r["gate_idx"][0, 0].tolist() == [0, 1, 2]
    # queue positions count earlier (token, choice) pairs of each expert
    onehot = np.eye(8)[r["gate_idx"].numpy()]            # (b,t,k,e)
    flat = onehot.reshape(4, -1, 8)
    pos = ((np.cumsum(flat, 1) - flat).reshape(onehot.shape) * onehot).sum(-1)
    np.testing.assert_array_equal(r["pos_in_expert"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), pos < 5)


def test_moe_capacity_matches_reference():
    for arch in ("granite-moe-1b-a400m", "arctic-480b"):
        for over in ({}, {"capacity_factor": 1e9}, {"capacity_factor": 0.1}):
            for reduced in (False, True):
                t = tconfigs.get_config(arch)
                r = rconfigs.get_config(arch)
                if reduced:
                    t, r = t.reduced(**over), r.reduced(**over)
                else:
                    t = dataclasses.replace(t, **over)
                    r = dataclasses.replace(r, **over)
                for chunk in (1, 7, 16, 1024):
                    assert tmoe._capacity(chunk, t) == rmoe._capacity(chunk, r)


# ------------------------------------------------------------------ RG-LRU
def rg_setup(seed=0):
    tcfg, rcfg = cfgs("recurrentgemma-2b")
    params = trg.init_rglru_block(tcfg, np.random.default_rng(seed),
                                  device="cpu")
    return tcfg, rcfg, params, ref_tree(numpy_tree(params))


def test_rglru_init_matches_reference_shapes_and_range():
    tcfg, rcfg, params, _ = rg_setup()
    want = rrg.init_rglru_block(rcfg, jax.random.PRNGKey(0))
    assert sorted(params) == sorted(want)
    for k in want:
        assert tuple(params[k].shape) == want[k].shape
        assert params[k].dtype == torch.float32
    # a^c = exp(-c softplus(lam)) in [0.9, 0.999], as the reference draws it
    ac = torch.exp(-8.0 * torch.nn.functional.softplus(params["lam"]))
    assert float(ac.min()) >= 0.9 - 1e-6 and float(ac.max()) <= 0.999 + 1e-6


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    tcfg, rcfg, params, rp = rg_setup()
    rng = np.random.default_rng(4)
    rx, tx = both(rng.standard_normal((2, 9, tcfg.rnn_width)), "bf16")
    rs = ts = None
    if with_state:
        rs, ts = both(rng.standard_normal((2, tcfg.conv_width - 1,
                                           tcfg.rnn_width)), "bf16")
    got, got_state = trg._causal_conv(params, tx, ts)
    want, want_state = rrg._causal_conv(rp, rx, rs)
    assert got.dtype == torch.bfloat16
    within_steps(got, want, 1)
    np.testing.assert_array_equal(f32(got_state), f32(want_state))


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_matches_reference(s, with_h0):
    """The doubling scan against the reference's associative scan, fp32,
    to F32_RTOL of the largest |h|; gates from the reference's own
    _rg_lru_gates on the same input."""
    tcfg, rcfg, params, rp = rg_setup()
    rng = np.random.default_rng(s)
    rx, tx = both(rng.standard_normal((2, s, tcfg.rnn_width)), "bf16")
    ra, rg = rrg._rg_lru_gates(rp, rx)
    ta, tg = trg._rg_lru_gates(params, tx)
    f32_close(ta, ra, "a")
    f32_close(tg, rg, "gated x")
    rh0 = th0 = None
    if with_h0:
        rh0, th0 = both(rng.standard_normal((2, tcfg.rnn_width)))
    ta, tg = torch.from_numpy(f32(ra)), torch.from_numpy(f32(rg))
    got = trg._lru_scan(ta, tg, th0)
    want = rrg._lru_scan(ra, rg, rh0)
    f32_close(got, want, f"s={s}")
    # the plain sequential recurrence, as a second opinion
    h = th0 if with_h0 else torch.zeros((2, tcfg.rnn_width))
    seq = []
    for t in range(s):
        h = ta[:, t] * h + tg[:, t]
        seq.append(h)
    f32_close(got, torch.stack(seq, 1), "sequential")


def test_rglru_block_prefill_and_decode_match_reference():
    tcfg, rcfg, params, rp = rg_setup(1)
    rng = np.random.default_rng(5)
    rx, tx = both(rng.standard_normal((2, 12, tcfg.d_model)), "bf16")
    got, tc = trg.apply_rglru_block(tcfg, params, tx)
    want, rc = rrg.apply_rglru_block(rcfg, rp, rx)
    within_steps(got, want, 2, "prefill")
    assert tc["conv"].dtype == torch.bfloat16 and tc["h"].dtype == torch.float32
    within_steps(tc["conv"], rc["conv"], 1, "conv state")
    f32_close(tc["h"], rc["h"], "h")
    init_t = trg.init_rglru_cache(tcfg, 2, device="cpu")
    init_r = rrg.init_rglru_cache(rcfg, 2)
    for k in init_r:
        assert init_t[k].dtype == (torch.bfloat16 if k == "conv"
                                   else torch.float32)
        np.testing.assert_array_equal(f32(init_t[k]), f32(init_r[k]))
    # three decode steps, each from the reference's state
    for step in range(3):
        rx, tx = both(rng.standard_normal((2, 1, tcfg.d_model)), "bf16")
        tstate = {"conv": torch.from_numpy(f32(rc["conv"])).bfloat16(),
                  "h": torch.from_numpy(f32(rc["h"]))}
        got, tc = trg.apply_rglru_block(tcfg, params, tx, cache=tstate)
        want, rc = rrg.apply_rglru_block(rcfg, rp, rx, cache=rc)
        within_steps(got, want, 2, f"decode {step}")
        np.testing.assert_array_equal(f32(tc["conv"]), f32(rc["conv"]))
        f32_close(tc["h"], rc["h"], f"decode {step} h")


# ------------------------------------------------------------------- xLSTM
def mlstm_inputs(b, s, h, dh, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, dh)) * dh ** -0.5).astype(np.float32)
    k = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    log_i = rng.standard_normal((b, s, h)).astype(np.float32)
    log_f = -np.logaddexp(0, -(rng.standard_normal((b, s, h)) + 3.0))
    return q, k, v, log_i, log_f.astype(np.float32)


def mlstm_state(b, h, dh, stub: bool):
    """init_mlstm_cache's state, or the train stub's zeros (m = 0)."""
    return {"c": np.zeros((b, h, dh, dh), np.float32),
            "n": np.zeros((b, h, dh), np.float32),
            "m": np.full((b, h), 0.0 if stub else -1e9, np.float32)}


@pytest.mark.parametrize("s,chunk", [(16, 16), (32, 8), (24, 8), (64, 256)])
@pytest.mark.parametrize("stub", [False, True])
def test_mlstm_chunkwise_matches_reference(s, chunk, stub):
    ins = mlstm_inputs(2, s, 4, 16, s + chunk)
    state = mlstm_state(2, 4, 16, stub)
    want_h, want_st = rxl._mlstm_chunkwise(
        *(jnp.asarray(a) for a in ins),
        {k: jnp.asarray(v) for k, v in state.items()}, chunk=chunk)
    got_h, got_st = txl._mlstm_chunkwise(
        *(torch.from_numpy(a) for a in ins),
        {k: torch.from_numpy(v) for k, v in state.items()}, chunk=chunk)
    f32_close(got_h, want_h, "h")
    states_close(got_st, want_st, "state")
    # the stub's m = 0 changes the output where exp(-m) bounds |den|
    if stub:
        other, _ = txl._mlstm_chunkwise(
            *(torch.from_numpy(a) for a in ins),
            {k: torch.from_numpy(v)
             for k, v in mlstm_state(2, 4, 16, False).items()}, chunk=chunk)
        assert not torch.equal(other, got_h)


def test_mlstm_chunkwise_rejects_ragged_chunks():
    ins = [torch.from_numpy(a) for a in mlstm_inputs(1, 24, 2, 8, 0)]
    state = {k: torch.from_numpy(v) for k, v in
             mlstm_state(1, 2, 8, False).items()}
    with pytest.raises(ValueError):
        txl._mlstm_chunkwise(*ins, state, chunk=16)


def test_mlstm_recurrent_step_matches_reference_and_chunkwise():
    """Decode steps against the reference, and 12 recurrent steps against
    the chunkwise form over the same 12 positions."""
    q, k, v, li, lf = mlstm_inputs(2, 12, 4, 16, 7)
    rst = {kk: jnp.asarray(vv) for kk, vv in mlstm_state(2, 4, 16,
                                                         False).items()}
    hs = []
    for t in range(12):
        args = [a[:, t] for a in (q, k, v, li, lf)]
        # each step from the reference's state
        tin = {kk: torch.from_numpy(f32(vv)) for kk, vv in rst.items()}
        rst, rh = rxl._mlstm_recurrent_step(rst, *(jnp.asarray(a)
                                                   for a in args))
        tst, th = txl._mlstm_recurrent_step(
            tin, *(torch.from_numpy(np.array(a)) for a in args))
        f32_close(th, rh, f"step {t} h")
        states_close(tst, rst, f"step {t}")
        hs.append(th)
    ch, _ = txl._mlstm_chunkwise(
        *(torch.from_numpy(a) for a in (q, k, v, li, lf)),
        {kk: torch.from_numpy(vv) for kk, vv in
         mlstm_state(2, 4, 16, False).items()})
    np.testing.assert_allclose(f32(torch.stack(hs, 1)), f32(ch), rtol=1e-4,
                               atol=1e-4 * float(ch.abs().max()))


@pytest.mark.parametrize("kind", ["ml", "sl"])
def test_xlstm_blocks_prefill_and_decode_match_reference(kind):
    tcfg, rcfg = cfgs("xlstm-1.3b")
    rng = np.random.default_rng(8)
    if kind == "ml":
        init, apply_t, apply_r = (txl.init_mlstm_block, txl.apply_mlstm_block,
                                  rxl.apply_mlstm_block)
        rcache, tcache = (rxl.init_mlstm_cache(rcfg, 2),
                          txl.init_mlstm_cache(tcfg, 2, "cpu"))
    else:
        init, apply_t, apply_r = (txl.init_slstm_block, txl.apply_slstm_block,
                                  rxl.apply_slstm_block)
        rcache, tcache = (rxl.init_slstm_cache(rcfg, 2),
                          txl.init_slstm_cache(tcfg, 2, "cpu"))
    states_close(tcache, rcache, "init")
    params = init(tcfg, rng, device="cpu")
    rp = ref_tree(numpy_tree(params))
    rx, tx = both(rng.standard_normal((2, 16, tcfg.d_model)), "bf16")
    got, tst = apply_t(tcfg, params, tx)
    want, rst = apply_r(rcfg, rp, rx)
    assert got.dtype == torch.bfloat16
    within_steps(got, want, 2, "prefill")
    states_close(tst, rst, "prefill")
    for step in range(3):
        rx, tx = both(rng.standard_normal((2, 1, tcfg.d_model)), "bf16")
        tin = {k: torch.from_numpy(f32(v)) for k, v in rst.items()}
        got, tst = apply_t(tcfg, params, tx, cache=tin)
        want, rst = apply_r(rcfg, rp, rx, cache=rst)
        within_steps(got, want, 2, f"decode {step}")
        states_close(tst, rst, f"decode {step}")


def test_slstm_step_matches_reference():
    tcfg, rcfg = cfgs("xlstm-1.3b")
    params = txl.init_slstm_block(tcfg, np.random.default_rng(2),
                                  device="cpu")
    rp = ref_tree(numpy_tree(params))
    rng = np.random.default_rng(9)
    h, dh = tcfg.n_heads, tcfg.d_model // tcfg.n_heads
    st = {k: rng.standard_normal((2, h, dh)).astype(np.float32)
          for k in ("c", "n", "m", "h")}
    st["n"] = np.abs(st["n"])
    zx = rng.standard_normal((2, 4, h, dh)).astype(np.float32)
    want = rxl._slstm_step(rp, {k: jnp.asarray(v) for k, v in st.items()},
                           jnp.asarray(zx))
    got = txl._slstm_step(params["r_zifo"], params["b_zifo"],
                          {k: torch.from_numpy(v) for k, v in st.items()},
                          torch.from_numpy(zx))
    states_close(got, want)


# -------------------------------------------------- cross-attention, encoder
def test_cross_attention_sublayer_matches_reference():
    """Prefill projects the encoder's output into ck/cv (bf16, equal to
    the reference's), decode reads them; no rope, not causal."""
    tcfg, rcfg = cfgs("whisper-medium")
    gen = np.random.default_rng(3)
    p = {"cross_norm": tlayers.init_norm(tcfg, tcfg.d_model, "cpu"),
         "cross": tattn.init_attention(tcfg, gen, cross=True, device="cpu")}
    p["cross_norm"]["scale"] += torch.from_numpy(
        gen.standard_normal(tcfg.d_model).astype(np.float32) * 0.1)
    assert sorted(p["cross"]) == ["wk", "wo", "wq", "wv"]
    rp = ref_tree(numpy_tree(p))
    rng = np.random.default_rng(4)
    b, s, t = 2, 6, tcfg.encoder_seq
    rx, tx = both(rng.standard_normal((b, s, tcfg.d_model)), "bf16")
    re, te = both(rng.standard_normal((b, t, tcfg.d_model)), "bf16")
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    cache_r = rtfm.init_block_cache(rcfg, "ga", b, 8, decoder=True)
    cache_t = ttfm.init_block_cache(tcfg, "ga", b, 8, decoder=True,
                                    device="cpu")
    assert cache_t["ck"].shape == (b, t, tcfg.n_kv_heads, tcfg.head_dim)
    for mode in ("train", "prefill"):
        rctx = rtfm.Ctx(mode=mode, cos=None, sin=None, q_pos=jnp.asarray(pos),
                        pos=None, max_len=8, enc_out=re)
        tctx = ttfm.Ctx(mode=mode, cos=None, sin=None,
                        q_pos=torch.from_numpy(pos), pos=None, max_len=8,
                        enc_out=te)
        want, rc = rtfm._cross_attention_sublayer(
            rcfg, rp, rx, rctx, cache_r if mode == "prefill" else None)
        got, tc = ttfm._cross_attention_sublayer(
            tcfg, p, tx, tctx, cache_t if mode == "prefill" else None)
        within_steps(got, want, 2, mode)
    for key in ("ck", "cv"):
        assert tc[key].dtype == torch.bfloat16
        within_steps(tc[key], rc[key], 1, key)
    rx, tx = both(rng.standard_normal((b, 1, tcfg.d_model)), "bf16")
    rctx = rtfm.Ctx(mode="decode", cos=None, sin=None,
                    q_pos=jnp.full((b, 1), s, jnp.int32), pos=s, max_len=8)
    tctx = ttfm.Ctx(mode="decode", cos=None, sin=None,
                    q_pos=torch.full((b, 1), s, dtype=torch.int32), pos=s,
                    max_len=8)
    tc = {k: torch.from_numpy(f32(v)).bfloat16() for k, v in rc.items()}
    want, _ = rtfm._cross_attention_sublayer(rcfg, rp, rx, rctx, rc)
    got, _ = ttfm._cross_attention_sublayer(tcfg, p, tx, tctx, tc)
    within_steps(got, want, 2, "decode")


def test_encoder_matches_reference():
    tcfg, rcfg = cfgs("whisper-medium")
    tree = tmodels.numpy_params(tcfg, 5)
    assert sorted(tree["encoder"]) == ["final_norm", "stack"]
    rng = np.random.default_rng(6)
    emb = (rng.standard_normal((2, tcfg.encoder_seq, tcfg.d_model)) * 0.5
           ).astype(np.float32)
    got = TModel(tcfg)._encode(port_tree(tree),
                               {"enc_embeds": torch.from_numpy(emb)})
    want = RModel(rcfg)._encode(ref_tree(tree), {"enc_embeds": jnp.asarray(emb)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=LOGIT_ATOL)
    assert TModel(tconfigs.get_config("qwen3-4b").reduced())._encode(
        {}, {}) is None
    enc = TModel(tcfg)._encoder_cfg()
    renc = RModel(rcfg)._encoder_cfg()
    assert dataclasses.asdict(enc) == dataclasses.asdict(renc)


# ------------------------------------------------------------ the train stub
def test_train_stub_and_remainder_states_match_reference(monkeypatch):
    """xlstm at 9 layers: one full cycle (7 mLSTM + 1 sLSTM) whose train
    run starts from the zero stub (m = 0) and one mLSTM remainder that
    starts from init_mlstm_cache (m = -1e9), as in the reference; the
    hidden states agree."""
    tcfg, rcfg = cfgs("xlstm-1.3b", n_layers=9)
    assert tcfg.cycles() == (1, 1)
    tree = tmodels.numpy_params(tcfg, 0)
    tok = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 32)
                                            ).astype(np.int32)
    stubs, inits = [], []
    real_stub, real_init = ttfm._train_cache_stub, txl.init_mlstm_cache
    monkeypatch.setattr(ttfm, "_train_cache_stub", lambda cfg, kind, b, d: (
        stubs.append(kind) or real_stub(cfg, kind, b, d)))
    monkeypatch.setattr(txl, "init_mlstm_cache", lambda cfg, b, d=None: (
        inits.append(b) or real_init(cfg, b, d)))
    h_t, _, _ = TModel(tcfg).forward(port_tree(tree),
                                     {"tokens": torch.from_numpy(tok)},
                                     "train")
    assert stubs == list(tcfg.layer_pattern)     # every block of the cycle
    assert inits == [2]                          # the remainder alone
    h_r, _, _ = RModel(rcfg).forward(ref_tree(tree),
                                     {"tokens": jnp.asarray(tok)}, "train",
                                     remat=False)
    np.testing.assert_allclose(f32(h_t), f32(h_r), rtol=0, atol=LOGIT_ATOL)
    stub = real_stub(tcfg, "ml", 2, "cpu")
    assert float(stub["m"].abs().max()) == 0.0
    assert float(real_stub(tcfg, "sl", 2, "cpu")["m"].abs().max()) == 0.0
    assert real_stub(tcfg, "ga", 2, "cpu") is None


# ----------------------------------------------------------------- frontend
def test_frontend_helpers_match_reference():
    for b, s, img, grid in ((2, 12, 4, (2, 2)), (1, 9, 0, (0, 0)),
                            (3, 20, 6, (2, 3)), (2, 8, 8, (4, 2))):
        got = tfront.mrope_positions(b, s, image_tokens=img, grid_hw=grid)
        want = rfront.mrope_positions(b, s, image_tokens=img, grid_hw=grid)
        assert got.dtype == want.dtype and got.flags.writeable
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tfront.mrope_positions(1, 8, image_tokens=4, grid_hw=(3, 2))
    for arch in ("whisper-medium", "qwen2-vl-72b"):
        cfg, rcfg = tconfigs.get_config(arch), rconfigs.get_config(arch)
        assert tfront.audio_frame_embeddings_shape(cfg, 3) == \
            rfront.audio_frame_embeddings_shape(rcfg, 3)
        assert tfront.vision_patch_embeddings_shape(cfg, 2, 77) == \
            rfront.vision_patch_embeddings_shape(rcfg, 2, 77)


def test_synth_embeddings_draws_from_its_generator():
    a = tfront.synth_embeddings(np.random.default_rng(0), (2, 5, 8))
    b = tfront.synth_embeddings(np.random.default_rng(0), (2, 5, 8))
    c = tfront.synth_embeddings(torch.Generator().manual_seed(0), (2, 5, 8),
                                dtype=torch.float32)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert c.dtype == torch.float32 and c.shape == (2, 5, 8)
    want = (np.random.default_rng(0).standard_normal((2, 5, 8), np.float32))
    np.testing.assert_array_equal(
        f32(a), f32(jnp.asarray(want, jnp.bfloat16) * 0.02))
    ref = rfront.synth_embeddings(jax.random.PRNGKey(0), (64, 64))
    assert ref.dtype == jnp.bfloat16
    for x in (f32(ref), f32(tfront.synth_embeddings(
            np.random.default_rng(1), (64, 64)))):
        assert 0.015 < x.std() < 0.025
