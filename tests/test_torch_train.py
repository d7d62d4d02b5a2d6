"""Port parity — the training path: the flash backward, ``Model.loss``,
the train step, the loop under the supervisor, and training states that
cross between the packages.

repro_torch.{models,launch.steps,train.loop} against repro.{models,
launch.steps,train.loop} on the CPU, on weights carried across from one
numpy tree (`repro_torch.models.numpy_params`, the states through
`repro_torch.train.state_from_numpy` / `numpy_state`).  Tolerances:

* flash, fp32: the reference's own (tests/test_flash.py) — 2e-5 on the
  output, 3e-4 on the gradients of q, k and v; bf16 inputs 3e-2;
* the loss (bf16 weights and activations): LOSS_ATOL = 1e-2 absolute —
  XLA on the CPU evaluates bf16 chains in fp32 where torch rounds after
  each op, so the logits sit a few bf16 steps apart;
* each gradient leaf: relative L2 error GRAD_RTOL = 3e-2, for the same
  reason;
* microbatched (n = 2) against unsplit on the port's side: the loss to
  fp32 rounding (MICRO_LOSS_RTOL); each gradient leaf to MICRO_GRAD_RTOL
  relative L2, four bf16 steps (2^-6), not fp32 rounding: the weights
  are bf16 at use, so every microbatch's weight gradients leave a bf16
  product rounded to bf16 before the fp32 sum, and the rounding of the
  bf16 cotangents changes with the rows summed (measured: 3.89e-3 on the
  worst leaf, 0 on the loss);
* everything that goes through the coded checkpoint path — restored
  states, repair events, step directories — exactly;
* ``remat=True`` against ``remat=False``: bit-identical.
"""
import dataclasses
import json
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import no_cuda  # noqa: F401 (fixture)

import repro.checkpoint.msr_checkpoint as rck
import repro_torch.checkpoint.msr_checkpoint as tck
from repro import configs as rconfigs
from repro.core.circulant import CodeSpec as RSpec
from repro.models import Model as RModel
from repro.models import attention as rattn
from repro.models.flash import flash_attention as rflash
from repro.optim import adamw as radamw
from repro.train import fault_tolerance as rft
from repro.train import loop as rloop
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.core import placement as tplace
from repro_torch.core.circulant import CodeSpec as TSpec
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.models import Model as TModel
from repro_torch.models import attention as tattn
from repro_torch.models.flash import FlashAttention
from repro_torch.models.flash import flash_attention as tflash
from repro_torch.optim import adamw as tadamw
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import loop as tloop

FLASH_FWD_TOL = 2e-5
FLASH_GRAD_TOL = 3e-4
FLASH_BF16_TOL = 3e-2
LOSS_ATOL = 1e-2
GRAD_RTOL = 3e-2
MICRO_LOSS_RTOL = 1e-6
MICRO_GRAD_RTOL = 2.0 ** -6


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_l2(got, want) -> float:
    got, want = f32(got), f32(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------------ flash
FLASH_CASES = {
    # name: (sq, sk, causal, window, kv_chunk, dtype)
    "causal_kv16": (64, 64, True, None, 16, "f32"),
    "causal_kv64": (64, 64, True, None, 64, "f32"),
    "full_kv16": (64, 64, False, None, 16, "f32"),
    "window16_kv16": (64, 64, True, 16, 16, "f32"),
    "window16_kv64": (64, 64, True, 16, 64, "f32"),
    "window24_sq48": (48, 48, True, 24, 16, "f32"),
    "one_query": (1, 96, True, None, 32, "f32"),
    "masked_window_chunk": (32, 128, True, 8, 32, "f32"),
    "bf16": (64, 64, True, None, 32, "bf16"),
}


def flash_inputs(sq, sk, dtype, b=2, h=4, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = [(rng.standard_normal((b, s, h, hd)) * 0.5).astype(np.float32)
               for s in (sq, sk, sk)]
    qp = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32)[None],
                         (b, sq)).copy()
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32)[None], (b, sk)).copy()
    if dtype == "bf16":
        j = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
        t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    else:
        j = [jnp.asarray(x) for x in (q, k, v)]
        t = [torch.from_numpy(x) for x in (q, k, v)]
    return j, t, qp, kp


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_forward_and_grads_match(case):
    """The port's flash forward and its backward (d q, k, v of sum(o^2))
    against the reference's ``flash_attention`` and ``jax.grad`` of it:
    causal, sliding windows, both chunk sizes, one query, a KV chunk
    wholly outside the window, bf16 inputs."""
    sq, sk, causal, window, kv_chunk, dtype = FLASH_CASES[case]
    (jq, jk, jv), (tq, tk, tv), qp, kp = flash_inputs(sq, sk, dtype)
    fwd_tol = grad_tol = FLASH_BF16_TOL if dtype == "bf16" else None
    fwd_tol = fwd_tol or FLASH_FWD_TOL
    grad_tol = grad_tol or FLASH_GRAD_TOL

    def rloss(q, k, v):
        o = rflash(q, k, v, jnp.asarray(qp), jnp.asarray(kp), causal,
                   window, kv_chunk)
        return jnp.sum(o.astype(jnp.float32) ** 2), o

    (_, want), gw = jax.value_and_grad(rloss, argnums=(0, 1, 2),
                                       has_aux=True)(jq, jk, jv)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    n_fwd, n_bwd = FlashAttention.forward_calls, FlashAttention.backward_calls
    got = tflash(*leaves, torch.from_numpy(qp), torch.from_numpy(kp),
                 causal, window, kv_chunk)
    (got.float() ** 2).sum().backward()
    assert (FlashAttention.forward_calls - n_fwd,
            FlashAttention.backward_calls - n_bwd) == (1, 1)
    assert got.dtype == leaves[0].dtype
    np.testing.assert_allclose(f32(got), f32(want), rtol=fwd_tol,
                               atol=fwd_tol)
    for x, g, name in zip(leaves, gw, "qkv"):
        assert x.grad.dtype == x.dtype
        np.testing.assert_allclose(f32(x.grad), f32(g), rtol=grad_tol,
                                   atol=grad_tol, err_msg=f"d{name}")


def test_flash_serving_calls_unchanged():
    """Under inference_mode (the serving prefill) the flash call returns
    the same output and records nothing for a backward."""
    _, (q, k, v), qp, kp = flash_inputs(32, 32, "f32")
    with torch.inference_mode():
        o = tflash(q, k, v, torch.from_numpy(qp), torch.from_numpy(kp))
    assert not o.requires_grad
    assert torch.equal(o, tflash(q, k, v, torch.from_numpy(qp),
                                 torch.from_numpy(kp)).detach())


# ---------------------------------------------------- model, loss, steps
def tiny_cfgs(**over):
    """A reduced qwen3-4b: 2 layers, d 64, 4 query / 2 KV heads of 16,
    d_ff 128, vocab 512, loss_chunk 16 (dividing the sequences used)."""
    kw = dict(n_layers=2, loss_chunk=16, **over)
    return (tconfigs.get_config("qwen3-4b").reduced(**kw),
            rconfigs.get_config("qwen3-4b").reduced(**kw))


def carried(cfg, seed=0):
    tree = tmodels.numpy_params(cfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tmodels.params_from_numpy(tree, device="cpu"))


def batch(cfg, b=4, s=32, step=0, seed=1):
    np_batch = tpipe.batch_at(tpipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed),
        step)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def ref_grads_of(model, params, batch_):
    """The reference train step's gradient function
    (src/repro/launch/steps.py: weights >= 2-D cast to bf16 at use)."""
    def loss_fn(p):
        pc = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16)
            if x.dtype == jnp.float32 and x.ndim >= 2 else x, p)
        return model.loss(pc, batch_)
    (loss, metrics), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return loss, metrics, g


def flash_on(monkeypatch, on: bool):
    """Lower both packages' flash threshold so the tiny model's attention
    takes the flash path (forward and backward)."""
    if on:
        for mod in (rattn, tattn):
            monkeypatch.setattr(mod, "FLASH_MIN_ELEMS", 1)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_grads_match_reference(softcap, flash, monkeypatch):
    """``Model.loss`` on fp32 weights, and the train step's grads (bf16
    weights at use) leaf by leaf, against the reference."""
    flash_on(monkeypatch, flash)
    tcfg, rcfg = tiny_cfgs(logit_softcap=softcap)
    rp, tp = carried(tcfg)
    rb, tb = batch(tcfg)
    tm, rm = TModel(tcfg), RModel(rcfg)
    lt, mt = tm.loss(tp, tb)
    lr_, mr = rm.loss(rp, rb)
    assert abs(float(lt) - float(lr_)) <= LOSS_ATOL
    assert abs(float(mt["xent"]) - float(mr["xent"])) <= LOSS_ATOL
    assert float(mt["aux"]) == float(mr["aux"]) == 0.0

    n_fwd, n_bwd = FlashAttention.forward_calls, FlashAttention.backward_calls
    lt, mt, gt = tsteps.grads_of(tm, tp, tb)
    calls = (FlashAttention.forward_calls - n_fwd,
             FlashAttention.backward_calls - n_bwd)
    # remat: each layer's forward runs again in the backward
    assert calls == ((2 * tcfg.n_layers, tcfg.n_layers) if flash else (0, 0))
    lr_, mr, gr = ref_grads_of(rm, rp, rb)
    assert abs(float(lt) - float(lr_)) <= LOSS_ATOL
    lt_leaves, tdef = tplace.tree_flatten(gt)
    assert str(tdef) == str(jax.tree_util.tree_structure(gr))
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(gr)[0], lt_leaves):
        assert got.dtype == torch.float32
        err = rel_l2(got, want)
        assert err <= GRAD_RTOL, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("flash", [False, True])
def test_remat_flag_bit_identical(flash, monkeypatch):
    flash_on(monkeypatch, flash)
    tcfg, _ = tiny_cfgs()
    _, tp = carried(tcfg, seed=2)
    _, tb = batch(tcfg)
    model = TModel(tcfg)
    outs = []
    for remat in (True, False):
        leaves, tdef = tplace.tree_flatten(tp)
        leaves = [x.clone().requires_grad_(True) for x in leaves]
        loss, _ = model.loss(tdef.unflatten(leaves), tb, remat=remat)
        outs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l1, g1), (l2, g2) = outs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_microbatched_grads_match_unsplit():
    """Two microbatches against the whole batch, on the port's side."""
    tcfg, _ = tiny_cfgs()
    _, tp = carried(tcfg, seed=3)
    _, tb = batch(tcfg, b=4)
    model = TModel(tcfg)
    l1, m1, g1 = tsteps.accumulate_grads(model, tp, tb, 1)
    l2, m2, g2 = tsteps.accumulate_grads(model, tp, tb, 2)
    assert abs(float(l1) - float(l2)) <= MICRO_LOSS_RTOL * abs(float(l1))
    assert set(m2) == {"xent", "aux"}
    for a, b in zip(tplace.tree_flatten(g2)[0], tplace.tree_flatten(g1)[0]):
        assert a.dtype == torch.float32
        assert rel_l2(a, b) <= MICRO_GRAD_RTOL
    with pytest.raises(ValueError, match="microbatches"):
        tsteps.accumulate_grads(model, tp, tb, 3)


def test_mrope_positions_split_on_their_batch_axis():
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    parts = tsteps._split_micro({"positions": pos,
                                 "tokens": torch.zeros(4, 5)}, 2)
    assert [p["positions"].shape for p in parts] == [(3, 2, 5)] * 2
    assert torch.equal(torch.cat([p["positions"] for p in parts], 1), pos)
    assert [p["tokens"].shape for p in parts] == [(2, 5)] * 2


def test_pick_microbatches_and_count_params_match():
    from repro.launch import steps as rsteps
    for shape in tconfigs.SHAPES.values():
        for shards in (1, 2, 8, 64, 512):
            assert tsteps.pick_microbatches(shape, shards) == \
                rsteps.pick_microbatches(
                    rconfigs.SHAPES[shape.name], shards)
    tcfg, rcfg = tiny_cfgs()
    assert tsteps.count_params(TModel(tcfg).init(torch.Generator(),
                                                 device="meta")) == \
        rsteps.count_params(jax.eval_shape(
            lambda: RModel(rcfg).init(jax.random.PRNGKey(0))))


# ------------------------------------------------------------------ loop
def ref_state(state_np):
    """The reference's training state from a numpy one."""
    mu, nu, step = state_np["opt"]
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return {"params": to_j(state_np["params"]),
            "opt": radamw.OptState(mu=to_j(mu), nu=to_j(nu),
                                   step=jnp.asarray(step))}


def carried_state(cfg, opt_cfg, seed=0):
    """One training state as numpy: params from numpy_params, fresh
    moments of ``opt_cfg.moment_dtype``, step 0."""
    params = tmodels.params_from_numpy(tmodels.numpy_params(cfg, seed),
                                       device="cpu")
    return tloop.numpy_state({"params": params,
                              "opt": tadamw.init(params, opt_cfg)})


def state_leaves_equal(a, b) -> bool:
    la, ta = tplace.tree_flatten(a)
    lb, tb = tplace.tree_flatten(b)
    return ta == tb and all(x.dtype == y.dtype and torch.equal(x, y)
                            for x, y in zip(la, lb))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_loop_matches_reference(n_micro):
    tcfg, rcfg = tiny_cfgs()
    tc = dict(n_steps=4, global_batch=4, seq_len=32, n_microbatches=n_micro,
              log_every=1, seed=5)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=4)
    st_np = carried_state(tcfg, tadamw.AdamWConfig(**opt))
    t_state, t_hist = tloop.train(
        tcfg, tloop.TrainConfig(**tc), tadamw.AdamWConfig(**opt),
        state=tloop.state_from_numpy(st_np, "cpu"), log=lambda *_: None,
        device="cpu")
    r_state, r_hist = rloop.train(
        rcfg, rloop.TrainConfig(**tc), radamw.AdamWConfig(**opt),
        state=ref_state(st_np), log=lambda *_: None)
    assert [sorted(h) for h in t_hist] == [sorted(h) for h in r_hist]
    assert [h["step"] for h in t_hist] == [h["step"] for h in r_hist] \
        == [0, 1, 2, 3]
    for a, b in zip(t_hist, r_hist):
        assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL, (a, b)
    assert int(t_state["opt"].step) == int(r_state["opt"].step) == 4


def tiny_ft_cfgs():
    """tests/test_fault_tolerance.py's model."""
    kw = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
              d_ff=64, vocab_size=128, loss_chunk=16)
    return (tconfigs.get_config("qwen3-4b").reduced(**kw),
            rconfigs.get_config("qwen3-4b").reduced(**kw))


def test_supervised_crash_matches_reference_and_is_bit_exact(tmp_path):
    """The twin of tests/test_fault_tolerance.py's crash run: crash at step
    7, repair from the step-5 checkpoint.  Repair events equal the
    reference's (they come from the coded path), the step and checkpoint
    events are the same sequence, and the port's final state is
    bit-exact with its own uninterrupted run."""
    tcfg, rcfg = tiny_ft_cfgs()
    tc = dict(n_steps=12, global_batch=4, seq_len=16, ckpt_every=5, seed=3)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=12)
    st_np = carried_state(tcfg, tadamw.AdamWConfig(**opt))
    runs = {}
    for name, inj in (("crash", True), ("clean", False)):
        ck = tck.MSRCheckpointer(tmp_path / f"port_{name}", TSpec.make(3, 257),
                                 device="cpu")
        runs[name] = tloop.train(
            tcfg, tloop.TrainConfig(**tc), tadamw.AdamWConfig(**opt),
            checkpointer=ck, state=tloop.state_from_numpy(st_np, "cpu"),
            injector=tft.FailureInjector(6, schedule=[
                tft.FailureEvent(step=7, node=2)]) if inj else None,
            device="cpu")
    r_state, r_log = rloop.train(
        rcfg, rloop.TrainConfig(**tc), radamw.AdamWConfig(**opt),
        checkpointer=rck.MSRCheckpointer(tmp_path / "ref", RSpec.make(3, 257)),
        injector=rft.FailureInjector(6, schedule=[
            rft.FailureEvent(step=7, node=2)]),
        state=ref_state(st_np))
    t_log = runs["crash"][1]
    keys = ("step", "event", "failed", "ckpt_step", "restore_path")
    repairs = [e for e in t_log if e["event"] == "repair"]
    r_repairs = [e for e in r_log if e["event"] == "repair"]
    assert [{k: e[k] for k in keys} for e in repairs] == \
        [{k: e[k] for k in keys} for e in r_repairs]
    assert repairs[0]["ckpt_step"] == 5
    # repair_bytes counts the helper files read, and a redundancy file
    # lists the positions of symbol 256 (8 B each), so it follows the
    # state's values: exact against the reference's checkpointer repairing
    # the same node from the port's own files, and within 1% of the
    # reference run's (its state after 5 steps is within tolerance only)
    ref_reads = rck.MSRCheckpointer(tmp_path / "port_crash",
                                    RSpec.make(3, 257)).repair_node(5, 2)
    assert repairs[0]["repair_bytes"] == ref_reads > 0
    assert abs(repairs[0]["repair_bytes"] - r_repairs[0]["repair_bytes"]) \
        <= 0.01 * r_repairs[0]["repair_bytes"]
    assert [(e["step"], e["event"]) for e in t_log] == \
        [(e["step"], e["event"]) for e in r_log]
    for a, b in zip(t_log, r_log):
        if a["event"] == "step":
            assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL
    assert state_leaves_equal(runs["crash"][0], runs["clean"][0])


def test_train_defaults_to_the_card(no_cuda):
    tcfg, _ = tiny_cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.train(tcfg, tloop.TrainConfig(n_steps=1), log=lambda *_: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.init_state(TModel(tcfg), tadamw.AdamWConfig())


def test_init_state_draws_from_a_torch_generator():
    tcfg, _ = tiny_cfgs()
    a = tloop.init_state(TModel(tcfg), tadamw.AdamWConfig(), 7, "cpu")
    b = tloop.init_state(TModel(tcfg), tadamw.AdamWConfig(), 7, "cpu")
    assert state_leaves_equal(a, b)
    assert int(a["opt"].step) == 0 and a["opt"].step.dtype == torch.int32


# --------------------------------------------- states across the packages
def dir_state(root: Path) -> list:
    """Every file under ``root`` with its content (an .npz by members)."""
    out = []
    for f in sorted(root.rglob("*")):
        if f.is_dir():
            out.append((str(f.relative_to(root)), "dir"))
        elif f.suffix == ".npz":
            with zipfile.ZipFile(f) as z:
                out.append((str(f.relative_to(root)),
                            [(m, z.read(m)) for m in sorted(z.namelist())]))
        else:
            out.append((str(f.relative_to(root)), f.read_bytes()))
    return out


def np_equal(a, b) -> bool:
    """Every leaf of two JAX/numpy trees equal in dtype, shape and bytes."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        (x.dtype, x.shape, x.tobytes()) == (y.dtype, y.shape, y.tobytes())
        for x, y in zip(map(np.asarray, la), map(np.asarray, lb)))


@pytest.fixture(scope="module")
def mid_state():
    """A state three steps into a port run (params + OptState), as numpy."""
    tcfg, _ = tiny_ft_cfgs()
    state, _ = tloop.train(tcfg, tloop.TrainConfig(
        n_steps=3, global_batch=2, seq_len=16, seed=1), log=lambda *_: None,
        state=tloop.state_from_numpy(carried_state(
            tcfg, tadamw.AdamWConfig()), "cpu"), device="cpu")
    assert int(state["opt"].step) == 3
    return tloop.numpy_state(state)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_state_round_trip_bit_equal(moment_dtype):
    """reference -> port -> reference, every leaf bit-equal, and the
    port's tree string equal to the reference's."""
    tcfg, rcfg = tiny_ft_cfgs()
    rparams = RModel(rcfg).init(jax.random.PRNGKey(0))
    rstate = {"params": rparams,
              "opt": radamw.init(rparams, radamw.AdamWConfig(
                  moment_dtype=moment_dtype))}
    rstate = jax.device_get(rstate)
    t = tloop.state_from_numpy(rstate, "cpu")
    assert isinstance(t["opt"], tadamw.OptState)
    assert str(tplace.tree_flatten(t)[1]) == \
        str(jax.tree_util.tree_structure(rstate))
    back = ref_state(tloop.numpy_state(t))
    assert np_equal(back, rstate)
    assert str(jax.tree_util.tree_structure(back)) == \
        str(jax.tree_util.tree_structure(rstate))


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("failed", [(), (2,), (1, 4)])
def test_mid_training_state_restores_in_the_other_package(tmp_path, writer,
                                                          failed,
                                                          mid_state):
    """A state saved by one package restored by the other, systematic,
    with one node lost (regenerate) and with two (reconstruct): bit-exact,
    the port's OptState rebuilt as the port's."""
    port = tck.MSRCheckpointer(tmp_path, TSpec.make(3, 257), device="cpu")
    ref = rck.MSRCheckpointer(tmp_path, RSpec.make(3, 257))
    t_state = tloop.state_from_numpy(mid_state, "cpu")
    r_state = ref_state(mid_state)
    (port if writer == "port" else ref).save(
        3, t_state if writer == "port" else r_state)
    for f in failed:
        for path in port._node_files(3, f):
            path.unlink()
    if writer == "port":
        got, rep = ref.restore(r_state, 3, failed_nodes=failed)
        assert np_equal(got, r_state)
    else:
        got, rep = port.restore(t_state, 3, failed_nodes=failed)
        assert isinstance(got["opt"], tadamw.OptState)
        assert state_leaves_equal(got, t_state)
    assert rep.path == {0: "systematic", 1: "regenerate"}.get(
        len(failed), "reconstruct")


def test_mid_training_step_directories_byte_identical(tmp_path, mid_state):
    tck.MSRCheckpointer(tmp_path / "port", TSpec.make(3, 257),
                        device="cpu").save(3, tloop.state_from_numpy(
                            mid_state, "cpu"))
    rck.MSRCheckpointer(tmp_path / "ref", RSpec.make(3, 257)).save(
        3, ref_state(mid_state))
    got, want = dir_state(tmp_path / "port"), dir_state(tmp_path / "ref")
    assert len(got) == 1 + 1 + 2 * 6 and got == want
    m = json.loads((tmp_path / "port" / "step_000003" / "manifest.json")
                   .read_text())
    assert "namedtuple[OptState]" in json.loads(m["tree"])["treedef_repr"]


# ----------------------------------------------------------- the example
def test_tiny_lm_drill_on_the_cpu(tmp_path):
    """repro_torch.train.tiny_lm end to end at a short length: the loss
    falls, one repair event, the final state bit-exact with an
    uninterrupted run."""
    from repro_torch.train import tiny_lm
    args = tiny_lm.parser().parse_args([
        "--preset", "tiny", "--steps", "18", "--crash-step", "11",
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "a")])
    out = tiny_lm.run(args, log=lambda *_: None)
    assert [r["ckpt_step"] for r in out["repairs"]] == [10]
    assert out["repairs"][0]["restore_path"] == "systematic"
    assert out["losses"][-1] < out["losses"][0]
    assert tiny_lm.PRESETS == {
        name: dict(p) for name, p in _reference_presets().items()}


def _reference_presets():
    """The reference example's PRESETS (examples/train_tiny_lm.py)."""
    import importlib.util
    path = (Path(__file__).resolve().parents[1] / "examples" /
            "train_tiny_lm.py")
    spec = importlib.util.spec_from_file_location("_ref_train_tiny_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PRESETS
