"""Port parity — the synthetic data pipeline, AdamW and int8 error-feedback
compression.

repro_torch.data.pipeline / repro_torch.optim against repro.data.pipeline /
repro.optim on the CPU, the same seeded numpy inputs through both:

* batches are identical arrays (tolerance zero);
* int8 codes are identical; scales, carried errors, learning rates, norms,
  parameters and moments agree to float32 rounding — XLA on the CPU may
  fuse a multiply-add where torch rounds twice, a step of one fp32 ulp
  (2^-23 relative), so RTOL = 1e-6 (about eight ulps).  A moment that
  cancels to near zero keeps the absolute error of its terms, so tensors
  are also allowed RTOL times their largest magnitude (measured: 1.86e-9
  on a moment of 3.5e-4 in a tensor of 0.04);
* bfloat16 moments to one bf16 step (2^-8 relative): the fp32 values
  they round from may sit one ulp apart across a rounding boundary;
* ``OptState.step`` is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as rpipe
from repro.optim import adamw as radamw
from repro.optim import compression as rcomp
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp

RTOL = 1e-6
ATOL = 1e-9
BF16_STEP = 2.0 ** -8


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    want = f32(want)
    atol = max(atol, rtol * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(f32(got), want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,n_hosts,host_id", [
    (0, 0, 1, 0), (7, 5, 1, 0), (3, 1234, 2, 1), (1, 9, 4, 0), (1, 9, 4, 3),
    (11, 0, 8, 5)])
def test_batch_at_identical(seed, step, n_hosts, host_id):
    kw = dict(vocab_size=97, seq_len=33, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host_id)
    got = tpipe.batch_at(tpipe.DataConfig(**kw), step)
    want = rpipe.batch_at(rpipe.DataConfig(**kw), step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_iterate_and_local_batch():
    kw = dict(vocab_size=512, seq_len=16, global_batch=4, seed=2)
    it_t = tpipe.iterate(tpipe.DataConfig(**kw), start_step=3)
    it_r = rpipe.iterate(rpipe.DataConfig(**kw), start_step=3)
    for _ in range(3):
        a, b = next(it_t), next(it_r)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert tpipe.DataConfig(**kw, n_hosts=2).local_batch == 2
    with pytest.raises(ValueError):
        tpipe.DataConfig(**kw, n_hosts=3).local_batch


# ------------------------------------------------------------ compression
def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((13, 7)) * 1e-3).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "z": np.zeros(4, np.float32)}


def test_quantize_identical():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal(257).astype(np.float32) * 3,
              np.linspace(-1, 1, 255, dtype=np.float32),
              np.zeros(8, np.float32)):
        qt, st = tcomp.quantize(torch.from_numpy(x))
        qr, sr = rcomp.quantize(jnp.asarray(x))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
        close(st, sr)
        close(tcomp.dequantize(qt, st), rcomp.dequantize(qr, sr))


def test_ef_compress_and_trees_over_steps():
    """Five steps of error feedback on a tree: codes equal at every step,
    scales and carried errors within fp32 rounding."""
    tree = _grad_tree(0)
    err_t = tcomp.init_error_state({k: torch.from_numpy(v)
                                    for k, v in tree.items()})
    err_r = rcomp.init_error_state(tree)
    for step in range(5):
        g = _grad_tree(step + 1)
        qt, st, err_t = tcomp.compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, err_t)
        qr, sr, err_r = rcomp.compress_tree(
            {k: jnp.asarray(v) for k, v in g.items()}, err_r)
        for k in g:
            np.testing.assert_array_equal(qt[k].numpy(), np.asarray(qr[k]),
                                          err_msg=f"{k} at step {step}")
            close(st[k], sr[k], err_msg=k)
            close(err_t[k], err_r[k], atol=float(sr[k]) * 1e-6, err_msg=k)
        dt = tcomp.decompress_tree(qt, st)
        dr = rcomp.decompress_tree(qr, sr)
        for k in g:
            close(dt[k], dr[k])
    q, s, e = tcomp.ef_compress(torch.ones(3), torch.zeros(3))
    assert q.tolist() == [127] * 3 and e.abs().max() <= s


def test_int8_ring_mean_waits_for_the_multi_device_layer():
    """The multi-device layer is here: int8_ring_mean on a mesh of 2
    (["cpu"] * 2) returns the mean in every row, and a leading dim that
    is not the axis size raises."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(devices=["cpu"] * 2)
    x = torch.tensor([[1.0, -2.0, 3.0], [3.0, 2.0, -1.0]])
    got = tcomp.int8_ring_mean(x, mesh, "data")
    assert got.shape == x.shape
    assert torch.equal(got[0], got[1])
    scale = float(x.abs().max()) / 127
    assert float((got[0] - x.mean(0)).abs().max()) <= 10 * scale
    with pytest.raises(ValueError, match="leading dim"):
        tcomp.int8_ring_mean(torch.zeros(3, 4), mesh, "data")


# ------------------------------------------------------------------ AdamW
def test_config_fields_match():
    import dataclasses
    assert dataclasses.asdict(tadamw.AdamWConfig()) == \
        dataclasses.asdict(radamw.AdamWConfig())
    assert tadamw.OptState._fields == radamw.OptState._fields


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (3, 20), (0, 1)])
def test_schedule_matches(warmup, total):
    cfg_t = tadamw.AdamWConfig(lr=1e-3, warmup_steps=warmup,
                               total_steps=total)
    cfg_r = radamw.AdamWConfig(lr=1e-3, warmup_steps=warmup,
                               total_steps=total)
    for step in sorted({0, 1, 2, warmup, warmup + 1, total // 2, total,
                        total + 5}):
        close(tadamw.schedule(cfg_t, torch.tensor(step, dtype=torch.int32)),
              radamw.schedule(cfg_r, jnp.asarray(step, jnp.int32)),
              err_msg=f"step {step}")


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"stack": {"cycles": ({"w": rng.standard_normal((2, 6, 5)).astype(
                np.float32)},)},
            "embed": rng.standard_normal((11, 6)).astype(np.float32),
            "norm": {"scale": np.ones(6, np.float32)}}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _as_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)),
                                  tree)


def test_global_norm_matches():
    g = _params(1)
    close(tadamw.global_norm(_as_torch(g)),
          radamw.global_norm(jax.tree_util.tree_map(jnp.asarray, g)))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 30.0])   # unclipped, clipped
def test_update_matches_over_steps(moment_dtype, grad_scale):
    """Six AdamW steps from the same params on the same grads (clipped or
    not): params and moments within fp32 rounding (bf16 moments within a
    bf16 step), the step counter equal."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moment_dtype=moment_dtype)
    cfg_t, cfg_r = tadamw.AdamWConfig(**kw), radamw.AdamWConfig(**kw)
    p_np = _params(0)
    pt = _as_torch(p_np)
    pr = jax.tree_util.tree_map(jnp.asarray, p_np)
    st, sr = tadamw.init(pt, cfg_t), radamw.init(pr, cfg_r)
    assert [x.dtype for x in _leaves(st.mu)] == \
        [{"float32": torch.float32, "bfloat16": torch.bfloat16}[
            moment_dtype]] * 3
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    mtol = (dict(rtol=BF16_STEP, atol=ATOL) if moment_dtype == "bfloat16"
            else {})
    for step in range(6):
        g_np = jax.tree_util.tree_map(
            lambda x: (x * grad_scale).astype(np.float32), _params(step + 1))
        pt, st, mt = tadamw.update(cfg_t, _as_torch(g_np), st, pt)
        pr, sr, mr = radamw.update(
            cfg_r, jax.tree_util.tree_map(jnp.asarray, g_np), sr, pr)
        assert int(st.step) == int(sr.step) == step + 1
        assert st.step.dtype == torch.int32
        close(mt["grad_norm"], mr["grad_norm"])
        close(mt["lr"], mr["lr"])
        for a, b in zip(_leaves(pt), _leaves(pr)):
            assert a.dtype == torch.float32
            close(a, b, err_msg=f"params at step {step}")
        for a, b in zip(_leaves(st.mu) + _leaves(st.nu),
                        _leaves(sr.mu) + _leaves(sr.nu)):
            close(a, b, err_msg=f"moments at step {step}", **mtol)


def test_update_decreases_quadratic():
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                             total_steps=100)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = tadamw.init(params, cfg)
    for _ in range(60):
        params, state, _ = tadamw.update(cfg, {"x": 2 * params["x"]}, state,
                                         params)
    assert float((params["x"] ** 2).sum()) < 0.3
