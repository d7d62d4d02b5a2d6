"""Port parity — the model-serving slice as a whole.

repro_torch.serve.engine.ServingEngine against repro.serve.engine's on the
CPU: tests/test_substrate.py's ``tiny_serving`` config, its parameters
drawn by the reference and carried across (`params_from_numpy`).  Greedy
tokens must be identical wherever the reference's top-2 margin is clear
of the bf16 tolerance of tests/test_torch_models.py, and the logits behind
them, teacher-forced on the reference's tokens, are held to it.  Parameters read back through
coded storage (a `CodedObjectStore` object or a `CodedReadServer`),
healthy or degraded, are bit-equal leaves and give identical tokens; the
parameter tree serializes to the reference's bytes, so either package's
store serves the other's parameters.  Also pins ``chip_smoke.py``'s
model known answer to the reference.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.store as rstore
import repro_torch.store as tstore
from repro.configs import get_config as rget_config
from repro.core import placement as rplace
from repro.core.circulant import CodeSpec as RSpec
from repro.models import Model as RModel
from repro.serve.engine import Request as RRequest
from repro.serve.engine import ServingEngine as REngine
from repro_torch.configs import get_config as tget_config
from repro_torch.core import placement as tplace
from repro_torch.core.circulant import CodeSpec as TSpec
from repro_torch.models import Model as TModel
from repro_torch.models import numpy_params, params_from_numpy
from repro_torch.serve.engine import CodedReadServer
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServingEngine as TEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LOGIT_ATOL = 0.125      # four bf16 steps at magnitude 4 (test_torch_models)
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab_size=128)


@pytest.fixture(scope="module")
def tiny_serving():
    """tests/test_substrate.py's tiny_serving, in both packages."""
    rcfg = rget_config("qwen3-4b").reduced(**TINY)
    tcfg = tget_config("qwen3-4b").reduced(**TINY)
    rparams = RModel(rcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(rparams), device="cpu")
    return (rcfg, RModel(rcfg), rparams), (tcfg, TModel(tcfg), tparams)


def leaves_equal(a, b) -> bool:
    la, ta = tplace.tree_flatten(a)
    lb, tb = tplace.tree_flatten(b)
    return ta == tb and all(x.dtype == y.dtype and torch.equal(x, y)
                            for x, y in zip(la, lb))


def assert_greedy_agrees(tiny, prompts, port_tokens, max_len):
    """The port's greedy tokens against the reference's, held where the
    reference decides clearly: the reference runs on its own tokens, the
    port is fed the same (teacher-forced), and at every step the logits
    agree within LOGIT_ATOL; the port's token must equal the reference's
    wherever the reference's top-2 margin exceeds 2 * LOGIT_ATOL, until
    a row's tokens first part at a closer margin (a bf16 step may then
    pick either, and the row's later tokens have other histories).
    ``port_tokens``: one list per prompt row, of any length.  Returns
    the reference's tokens, row by row, of the same lengths."""
    (_, rmodel, rparams), (_, tmodel, tparams) = tiny
    b, s = prompts.shape
    steps = max(len(r) for r in port_tokens)
    rl, rc = rmodel.prefill(rparams, {"tokens": jnp.asarray(prompts)},
                            max_len=max_len, q_chunk=None)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                            max_len=max_len, q_chunk=None)
    following = np.ones(b, bool)
    ref_tokens = [[] for _ in range(b)]
    for t in range(steps):
        want, got = np.asarray(rl[:, -1]), tl[:, -1].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {t}")
        ref_tok = want.argmax(-1)
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
        for i, row in enumerate(port_tokens):
            if t < len(row):
                ref_tokens[i].append(int(ref_tok[i]))
            if t < len(row) and following[i]:
                assert row[t] == ref_tok[i] or not clear[i], (i, t)
                following[i] = row[t] == ref_tok[i]
        tok = ref_tok[:, None].astype(np.int32)
        rl, rc = rmodel.decode_step(rparams, rc, jnp.asarray(tok),
                                    jnp.asarray(s + t, jnp.int32),
                                    max_len=max_len)
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok),
                                    s + t, max_len=max_len)
    return ref_tokens


def assert_serve_agrees(tiny, done, batch_size, prompt_len, max_len):
    """assert_greedy_agrees for each round of ServingEngine.serve, on the
    prompts as serve pads them; returns the reference's tokens."""
    ref_tokens = []
    for i in range(0, len(done), batch_size):
        active = done[i:i + batch_size]
        prompts = np.zeros((len(active), prompt_len), np.int32)
        for j, r in enumerate(active):
            p = r.prompt[-prompt_len:]
            prompts[j, prompt_len - len(p):] = p
        ref_tokens += assert_greedy_agrees(
            tiny, prompts, [r.out_tokens for r in active], max_len)
    return ref_tokens


def requests(cls, vocab):
    return [cls(uid=i, prompt=np.arange(4 + i, dtype=np.int32) % vocab,
                max_new_tokens=3 + i % 3) for i in range(5)]


# ------------------------------------------------------------ generation
def test_generate_matches_reference(tiny_serving):
    (rcfg, rmodel, rparams), (tcfg, tmodel, tparams) = tiny_serving
    prompts = np.arange(12, dtype=np.int32).reshape(2, 6) % tcfg.vocab_size
    want = REngine(rmodel, rparams, batch_size=4, max_len=64).generate(
        prompts, 8)
    eng = TEngine(tmodel, tparams, batch_size=4, max_len=64)
    got = eng.generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 8), got)
    with pytest.raises(ValueError):
        eng.generate(prompts, 60)                # past the cache


def test_teacher_forced_logits_match_reference(tiny_serving):
    """The logits behind the tokens above, step by step on the reference's
    own tokens, within the stated bf16 tolerance."""
    (rcfg, rmodel, rparams), (tcfg, tmodel, tparams) = tiny_serving
    prompts = np.arange(12, dtype=np.int32).reshape(2, 6) % tcfg.vocab_size
    rl, rc = rmodel.prefill(rparams, {"tokens": jnp.asarray(prompts)},
                            max_len=64, q_chunk=None)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                            max_len=64, q_chunk=None)
    for t in range(8):
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=str(t))
        tok = np.asarray(rl[:, -1]).argmax(-1)[:, None].astype(np.int32)
        rl, rc = rmodel.decode_step(rparams, rc, jnp.asarray(tok),
                                    jnp.asarray(6 + t, jnp.int32), max_len=64)
        tl, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), 6 + t,
                                    max_len=64)


def test_serve_matches_reference(tiny_serving):
    (rcfg, rmodel, rparams), (tcfg, tmodel, tparams) = tiny_serving
    want = REngine(rmodel, rparams, batch_size=2, max_len=64).serve(
        requests(RRequest, rcfg.vocab_size), prompt_len=8)
    got = TEngine(tmodel, tparams, batch_size=2, max_len=64).serve(
        requests(TRequest, tcfg.vocab_size), prompt_len=8)
    assert [r.uid for r in got] == [r.uid for r in want]
    assert all(r.done and len(r.out_tokens) == r.max_new_tokens for r in got)
    assert assert_serve_agrees(tiny_serving, got, 2, 8, 64) == \
        [r.out_tokens for r in want]


def test_sampling_is_seeded(tiny_serving):
    """temperature > 0 draws from a torch.Generator seeded with ``seed``:
    the same seed gives the same tokens, in range."""
    _, (tcfg, tmodel, tparams) = tiny_serving
    prompts = np.arange(12, dtype=np.int32).reshape(2, 6)
    outs = [TEngine(tmodel, tparams, batch_size=2, max_len=32,
                    temperature=1.0, seed=s).generate(prompts, 8)
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    assert outs[0].min() >= 0 and outs[0].max() < tcfg.vocab_size


# ------------------------------------------------------ coded parameters
def test_param_bytes_identical_to_reference(tiny_serving):
    (_, _, rparams), (_, _, tparams) = tiny_serving
    tpay, ttd, tmeta = tplace.pytree_to_bytes(tparams)
    rpay, rtd, rmeta = rplace.pytree_to_bytes(rparams)
    assert tpay == rpay and tmeta == rmeta and str(ttd) == str(rtd)
    tb, _, tspec = tplace.pytree_to_blocks(tparams, 8, 257)
    rb, _, rspec = rplace.pytree_to_blocks(rparams, 8, 257)
    np.testing.assert_array_equal(tb, rb)
    assert tspec.to_json() == rspec.to_json()


@pytest.mark.parametrize("lost", [(), (3,), (1, 2)])
def test_from_object_store_bit_exact(tiny_serving, lost):
    """put_pytree into a port store, then serve from it healthy and with
    nodes lost (degraded reads): bit-equal leaves, identical tokens."""
    _, (tcfg, tmodel, tparams) = tiny_serving
    prompts = np.arange(12, dtype=np.int32).reshape(2, 6)
    want = TEngine(tmodel, tparams, batch_size=2, max_len=32).generate(
        prompts, 6)
    store = tstore.CodedObjectStore(TSpec.make(4, 257), n_nodes=10,
                                    stripe_symbols=1 << 10, device="cpu")
    store.put_pytree("params", tparams)
    for node in lost:
        store.fail_node(node)
    eng = TEngine.from_coded_store(tmodel, store, key="params", batch_size=2,
                                   max_len=32)
    assert leaves_equal(eng.params, tparams)
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)
    if lost:
        store.fail_node(5)
        eng.reload_params(store, key="params")
        assert leaves_equal(eng.params, tparams)
        np.testing.assert_array_equal(eng.generate(prompts, 6), want)


def test_from_coded_read_server_bit_exact(tiny_serving):
    """serve_demo.py's path: the parameters on a [2k, k] cluster, a rack of
    n - k nodes killed, reload (degraded decode), repair, reload."""
    (rcfg, rmodel, rparams), (tcfg, tmodel, tparams) = tiny_serving
    spec = TSpec.make(4, 257)
    srv = CodedReadServer.for_pytree(tparams, spec, device="cpu")
    reqs = requests(TRequest, tcfg.vocab_size)
    eng = TEngine.from_coded_store(tmodel, srv, batch_size=2, max_len=64)
    assert leaves_equal(eng.params, tparams)
    done = eng.serve(reqs, prompt_len=8)
    assert_serve_agrees(tiny_serving, done, 2, 8, 64)
    healthy = [r.out_tokens for r in done]
    for v in range(1, spec.n - spec.k + 1):
        srv.sim.fail_node(v)
    eng.reload_params(srv)
    assert leaves_equal(eng.params, tparams)
    assert srv.metrics.reads_degraded > 0
    degraded = [r.out_tokens for r in eng.serve(
        requests(TRequest, tcfg.vocab_size), prompt_len=8)]
    assert degraded == healthy
    assert srv.sim.repair_now()
    assert torch.equal(srv.sim.node_a, srv.sim._orig_a)
    eng.reload_params(srv)
    assert leaves_equal(eng.params, tparams)


def test_reference_store_params_served_by_port(tiny_serving):
    """Parameters put by the reference's object store, read through the
    port's (``store_from_numpy``), healthy and with a node lost."""
    (rcfg, rmodel, rparams), (tcfg, tmodel, tparams) = tiny_serving
    ref = rstore.CodedObjectStore(RSpec.make(4, 257), n_nodes=10,
                                  stripe_symbols=1 << 10)
    ref.put_pytree("params", rparams)
    ttd = tplace.tree_flatten(tparams)[1]
    st = ref.stat("params")
    assert str(ttd) == str(st.meta["treedef"])
    stats = [{**{f.name: getattr(st, f.name)
                 for f in dataclasses.fields(st)},
              "code_class": st.code_class.to_meta(),
              "meta": {**st.meta, "treedef": ttd}}]
    port = tstore.store_from_numpy(
        TSpec.make(4, 257), ref._shares, stats, n_nodes=10,
        n_racks=ref.layout.n_racks, stripe_symbols=1 << 10, device="cpu")
    eng = TEngine.from_coded_store(tmodel, port, key="params", batch_size=2,
                                   max_len=32)
    assert leaves_equal(eng.params, tparams)
    port.fail_node(2)
    eng.reload_params(port, key="params")
    assert leaves_equal(eng.params, tparams)


# ------------------------------------------------------------ known answer
def test_model_known_answer_pinned():
    """chip_smoke.KA_MODEL_LOGITS are the reference's logits for the known
    config, weights and prompt, and the port on the CPU reproduces them
    within the smoke's stated tolerance."""
    over = chip_smoke.KA_MODEL_OVERRIDES
    tcfg = tget_config(chip_smoke.KA_MODEL_ARCH).reduced(**over)
    rcfg = rget_config(chip_smoke.KA_MODEL_ARCH).reduced(**over)
    tree = numpy_params(tcfg, chip_smoke.KA_MODEL_SEED)
    prompt = chip_smoke.ka_model_prompt(np, tcfg.vocab_size)
    rl, _ = RModel(rcfg).prefill(jax.tree_util.tree_map(jnp.asarray, tree),
                                 {"tokens": jnp.asarray(prompt)}, q_chunk=None)
    want = np.asarray(rl)[0, -1, chip_smoke.KA_MODEL_SLICE]
    np.testing.assert_array_equal(
        want, np.asarray(chip_smoke.KA_MODEL_LOGITS, np.float32))
    tl, _ = TModel(tcfg).prefill(params_from_numpy(tree, device="cpu"),
                                 {"tokens": torch.from_numpy(prompt)},
                                 q_chunk=None)
    np.testing.assert_allclose(tl[0, -1, chip_smoke.KA_MODEL_SLICE].numpy(),
                               want, rtol=0, atol=chip_smoke.KA_MODEL_ATOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "arctic-480b",
                                  "recurrentgemma-2b", "xlstm-1.3b",
                                  "whisper-medium"])
def test_reference_store_family_params_served_by_port(arch):
    """One reduced config of each family beyond dense attention: the
    reference's parameters put by its object store, read through the
    port's (``store_from_numpy``) healthy and with a node lost, bit-equal
    to the tree carried across directly, and served: greedy tokens from
    ``ServingEngine``, or for whisper a prefill and a decode step over
    frame embeddings, equal to those from the directly carried tree."""
    rcfg, tcfg = rget_config(arch).reduced(), tget_config(arch).reduced()
    rparams = RModel(rcfg).init(jax.random.PRNGKey(3))
    direct = params_from_numpy(jax.device_get(rparams), device="cpu")
    ref = rstore.CodedObjectStore(RSpec.make(4, 257), n_nodes=10,
                                  stripe_symbols=1 << 12)
    ref.put_pytree("params", rparams)
    st = ref.stat("params")
    ttd = tplace.tree_flatten(direct)[1]
    assert str(ttd) == str(st.meta["treedef"])
    stats = [{**{f.name: getattr(st, f.name)
                 for f in dataclasses.fields(st)},
              "code_class": st.code_class.to_meta(),
              "meta": {**st.meta, "treedef": ttd}}]
    port = tstore.store_from_numpy(
        TSpec.make(4, 257), ref._shares, stats, n_nodes=10,
        n_racks=ref.layout.n_racks, stripe_symbols=1 << 12, device="cpu")
    model = TModel(tcfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    frames = torch.from_numpy((rng.standard_normal(
        (2, tcfg.encoder_seq, tcfg.d_model)) * 0.02).astype(np.float32))

    def serve(params):
        if not tcfg.is_encoder_decoder:
            return TEngine(model, params, batch_size=2,
                           max_len=32).generate(prompts, 4)
        # the reference's engine takes token prompts only: whisper is
        # served through Model.prefill / decode_step
        batch = {"tokens": torch.from_numpy(prompts), "enc_embeds": frames}
        logits, cache = model.prefill(params, batch, max_len=20)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        logits, _ = model.decode_step(params, cache, tok, 16, max_len=20)
        return np.concatenate([tok.numpy(), logits[:, -1].argmax(
            -1)[:, None].numpy()], 1)

    want = serve(direct)
    for lost in ((), (2,)):
        for node in lost:
            port.fail_node(node)
        got = TEngine.from_coded_store(model, port, key="params",
                                       batch_size=2, max_len=32).params
        assert leaves_equal(got, direct), lost
        np.testing.assert_array_equal(serve(got), want)
