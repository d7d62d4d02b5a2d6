"""The port on the card: the Hopper kernels against their plain torch
versions, the planner's pinned staging, and the slice end to end.

Every test here is marked `cuda` and skips on hosts without a card.  The
file imports nothing of JAX, so it also runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The plain versions it compares against are the ones the CPU parity tests
(tests/test_torch_*.py) hold to the JAX reference.
"""
import contextlib

import numpy as np
import pytest
import torch
from _torch_parity import cuda, npy, rand  # noqa: F401 (fixture)

from repro_torch.core.circulant import CodeSpec
from repro_torch.core import msr as tmsr
from repro_torch.exec import plan as tplan
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.circulant_encode import circulant_encode
from repro_torch.kernels.gf_matmul import fold_mismatches, gf_matmul

P = 257
pytestmark = pytest.mark.cuda


def on(dev, x):
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_gf_matmul_matches_plain(cuda, p):
    for m, k, s in ((2, 8, 4099), (16, 16, 4096), (18, 16, 1000),
                    (3, 300, 640), (1, 7, 130), (128, 128, 256)):
        a, b = on(cuda, rand((m, k), p, s)), on(cuda, rand((k, s), p, s + 1))
        n0 = gf_matmul.launches
        got = gf_matmul(a, b, p)
        assert gf_matmul.launches == n0 + 1
        assert torch.equal(got, ref.gf_matmul_ref(a, b, p)), (m, k, s)
    b = on(cuda, rand((4, 8, 1001), p, 3))
    for a in (rand((2, 8), p, 4), rand((4, 2, 8), p, 5)):
        a = on(cuda, a)
        assert torch.equal(gf_matmul(a, b, p), ref.gf_matmul_ref(a, b, p))
    for k in (127, 128, 129, 300):
        a = torch.full((2, k), p - 1, dtype=torch.int32, device=cuda)
        b = torch.full((k, 384), p - 1, dtype=torch.int32, device=cuda)
        assert torch.equal(gf_matmul(a, b, p), ref.gf_matmul_ref(a, b, p))
    torch.cuda.synchronize()


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_gf_matmul_row_sources_match_plain(cuda, p):
    """The kernel on 1-4 row sources, every tile width (m up to 16, 32, 64
    and past it), k across a staging chunk, aligned and unaligned streams,
    a misaligned source base, batching with a shared and a per-element a,
    and unreduced inputs."""
    rng = np.random.default_rng(p)
    cases = [(m, k, s) for m in (1, 2, 16, 18, 33, 65) for k in (1, 9, 300)
             for s in (3, 1027, 4096)]
    for i, (m, k, s) in enumerate(cases):
        nsrc = min(k, 1 + i % 4)
        cuts = [k - nsrc + 1] + [1] * (nsrc - 1)
        lead = () if i % 3 == 0 else (2,)
        hi = p if i % 2 else 4 * p
        srcs = [on(cuda, rng.integers(-hi, hi, lead + (r, s), dtype=np.int32))
                for r in cuts]
        if i % 5 == 4:        # first source 4 bytes past a 16-byte boundary
            flat = torch.zeros(1 + srcs[0].numel(), dtype=torch.int32,
                               device=cuda)
            flat[1:] = srcs[0].reshape(-1)
            srcs[0] = flat[1:].view(srcs[0].shape)
        a = on(cuda, rng.integers(-hi, hi, (lead if i % 3 == 2 else ()) +
                                  (m, k), dtype=np.int32))
        n0 = gf_matmul.launches
        got = gf_matmul(a, tuple(srcs), p)
        assert gf_matmul.launches == n0 + 1
        assert torch.equal(got, ref.gf_matmul_ref(a, torch.cat(srcs, -2), p)),\
            (m, k, s, cuts, lead)
    torch.cuda.synchronize()


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_barrett_fold_exact_for_every_uint32(cuda, p):
    assert fold_mismatches(p) == 0


@pytest.mark.parametrize("planned", [False, True])
def test_every_regenerate_is_one_launch(cuda, planned):
    spec = CodeSpec.make(4, P)
    code = tmsr.DoubleCirculantMSR(spec)
    data = on(cuda, rand((spec.n, 4099), P, 7))
    red = code.encode(data)
    nodes = [2, 5, 8]
    plans = [code.repair_plan(i) for i in nodes]
    r_prevs = red[torch.as_tensor([pl.prev_node - 1 for pl in plans])]
    helpers = data[torch.as_tensor([list(pl.data_indices) for pl in plans])]
    eng = code.repair
    ops = ([lambda: eng.regenerate_planned(2, r_prevs[0], helpers[0]).host(),
            lambda: eng.regenerate_batch_planned(nodes, r_prevs,
                                                 helpers).host()]
           if planned else
           [lambda: torch.stack(eng.regenerate(2, r_prevs[0], helpers[0])),
            lambda: eng.regenerate_batch(nodes, r_prevs, helpers)])
    for op in ops:
        n0 = gf_matmul.launches
        out = npy(op())
        assert gf_matmul.launches == n0 + 1
        pairs = out[None] if out.ndim == 2 else out
        for j, pair in enumerate(pairs):
            np.testing.assert_array_equal(pair[0], npy(data[nodes[j] - 1]))
            np.testing.assert_array_equal(pair[1], npy(red[nodes[j] - 1]))


def test_gf_matmul_reduces_unreduced_inputs(cuda):
    rng = np.random.default_rng(3)
    a = on(cuda, rng.integers(-1000, 1000, (3, 5)).astype(np.int32))
    b = on(cuda, rng.integers(-1000, 1000, (5, 403)).astype(np.int32))
    assert torch.equal(gf_matmul(a, b, P), ref.gf_matmul_ref(a, b, P))


@pytest.mark.parametrize("p", [5, 257, 46337])
def test_circulant_encode_matches_plain(cuda, p):
    for k in (1, 2, 3, 8, 16, 64, 130, 256):
        c = [int(x) for x in np.random.default_rng(k).integers(1, p, k)]
        for s in (4096, 1001):
            d = on(cuda, rand((2 * k, s), p, k + s))
            n0 = circulant_encode.launches
            assert torch.equal(circulant_encode(d, c, p),
                               ref.circulant_encode_ref(d, c, p)), (k, s)
            assert circulant_encode.launches == n0 + 1
    torch.cuda.synchronize()


def test_wrappers_raise_instead_of_falling_back(cuda):
    a = on(cuda, rand((2, 8), P, 0))
    b = on(cuda, rand((16, 8), P, 1))
    with pytest.raises(ValueError, match="contiguous"):
        gf_matmul(a, b.T, P)
    with pytest.raises(ValueError, match="k <= 256"):
        circulant_encode(on(cuda, rand((514, 8), P, 2)), [1] * 257, P)
    with pytest.raises(ValueError, match="a on"):
        gf_matmul(a.cpu(), on(cuda, rand((8, 4), P, 3)), P)


def test_planner_stages_numpy_through_pinned_pool(cuda):
    spec = CodeSpec.make(4, P)
    pc = tplan.PlanCache(dispatch.get("cuda"), P, bucket_min=32, device=cuda)
    assert pc.staging.pin
    data = rand((spec.n, 333), P, 9)
    res = pc.circulant_encode(data, spec.c)
    assert pc.staging.stats().in_use == 1     # held until the copy is done
    out = res.host()
    assert pc.staging.stats().in_use == 0
    np.testing.assert_array_equal(
        out, npy(tmsr.DoubleCirculantMSR(spec, device="cpu").encode(data)))


@pytest.mark.parametrize("k", [2, 8])
def test_slice_matches_cpu(cuda, k):
    payload = np.random.default_rng(k).integers(
        0, 256, size=16 * 4099 + 3, dtype=np.uint8).tobytes()
    spec = CodeSpec.make(k, P)
    code = tmsr.DoubleCirculantMSR(spec)
    assert code.backend_name == "cuda"
    enc = tmsr.encode_file(payload, spec, code)
    cpu = tmsr.encode_file(payload, spec, device="cpu")
    np.testing.assert_array_equal(npy(enc.red), npy(cpu.red))
    nodes = [1, 2 * k]
    plans = [code.repair_plan(i) for i in nodes]
    out = code.regenerate_batch(
        nodes, enc.red[torch.as_tensor([pl.prev_node - 1 for pl in plans])],
        enc.data[torch.as_tensor([list(pl.data_indices) for pl in plans])])
    for j, i in enumerate(nodes):
        assert torch.equal(out[j, 0], enc.data[i - 1])
        assert torch.equal(out[j, 1], enc.red[i - 1])
    assert tmsr.reconstruct_file(enc, list(range(k + 1, 2 * k + 1))) == \
        payload
    use = list(range(2, k + 2))
    idx = torch.as_tensor([i - 1 for i in use], device=cuda)
    dat, red = code.reconstruct_with_repair(use, enc.data[idx], enc.red[idx],
                                            [1])
    assert torch.equal(dat, enc.data) and torch.equal(red, enc.red[:1])


# ------------------------------------------------------------ store path
def _store_run(device):
    """A small store driven through put, degraded get, repair drains and a
    conversion to product-matrix; returns what the comparison reads."""
    from repro_torch.codes import CodeClass
    from repro_torch.store import CodedObjectStore, RepairScheduler
    store = CodedObjectStore(CodeSpec.make(4, P), n_nodes=12,
                             stripe_symbols=67, device=device)
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    rng = np.random.default_rng(11)
    objs = {f"o{i}": rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for i, n in enumerate((5000, 531, 3))}
    for key, v in objs.items():
        store.put(key, v)
    store.fail_node(2)
    gets = [store.get_ext(key) for key in objs]
    store.replace_node(2)
    reports = [sched.drain_all()]
    for v in (1, 4, 7):
        store.fail_node(v)
    for v in (1, 4, 7):
        store.replace_node(v)
    reports.append(sched.drain_all())
    receipt = store.convert("o0", CodeClass("product-matrix", 8, 4, 6))
    store.fail_node(5)
    store.replace_node(5)
    reports.append(sched.drain_all())
    for key, v in objs.items():
        assert store.get(key) == v
    assert store.verify()
    shares = [{kt: [s[0]] + [np.asarray(b) for b in s[1:]]
               for kt, s in held.items()} for held in store._shares]
    return (shares, {k: store.stat(k).share_crcs for k in objs},
            [(g.obj, g.bytes_read, g.degraded_stripes) for g in gets],
            reports, receipt)


def test_store_on_card_matches_cpu(cuda):
    n0 = gf_matmul.launches, circulant_encode.launches
    card = _store_run(None)
    assert gf_matmul.launches > n0[0] and circulant_encode.launches > n0[1]
    cpu = _store_run("cpu")
    assert card[1:] == cpu[1:]
    for held_card, held_cpu in zip(card[0], cpu[0]):
        assert held_card.keys() == held_cpu.keys()
        for kt, share in held_card.items():
            assert share[0] == held_cpu[kt][0]
            for a, b in zip(share[1:], held_cpu[kt][1:]):
                np.testing.assert_array_equal(a, b)


def test_store_batched_repairs_are_one_launch_per_window(cuda):
    from repro_torch.codes import CodeClass
    from repro_torch.store import CodedObjectStore, RepairScheduler
    store = CodedObjectStore(CodeSpec.make(4, P), n_nodes=12,
                             stripe_symbols=64, repair_tile_tasks=3)
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    payload = bytes(range(256)) * 120
    store.put("dc", payload)
    store.put("pm", payload, code_class=CodeClass("product-matrix", 8, 4, 6))
    store.fail_node(3)
    store.replace_node(3)
    n_pm = sum(1 for t in range(store.stat("pm").n_stripes)
               if 3 in store.placement_of("pm", t))
    fam = store.class_of("pm").key()

    def pm_calls():
        st = tplan.plan_stats_by_family().get(fam)
        return 0 if st is None else st.hits + st.misses

    n0, c0 = gf_matmul.launches, pm_calls()
    rep = sched.drain_all()
    # each product-matrix window is two planned launches: all its helper
    # sends, then the newcomer products
    pm_windows, odd = divmod(pm_calls() - c0, 2)
    assert rep.decode_calls == 0 and rep.batch_calls >= 2 and not odd
    assert pm_windows >= -(-n_pm // store.repair_tile_tasks) > 0
    assert gf_matmul.launches - n0 == rep.batch_calls + pm_windows
    assert store.get("dc") == payload and store.get("pm") == payload
    # the planner ops themselves: one launch each, whatever the batch
    pc = store.code.planner
    rmat = store.code.repair.repair_matrix()
    for f in (1, 3, 5):
        n0 = gf_matmul.launches
        out = pc.regenerate_batch(rmat, rand((f, 99), P, f),
                                  rand((f, 4, 99), P, f + 1)).host()
        assert gf_matmul.launches == n0 + 1 and out.shape == (f, 2, 99)
        n0 = gf_matmul.launches
        mats, blocks = rand((f, 3, 6), P, f + 2), rand((f, 6, 99), P, f + 3)
        got = pc.matmul_batch(mats, blocks).host()
        assert gf_matmul.launches == n0 + 1
        np.testing.assert_array_equal(
            got, (mats.astype(np.int64) @ blocks.astype(np.int64)) % P)


def test_drain_tick_gathers_its_operands_in_place_in_parallel(cuda):
    """A drain tick hands each window's two operands to the planner as
    they lie, filled in pinned staging buffers: ``staged_in_place`` rises
    by 2 a window and the pool hands out no buffer beyond those two, so
    ``t_h2d`` is the DMA alone.  The gather's threads work side by side
    while the tick waits: ``t_gather / t_read_wait`` above 1.5."""
    from repro_torch.store import CodedObjectStore, RepairScheduler
    s = 1 << 18
    store = CodedObjectStore(CodeSpec.make(8, P), n_nodes=20,
                             stripe_symbols=s, repair_tile_tasks=8,
                             io_workers=4, pipeline_depth=2)
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    payload = np.random.default_rng(0).integers(
        0, 256, 16 * 16 * s, np.uint8).tobytes()     # 16 stripes
    pc = store.code.planner
    with store:
        store.put("a", payload)
        store.fail_node(3)
        store.replace_node(3)
        sched.drain_all()                   # warms the repair shapes
        store.fail_node(7)
        store.replace_node(7)
        n0, st0 = pc.staged_in_place, pc.staging.stats()
        store.pipeline.reset_stage_stats()
        rep = sched.drain()
        st, st1 = store.pipeline.stage_stats(), pc.staging.stats()
        assert sched.pending() == 0 and store.get("a") == payload
    windows = rep.batch_calls
    assert windows == -(-rep.repaired_shares // 8) >= 2
    assert pc.staged_in_place == n0 + 2 * windows
    assert (st1.hits + st1.misses) - (st0.hits + st0.misses) == 2 * windows
    assert st1.in_use == st0.in_use
    assert st["t_h2d"] > 0.0
    assert st["t_gather"] / st["t_read_wait"] > 1.5, st


def test_caller_staged_pinned_buffer_is_not_copied_again(cuda):
    pc = tplan.PlanCache(dispatch.get("cuda"), P, bucket_min=32, device=cuda)
    b, pad = pc.stream_pad(1000)
    assert (b, pad) == (1024, 1000)
    buf = pc.staging.acquire((8, pad), np.int32)
    buf[...] = rand((8, pad), P, 4)
    mat = rand((3, 8), P, 5)
    st0 = pc.staging.stats()
    res = pc.matmul(mat, buf)
    st1 = pc.staging.stats()
    assert pc.staged_in_place == 1
    assert (st1.hits, st1.misses, st1.in_use) == (st0.hits, st0.misses, 1)
    out = res.host()
    assert pc.staging.stats().in_use == 1      # still the caller's
    np.testing.assert_array_equal(
        out, (mat.astype(np.int64) @ buf.astype(np.int64)) % P)
    pc.staging.release(buf)
    assert pc.staging.stats().in_use == 0


def test_host_waits_for_its_own_window_only(cuda):
    pc = tplan.PlanCache(dispatch.get("cuda"), P, bucket_min=32, device=cuda)
    mat = on(cuda, rand((4, 8), P, 1))
    blocks = on(cuda, rand((8, 4099), P, 2))
    first = pc.matmul(mat, blocks)
    torch.cuda._sleep(2_000_000_000)           # ~1 s of device time
    second = pc.matmul(mat, blocks)
    queued = torch.cuda.Event()
    queued.record()
    out = first.host()
    assert not queued.query()                  # window t+1 still queued
    np.testing.assert_array_equal(out, second.host())
    torch.cuda.synchronize()


def test_host_results_are_pageable(cuda):
    pc = tplan.PlanCache(dispatch.get("cuda"), P, bucket_min=32, device=cuda)
    buf = pc.staging.acquire((8, 4099), np.int32)
    buf[...] = rand((8, 4099), P, 6)
    mat = rand((3, 8), P, 7)
    out = pc.matmul(mat, buf).host()
    pc.staging.release(buf)
    assert torch.from_numpy(buf).is_pinned()   # the staging side is pinned
    assert not torch.from_numpy(out).is_pinned()
    np.testing.assert_array_equal(
        out, (mat.astype(np.int64) @ buf.astype(np.int64)) % P)


def test_code_families_compute_on_the_card(cuda):
    """Product-matrix encode, helper sends, repair and decode launch the
    kernel on the card, with planning on or off."""
    from repro_torch.codes import CodeClass, make_code
    code = make_code(CodeClass("product-matrix", 8, 4, 6))
    data = rand((code.data_blocks, 301), P, 8)
    for planning in (True, False):
        with contextlib.ExitStack() as stack:
            if not planning:
                stack.enter_context(tplan.planning_disabled())
            n0 = gf_matmul.launches
            shares = code.encode_shares(data)
            assert gf_matmul.launches == n0 + 1
            plans = [code.repair_plan(f) for f in (1, 5)]
            n0 = gf_matmul.launches
            sends = np.stack([code.helper_sends(
                [(sm, shares[h - 1]) for sm, h in zip(pl.send_matrices,
                                                      pl.helpers)])
                for pl in plans])
            assert gf_matmul.launches == n0 + 2       # one per helper set
            got = code.regenerate_many_planned(plans, sends).host()
            np.testing.assert_array_equal(got, shares[[0, 4]])
            subset = (2, 3, 6, 8)
            dl = np.concatenate([shares[j - 1] for j in subset])
            n0 = gf_matmul.launches
            np.testing.assert_array_equal(code.reconstruct(subset, dl), data)
            assert gf_matmul.launches == n0 + 1


# ------------------------------------------- durability and serving layer
def test_write_behind_snapshot_survives_in_place_update(cuda, tmp_path):
    """save_async of card tensors, then every leaf updated in place on the
    card at once, on a side stream too: the saved step is the state
    before the update, bit for bit."""
    from repro_torch.checkpoint import MSRCheckpointer
    ck = MSRCheckpointer(tmp_path, CodeSpec.make(8, P),
                         save_tile_symbols=1 << 16)
    gen = torch.Generator(device=cuda).manual_seed(0)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        state = {"w": torch.randn((512, 1031), generator=gen,
                                  device=cuda).to(torch.bfloat16),
                 "m": torch.randn((512, 1031), generator=gen, device=cuda),
                 "step": torch.tensor(3, dtype=torch.int64, device=cuda)}
        before = {k: v.clone() for k, v in state.items()}
        ck.save_async(3, state)
        for v in state.values():
            v.add_(1)
    ck.barrier()
    got, rep = ck.restore(state, 3)
    assert rep.path == "systematic"
    assert all(got[k].device.type == "cuda" and torch.equal(got[k], before[k])
               for k in state)
    ck.close()


@pytest.mark.parametrize("failed", [(5,), (2, 9, 14)])
def test_checkpoint_restore_is_one_launch_per_tile(cuda, tmp_path, failed):
    """The regenerate (one node lost) and the decode+repair (three lost)
    are each one gf_matmul launch per stream tile, the save one
    circulant_encode launch per tile."""
    from repro_torch.checkpoint import MSRCheckpointer
    tile = 1 << 14
    ck = MSRCheckpointer(tmp_path, CodeSpec.make(8, P),
                         save_tile_symbols=tile)
    state = {"w": torch.arange(16 * 3 * tile + 4099, dtype=torch.int32,
                               device=cuda)}
    n0 = circulant_encode.launches
    ck.save(1, state)
    s_block = -(-state["w"].numel() * 4 // 16)      # symbols per block
    tiles = -(-s_block // tile)
    assert s_block % tile and circulant_encode.launches - n0 == tiles
    n0 = gf_matmul.launches
    got, rep = ck.restore(state, 1, failed_nodes=failed)
    assert gf_matmul.launches - n0 == tiles
    assert rep.repaired_nodes == failed and torch.equal(got["w"], state["w"])
    assert ck.scrub(1).clean


def test_front_end_coalesced_decode_is_one_launch_per_pattern(cuda):
    from repro_torch.serve import ReadFrontEnd
    from repro_torch.store import CodedObjectStore
    store = CodedObjectStore(CodeSpec.make(4, P), n_nodes=12,
                             stripe_symbols=256)
    objs = {f"o{i}": bytes(rand((5000 + 999 * i,), 256, i).astype(np.uint8))
            for i in range(4)}
    for key, v in objs.items():
        store.put(key, v)
    store.fail_node(2)
    store.fail_node(7)
    with ReadFrontEnd(store) as fe:
        n0 = gf_matmul.launches
        tks = [fe.submit(key) for key in objs for _ in range(2)]
        fe.pump()
        assert all(tk.result() == objs[tk.key] for tk in tks)
        assert fe.metrics.decode_dispatches > 0
        assert gf_matmul.launches - n0 == fe.metrics.decode_dispatches
    assert store.code.planner.staging.stats().in_use == 0
    store.close()


def test_simulator_on_card_matches_cpu(cuda):
    from repro_torch.cluster import events, run_scenario
    data = rand((16, 4099), P, 9)
    for sc in events.standard_scenarios(16, 8):
        n0 = gf_matmul.launches
        card = run_scenario(CodeSpec.make(8, P), data, sc).to_json()
        assert gf_matmul.launches > n0
        assert card == run_scenario(CodeSpec.make(8, P), data, sc,
                                    device="cpu").to_json()


def test_drills_pass_on_card(cuda, tmp_path):
    from repro_torch.cluster import run_drills
    for res in run_drills(tmp_path):
        assert res.passed and res.bit_exact and res.orphans == 0, res


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-27b", "starcoder2-7b"])
def test_model_on_card_matches_cpu(cuda, arch):
    """Prefill and three decode steps of a reduced config on the card
    against the CPU plain path on the same weights: within four bf16 steps
    at magnitude 4 (the card's and the CPU's matmuls sum in different
    orders, so a bf16 output may land a step apart)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, numpy_params, params_from_numpy
    cfg = get_config(arch).reduced()
    tree = numpy_params(cfg, 0)
    model = Model(cfg)
    on_card = params_from_numpy(tree)
    on_cpu = params_from_numpy(tree, device="cpu")
    assert on_card["embed"].device.type == "cuda"
    tok = rand((2, 40), cfg.vocab_size, 1)
    lc, cc = model.prefill(on_card, {"tokens": on(cuda, tok)}, max_len=44)
    lh, ch = model.prefill(on_cpu, {"tokens": torch.from_numpy(tok)},
                           max_len=44)
    for t in range(4):
        got, want = lc.cpu().numpy(), lh.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0.125)
        nxt = want[:, -1].argmax(-1)[:, None].astype(np.int32)
        lc, cc = model.decode_step(on_card, cc, on(cuda, nxt), 40 + t,
                                   max_len=44)
        lh, ch = model.decode_step(on_cpu, ch, torch.from_numpy(nxt), 40 + t,
                                   max_len=44)


FAMILY_ARCHS = ["granite-moe-1b-a400m", "arctic-480b", "recurrentgemma-2b",
                "xlstm-1.3b", "whisper-medium"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_on_card_matches_cpu(cuda, arch):
    """The block kinds beyond dense attention, reduced: prefill and three
    decode steps on the card against the CPU plain path on the same
    weights (and, for whisper, the same frame embeddings), within 0.125;
    greedy tokens equal wherever the CPU's top-2 margin exceeds 0.25.  An
    MoE runs dropless, so a near-tie routed differently moves one token's
    share of one expert and nothing else."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model, numpy_params, params_from_numpy
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1e9)
    tree = numpy_params(cfg, 0)
    model = Model(cfg)
    on_card, on_cpu = params_from_numpy(tree), params_from_numpy(
        tree, device="cpu")
    tok = rand((2, 32), cfg.vocab_size, 1)
    bc, bh = {"tokens": on(cuda, tok)}, {"tokens": torch.from_numpy(tok)}
    if cfg.is_encoder_decoder:
        frames = (np.random.default_rng(2).standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
        bc["enc_embeds"], bh["enc_embeds"] = on(cuda, frames), \
            torch.from_numpy(frames)
    lc, cc = model.prefill(on_card, bc, max_len=36)
    lh, ch = model.prefill(on_cpu, bh, max_len=36)
    for t in range(4):
        got, want = lc.cpu().numpy(), lh.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=0.125)
        top2 = np.sort(want, -1)[..., -2:]
        sure = top2[..., 1] - top2[..., 0] > 0.25
        np.testing.assert_array_equal(got.argmax(-1)[sure],
                                      want.argmax(-1)[sure])
        nxt = want[:, -1].argmax(-1)[:, None].astype(np.int32)
        lc, cc = model.decode_step(on_card, cc, on(cuda, nxt), 32 + t,
                                   max_len=36)
        lh, ch = model.decode_step(on_cpu, ch, torch.from_numpy(nxt), 32 + t,
                                   max_len=36)


def test_moe_routing_on_card_matches_cpu(cuda):
    """Routing on identical fp32 logits with exact ties (at and across
    the top-k boundary): the card's stable sort picks the CPU's experts
    in the CPU's order, so queue positions and kept choices are equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m")          # 32 experts, top 8
    rng = np.random.default_rng(3)
    logits = (rng.integers(-6, 7, (4, 1024, 32)) / 4.0).astype(np.float32)
    logits[0, :8] = 0.0                                # all 32 tied
    cap = moe._capacity(1024, cfg)
    got = moe.route(cfg, on(cuda, logits), cap)
    want = moe.route(cfg, torch.from_numpy(logits), cap)
    for key in ("gate_idx", "pos_in_expert", "keep"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert got["gate_idx"][0, 0].tolist() == list(range(8))
    assert not bool(want["keep"].all())                # capacity drops


def test_degraded_param_reload_on_card_is_bit_equal(cuda):
    """Parameters put into a card store and served; a node lost, the
    reload decodes on the card (gf_matmul launches) into leaves bit-equal
    to the healthy ones, and the tokens are identical."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement import tree_flatten
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.store import CodedObjectStore
    cfg = get_config("qwen3-4b").reduced()
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    store = CodedObjectStore(CodeSpec.make(4, P), n_nodes=10,
                             stripe_symbols=1 << 12)
    n0 = circulant_encode.launches
    store.put_pytree("params", params)
    assert circulant_encode.launches > n0
    eng = ServingEngine.from_coded_store(model, store, key="params",
                                         batch_size=2, max_len=40)
    prompts = rand((2, 24), cfg.vocab_size, 2)
    healthy = eng.generate(prompts, 12)
    store.fail_node(3)
    n0 = gf_matmul.launches
    eng.reload_params(store, key="params")
    assert gf_matmul.launches > n0
    for x, y in zip(tree_flatten(eng.params)[0], tree_flatten(params)[0]):
        assert x.device.type == "cuda" and torch.equal(x, y)
    np.testing.assert_array_equal(eng.generate(prompts, 12), healthy)
    store.close()


# ------------------------------------------------------------- training
@pytest.mark.parametrize("dtype,window", [(torch.float32, None),
                                          (torch.float32, 96),
                                          (torch.bfloat16, None)])
def test_flash_backward_on_card_matches_cpu(cuda, dtype, window):
    """The flash forward and backward on the card against the CPU plain
    path on the same inputs: the tolerances of tests/test_flash.py (2e-5
    output, 3e-4 grads; bf16 3e-2)."""
    from repro_torch.models.flash import FlashAttention, flash_attention
    tol = 3e-2 if dtype == torch.bfloat16 else None
    rng = np.random.default_rng(0)
    q, k, v = [torch.from_numpy((rng.standard_normal((2, 256, 4, 64)) * 0.5
                                 ).astype(np.float32)).to(dtype)
               for _ in range(3)]
    pos = torch.arange(256, dtype=torch.int32)[None].expand(2, 256)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        n_bwd = FlashAttention.backward_calls
        o = flash_attention(*leaves, pos.to(dev), pos.to(dev), True, window,
                            64)
        (o.float() ** 2).sum().backward()
        assert FlashAttention.backward_calls == n_bwd + 1
        outs.append([o.detach().float().cpu()]
                    + [x.grad.float().cpu() for x in leaves])
    for i, (got, want) in enumerate(zip(*outs)):
        t = tol or (2e-5 if i == 0 else 3e-4)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=t, atol=t)


def test_train_step_on_card_matches_cpu(cuda):
    """Loss and grads of the train step on a reduced qwen3-4b, the flash
    path forced: card against CPU within the CPU parity tests' tolerances
    (loss 1e-2 absolute, each grad leaf 3e-2 relative L2)."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement import tree_flatten
    from repro_torch.launch.steps import accumulate_grads
    from repro_torch.models import Model, numpy_params, params_from_numpy
    from repro_torch.models import attention as attn_mod
    cfg = get_config("qwen3-4b").reduced(n_layers=2, loss_chunk=16)
    tree = numpy_params(cfg, 0)
    tok = rand((2, 33), cfg.vocab_size, 4)
    res = []
    old = attn_mod.FLASH_MIN_ELEMS
    attn_mod.FLASH_MIN_ELEMS = 1
    try:
        for dev in (cuda, torch.device("cpu")):
            b = {"tokens": torch.from_numpy(tok[:, :-1].copy()).to(dev),
                 "labels": torch.from_numpy(tok[:, 1:].copy()).to(dev)}
            loss, _, g = accumulate_grads(
                Model(cfg), params_from_numpy(tree, dev), b)
            res.append((float(loss), [x.cpu() for x in tree_flatten(g)[0]]))
    finally:
        attn_mod.FLASH_MIN_ELEMS = old
    (lc, gc), (lh, gh) = res
    assert abs(lc - lh) <= 1e-2
    for a, b in zip(gc, gh):
        assert float((a - b).norm() / b.norm()) <= 3e-2


def test_tiny_train_is_bit_deterministic_on_card(cuda):
    """Three steps of the tiny preset, twice from the same seed: every
    leaf of the two final states bit-equal (the determinism the crash
    drill's bit-exact resume rests on)."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement import tree_flatten
    from repro_torch.train import TrainConfig, train
    from repro_torch.train.tiny_lm import PRESETS
    preset = PRESETS["tiny"]
    cfg = get_config("paper-tiny-lm").reduced(**preset["model"])
    tcfg = TrainConfig(n_steps=3, global_batch=preset["batch"],
                       seq_len=preset["seq"], seed=0)
    states = [train(cfg, tcfg, log=lambda *_: None)[0] for _ in range(2)]
    la, ta = tree_flatten(states[0])
    lb, tb = tree_flatten(states[1])
    assert ta == tb and la[0].device.type == "cuda"
    assert all(torch.equal(a, b) for a, b in zip(la, lb))


# ----------------------------------------------- row pitch and the mesh
def home(cuda):
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("lo,width", [(0, 4096), (4, 1000), (3, 1001),
                                      (8, 2)])
def test_kernels_read_and_write_windows_in_place(cuda, lo, width):
    """The row pitch: each kernel on a column window of a larger operand,
    writing a column window of a larger output (aligned and misaligned
    starts, a ragged width), equal to its plain version, and nothing
    outside the window written."""
    big_s = lo + width + 7
    spec = CodeSpec.make(8, P)
    data = on(cuda, rand((16, big_s), P, lo))
    win = data[:, lo:lo + width]
    out = torch.full((16, big_s), -1, dtype=torch.int32, device=cuda)
    n0 = circulant_encode.launches
    circulant_encode(win, spec.c, P, out=out[:, lo:lo + width])
    assert circulant_encode.launches == n0 + 1
    assert torch.equal(out[:, lo:lo + width],
                       ref.circulant_encode_ref(win, spec.c, P))
    assert int(out[:, :lo].ne(-1).sum() + out[:, lo + width:].ne(-1).sum()) \
        == 0
    a = on(cuda, rand((2, 9), P, 1))
    r_prev = on(cuda, rand((big_s,), P, 2))[lo:lo + width].unsqueeze(0)
    srcs = (r_prev, win[:8])
    out = torch.full((2, big_s), -1, dtype=torch.int32, device=cuda)
    gf_matmul(a, srcs, P, out=out[:, lo:lo + width])
    assert torch.equal(out[:, lo:lo + width], ref.gf_matmul_ref(a, srcs, P))
    assert int(out[:, :lo].ne(-1).sum() + out[:, lo + width:].ne(-1).sum()) \
        == 0
    nd = on(cuda, rand((4, 8, big_s), P, 3))[..., lo:lo + width]
    rp = on(cuda, rand((4, big_s), P, 4))[:, lo:lo + width].unsqueeze(-2)
    out = torch.full((4, 2, big_s), -1, dtype=torch.int32, device=cuda)
    gf_matmul(a, (rp, nd), P, out=out[..., lo:lo + width])
    assert torch.equal(out[..., lo:lo + width],
                       ref.gf_matmul_ref(a, (rp, nd), P))
    torch.cuda.synchronize()


@pytest.mark.parametrize("m", [2, 4, 8])
def test_meshed_planner_on_card_matches_unsharded(cuda, m):
    """Every planned op over a mesh of m shards on one card (numpy staged
    per shard; card tensors read in place through the pitch), equal to
    the unsharded planner, one launch per non-empty shard — ragged and
    empty last shards included."""
    from repro_torch.sharding.mesh import StreamMesh
    mesh = StreamMesh(m, devices=[home(cuda)] * m)
    be = dispatch.get("cuda")
    plain = tplan.get_planner(be, P)
    pl = tplan.get_planner(be, P, mesh=mesh)
    assert pl is not plain and pl.mesh.size == m
    assert tplan.get_planner(be, P, mesh=StreamMesh(1, devices=[home(cuda)])) \
        is plain
    spec = CodeSpec.make(8, P)
    from repro_torch.core.repair import build_repair_matrix
    rmat = build_repair_matrix(spec).astype(np.int32)
    mat = rand((16, 16), P, 0)
    for s in (4099, 4096, 5, m - 1):
        shards = sum(hi > lo for lo, hi in mesh.windows(s))
        data = rand((16, s), P, s)
        rps, nds = rand((4, s), P, s + 1), rand((4, 8, s), P, s + 2)
        for x in (data, on(cuda, data)):
            n0 = circulant_encode.launches
            got = pl.circulant_encode(x, spec.c).host()
            assert circulant_encode.launches == n0 + shards
            np.testing.assert_array_equal(
                got, plain.circulant_encode(data, spec.c).host())
        for fn in (lambda q: q.matmul(mat, on(cuda, data)),
                   lambda q: q.regenerate(rmat, on(cuda, rps[0]),
                                          on(cuda, nds[0])),
                   lambda q: q.regenerate_batch(rmat, rps, nds),
                   lambda q: q.matmul_batch(rand((4, 2, 8), P, 5), nds)):
            n0 = gf_matmul.launches
            got = fn(pl).host()
            assert gf_matmul.launches == n0 + shards
            np.testing.assert_array_equal(got, fn(plain).host())
    torch.cuda.synchronize()


@pytest.mark.parametrize("first", ["cuda", "cpu"])
def test_mixed_host_and_card_mesh_matches_unsharded(cuda, first):
    """A mesh whose shards alternate between the card and the host, the
    card first or the host first: every shard away from the result's
    device gets its operands copied to it and its result copied back,
    replicas are made per device, and the staging buffers are released
    only after every device's event.  Every planned op, with host numpy,
    card and host tensor operands, equals the unsharded planner; the
    kernels launch once per non-empty card shard (the host shards run the
    plain versions).  The ring encode and int8_ring_mean over the same
    alternation equal their one-device runs."""
    from repro_torch.core.repair import build_repair_matrix
    from repro_torch.core.ring import ring_encode
    from repro_torch.launch.mesh import make_host_mesh, make_storage_mesh
    from repro_torch.optim.compression import int8_ring_mean
    from repro_torch.sharding.mesh import StreamMesh
    card, host = home(cuda), torch.device("cpu")
    pair = [card, host] if first == "cuda" else [host, card]
    mesh = StreamMesh(4, devices=pair * 2)
    be = dispatch.get("cuda")
    plain = tplan.get_planner(be, P)
    pl = tplan.get_planner(be, P, mesh=mesh)
    assert pl.device == pair[0] and pl.mesh.size == 4
    spec = CodeSpec.make(8, P)
    rmat = build_repair_matrix(spec).astype(np.int32)
    mat = rand((16, 16), P, 0)
    for s in (4099, 6, 3):
        on_card = sum(hi > lo and d == card for d, (lo, hi)
                      in zip(mesh.devices, mesh.windows(s)))
        data = rand((16, s), P, s)
        rps, nds = rand((4, s), P, s + 1), rand((4, 8, s), P, s + 2)
        mats = rand((4, 2, 8), P, 5)
        for where in ("numpy", card, host):
            def x(a):
                return a if where == "numpy" else on(where, a)
            n0 = circulant_encode.launches
            got = pl.circulant_encode(x(data), spec.c).host()
            assert circulant_encode.launches == n0 + on_card
            np.testing.assert_array_equal(
                got, plain.circulant_encode(data, spec.c).host())
            for fn in (lambda q: q.matmul(mat, x(data)),
                       lambda q: q.matmul(mat[:, :9], (x(rps[:1]),
                                                       x(data[:8]))),
                       lambda q: q.regenerate(rmat, x(rps[0]), x(nds[0])),
                       lambda q: q.regenerate_batch(rmat, x(rps), x(nds)),
                       lambda q: q.matmul_batch(mats, x(nds))):
                n0 = gf_matmul.launches
                res = fn(pl)
                assert res.raw.device == pair[0]
                got = res.host()
                assert gf_matmul.launches == n0 + on_card
                np.testing.assert_array_equal(got, fn(plain).host())
    assert pl.staging.stats().in_use == 0
    ring = make_storage_mesh(16, devices=pair * 8)
    data = on(card, rand((16, 1001), 256, 1))
    want = circulant_encode(data, spec.c, P)
    for byte_wire in (False, True):
        got = ring_encode(data, spec, ring, byte_wire=byte_wire)
        assert got.device == pair[0] and torch.equal(got.to(card), want)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 333, 7)).astype(np.float32))
    got = int8_ring_mean(x.to(card), make_host_mesh(devices=pair * 2),
                         "data")
    want = int8_ring_mean(x, make_host_mesh(devices=[host] * 4), "data")
    assert got.device == pair[0] and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m", [1, 4])
def test_meshed_caller_staged_buffer_is_dmad_as_it_lies(cuda, m):
    """Under a mesh on one card a caller-staged pool buffer is DMA'd once,
    as it lies, and each shard reads its window of it on the card: no
    second host copy, and the buffer stays the caller's."""
    from repro_torch.sharding.mesh import StreamMesh
    pl = tplan.get_planner(dispatch.get("cuda"), P, bucket_min=32,
                           mesh=StreamMesh(m, devices=[home(cuda)] * m))
    _, pad = pl.stream_pad(1001)
    buf = pl.staging.acquire((8, pad), np.int32)
    buf[...] = rand((8, pad), P, 4)
    mat = rand((3, 8), P, 5)
    n0, st0 = pl.staged_in_place, pl.staging.stats()
    n1 = gf_matmul.launches
    out = pl.matmul(mat, buf).host()
    st1 = pl.staging.stats()
    assert pl.staged_in_place == n0 + 1 and gf_matmul.launches == n1 + m
    assert (st1.hits, st1.misses, st1.in_use) == (st0.hits, st0.misses,
                                                  st0.in_use)
    np.testing.assert_array_equal(
        out, (mat.astype(np.int64) @ buf.astype(np.int64)) % P)
    pl.staging.release(buf)


def test_ring_encode_and_int8_ring_mean_on_card(cuda):
    """The ring encode over 16 nodes on one card equals the circulant
    encode kernel on both wires; int8_ring_mean on the card equals its
    run on the CPU bit for bit."""
    from repro_torch.core.ring import LinkTraffic, ring_encode
    from repro_torch.launch.mesh import make_host_mesh, make_storage_mesh
    from repro_torch.optim.compression import int8_ring_mean
    spec = CodeSpec.make(8, P)
    mesh = make_storage_mesh(16, devices=[home(cuda)] * 16)
    data = on(cuda, rand((16, 5003), 256, 1))
    want = circulant_encode(data, spec.c, P)
    for byte_wire in (False, True):
        traffic = LinkTraffic()
        got = ring_encode(data, spec, mesh, byte_wire=byte_wire,
                          traffic=traffic)
        assert got.device == home(cuda) and torch.equal(got, want)
        assert set(traffic.blocks.values()) == {8}
        assert set(traffic.bytes.values()) == {
            8 * 5003 * (1 if byte_wire else 4)}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 333, 7)).astype(np.float32))
    got = int8_ring_mean(x.to(cuda), make_host_mesh(
        devices=[home(cuda)] * 4), "data")
    want = int8_ring_mean(x, make_host_mesh(devices=["cpu"] * 4), "data")
    assert torch.equal(got.cpu(), want)


# ------------------------------------------- the (data, model) mesh
def test_sharded_train_step_and_decode_on_card(cuda):
    """A reduced qwen3-4b on a (data=2, model=2) mesh over ``[cuda:0] * 4``
    (each position a card where the host has four): the sharded train
    step's loss and grads within the CPU parity tests' tolerances (loss
    1e-2, grads 3e-2 relative L2) of the unsharded step on the card,
    and the sharded prefill and decode logits within 0.125 of the
    unsharded ones."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement import tree_flatten
    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.launch.steps import (accumulate_grads,
                                          make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import Model, numpy_params, params_from_numpy
    from repro_torch.sharding import place, policy
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(4)] if n >= 4
            else [home(cuda)] * 4)
    mesh = checked_mesh((2, 2), ("data", "model"), devs)
    cfg = get_config("qwen3-4b").reduced(n_layers=2, loss_chunk=16)
    model = Model(cfg)
    params = params_from_numpy(numpy_params(cfg, 0), cuda)
    sp = place.place(params, policy.named(policy.param_specs(params, mesh),
                                          mesh))
    tok = torch.from_numpy(rand((4, 33), cfg.vocab_size, 4)).to(cuda)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    sb = place.place(batch, policy.named(
        policy.batch_spec(batch, mesh, global_batch=4), mesh))
    l0, _, g0 = accumulate_grads(model, params, batch, 2)
    l1, _, g1 = accumulate_grads(model, sp, sb, 2)
    assert abs(float(l0) - float(l1)) <= 1e-2
    for a, b in zip(tree_flatten(place.gather(g1))[0], tree_flatten(g0)[0]):
        assert a.device == b.device
        assert float((a - b).norm() / b.norm()) <= 3e-2
    prefill = make_prefill_step(model, max_len=36, q_chunk=None)
    decode = make_decode_step(model, max_len=36)
    prompt = {"tokens": batch["tokens"]}
    (w, wc), (g, gc) = prefill(params, prompt), prefill(sp, prompt)
    nxt = w.argmax(-1).int()
    for t in range(3):
        assert float((g.gather() - w).abs().max()) <= 0.125
        w, wc = decode(params, wc, nxt, 32 + t)
        g, gc = decode(sp, gc, nxt, 32 + t)
        nxt = w.argmax(-1).int()
    assert float((g.gather() - w).abs().max()) <= 0.125
    torch.cuda.synchronize()


def test_mixed_host_and_card_model_mesh_matches_unsharded(cuda):
    """A (data=2, model=2) mesh whose positions alternate between the
    card and the host, so every collective crosses devices: the TP
    partial sums and broadcasts, the FSDP and vocab gathers, and the
    all-reduce of the embedding's and head's copies (replicated over
    data, on two devices).  The train step's loss and grads, the next
    state, and prefill / decode logits against the unsharded steps on
    the card, within the CPU parity tests' tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement import tree_flatten
    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.launch.steps import (accumulate_grads,
                                          make_decode_step,
                                          make_prefill_step,
                                          make_train_step)
    from repro_torch.models import Model, numpy_params, params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.sharding import place, policy
    card, host = home(cuda), torch.device("cpu")
    mesh = checked_mesh((2, 2), ("data", "model"), [card, host, host, card])
    cfg = get_config("qwen3-4b").reduced(n_layers=2, loss_chunk=16)
    model = Model(cfg)
    params = params_from_numpy(numpy_params(cfg, 1), card)
    opt = adamw.AdamWConfig(lr=1e-3)
    ps = policy.param_specs(params, mesh)
    state = place.place({"params": params, "opt": adamw.init(params, opt)},
                        policy.named({"params": ps,
                                      "opt": policy.opt_specs(ps)}, mesh))
    emb = state["params"]["embed"]
    assert {t.device.type for t in emb.unique()} == {"cuda", "cpu"}
    tok = torch.from_numpy(rand((4, 33), cfg.vocab_size, 6)).to(card)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    sb = place.place(batch, policy.named(
        policy.batch_spec(batch, mesh, global_batch=4), mesh))
    l0, _, g0 = accumulate_grads(model, params, batch, 2)
    l1, _, g1 = accumulate_grads(model, state["params"], sb, 2)
    assert abs(float(l0) - float(l1)) <= 1e-2
    for a, b in zip(tree_flatten(place.gather(g1, card))[0],
                    tree_flatten(g0)[0]):
        assert float((a - b).norm() / b.norm()) <= 3e-2
    g1e = g1["embed"]
    for hs in g1e.holders().values():       # copies all-reduced
        ts = [t for _, t in hs]
        assert all(torch.equal(t.cpu(), ts[0].cpu()) for t in ts)
    step = make_train_step(model, opt, 2)
    s0, _ = step({"params": params, "opt": adamw.init(params, opt)}, batch)
    s1, _ = step(state, sb)
    for a, b in zip(tree_flatten(place.gather(s1, card))[0],
                    tree_flatten(s0)[0]):
        assert float((a.float() - b.float()).abs().max()) <= 1e-2
    prefill = make_prefill_step(model, max_len=36, q_chunk=None)
    decode = make_decode_step(model, max_len=36)
    sp = state["params"]
    (w, wc), (g, gc) = (prefill(params, {"tokens": batch["tokens"]}),
                        prefill(sp, {"tokens": batch["tokens"]}))
    nxt = w.argmax(-1).int()
    for t in range(3):
        assert float((g.gather(card) - w).abs().max()) <= 0.125
        w, wc = decode(params, wc, nxt, 32 + t)
        g, gc = decode(sp, gc, nxt, 32 + t)
        nxt = w.argmax(-1).int()
    assert float((g.gather(card) - w).abs().max()) <= 0.125
    torch.cuda.synchronize()
