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
