"""Port parity — the overlapped pipeline and the planner's batched ops.

repro_torch.exec.pipeline against the semantics of repro.exec.pipeline
(order, depth bound, read prefetch, submit/barrier/close, errors), and
PlanCache.matmul_batch / stream_pad against repro.exec.plan: the same
``.host()`` results at odd and even stream extents and batch sizes off
the batch ladder, the same plan keys and accounting.  Tolerance zero.
"""
import threading

import numpy as np
import pytest
import torch
from _torch_parity import rand

from repro.exec import plan as rplan
from repro.exec.pipeline import Pipeline as RPipeline
from repro.kernels import dispatch as rdispatch
from repro_torch.exec import Pipeline
from repro_torch.exec import plan as tplan
from repro_torch.exec import staging as tstaging
from repro_torch.kernels import dispatch

P = 257


def planners(bucket_min=32):
    return (rplan.PlanCache(rdispatch.get("jnp-int32"), P,
                            bucket_min=bucket_min),
            tplan.PlanCache(dispatch.get("torch-int32"), P,
                            bucket_min=bucket_min, device="cpu"))


# ----------------------------------------------------------------- pipeline
def _trace(cls, depth, n_items=6, read=True):
    """The event order one pipeline run produces (compute / consume /
    read), with the in-flight count at each consume."""
    events, inflight, peak = [], [0], [0]

    def compute(i, d=None):
        inflight[0] += 1
        peak[0] = max(peak[0], inflight[0])
        events.append(("c", i))
        return (i, d)

    def consume(i, r):
        inflight[0] -= 1
        events.append(("u", i, r))

    with cls(io_workers=2, depth=depth) as pipe:
        if read:
            pipe.map(range(n_items), compute, consume,
                     read=lambda i: i * 10)
        else:
            pipe.map(range(n_items), compute, consume)
    return events, peak[0]


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
@pytest.mark.parametrize("read", [False, True])
def test_map_order_and_depth_match_reference(depth, read):
    got, peak = _trace(Pipeline, depth, read=read)
    want, rpeak = _trace(RPipeline, depth, read=read)
    assert got == want
    assert peak == rpeak == min(depth, 6)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_tiles_in_order_and_complete(depth):
    out = np.empty(103, np.int64)
    order = []
    with Pipeline(io_workers=2, depth=depth) as pipe:
        pipe.stream_tiles(
            103, 10,
            lambda sl: np.arange(sl.start, sl.stop),
            lambda sl, r: (order.append(sl.start), out.__setitem__(sl, r)))
    np.testing.assert_array_equal(out, np.arange(103))
    assert order == list(range(0, 103, 10))


def test_depth_one_is_serial_and_reads_inline():
    events, main = [], threading.get_ident()
    with Pipeline(io_workers=1, depth=1) as pipe:
        pipe.map([0, 1, 2], lambda i, d: events.append(("c", i, d)),
                 lambda i, r: events.append(("u", i)),
                 read=lambda i: threading.get_ident() == main)
    assert events == [("c", 0, True), ("u", 0), ("c", 1, True), ("u", 1),
                      ("c", 2, True), ("u", 2)]


def test_submit_barrier_close_and_reuse():
    pipe = Pipeline(io_workers=1)
    fut = pipe.submit(lambda: 42)
    pipe.barrier()
    assert fut.result() == 42
    pipe.close()
    assert pipe.submit(lambda: 1).result() == 1     # fresh pool spins up
    pipe.close()
    assert Pipeline(io_workers=0, depth=0).io_workers == 1
    assert Pipeline(io_workers=0, depth=0).depth == 1


@pytest.mark.parametrize("where", ["read", "compute", "consume", "submit"])
def test_errors_surface(where):
    def boom(*_a):
        raise OSError(f"disk on fire in {where}")

    ok = lambda *a: None                           # noqa: E731
    with pytest.raises(OSError, match=where):
        with Pipeline(io_workers=2, depth=2) as pipe:
            if where == "submit":
                pipe.submit(boom)
            else:
                pipe.map(range(4),
                         boom if where == "compute" else ok,
                         lambda i, r: (boom() if where == "consume"
                                       else pipe.submit(ok)),
                         read=boom if where == "read" else ok)
    assert pipe._ex is None                        # threads never leak


def test_stage_stats_rebase_and_keys():
    pipe = Pipeline(io_workers=1, depth=2)
    tstaging.record_stage("pack", 1.0)
    pipe.reset_stage_stats()
    tstaging.record_stage("pack", 0.25)
    pipe.map(range(3), lambda i, d: d, lambda i, r: None,
             read=lambda i: i)
    st = pipe.stage_stats()
    assert set(st) == set(tstaging.STAGE_NAMES) == \
        set(RPipeline().stage_stats())
    assert st["t_pack"] == pytest.approx(0.25) and st["t_pad"] == 0.0
    assert st["t_dispatch"] >= 0 and st["t_consume"] >= 0
    pipe.close()


# ------------------------------------------------------- planner: batches
@pytest.mark.parametrize("f,q,d,s", [(1, 7, 14, 33), (3, 2, 3, 64),
                                     (5, 3, 5, 31), (6, 4, 6, 32),
                                     (9, 1, 2, 100)])
def test_matmul_batch_host_matches(f, q, d, s):
    rp, tp = planners()
    mats = rand((f, q, d), P, f + s)
    blocks = rand((f, d, s), P, f * s)
    want = rp.matmul_batch(mats, blocks).host()
    got = tp.matmul_batch(mats, blocks).host()
    assert got.shape == want.shape == (f, q, s)
    np.testing.assert_array_equal(got, want)
    with tplan.planning_disabled(), rplan.planning_disabled():
        np.testing.assert_array_equal(tp.matmul_batch(mats, blocks).host(),
                                      rp.matmul_batch(mats, blocks).host())


def test_matmul_batch_accounting_and_tags_match():
    rp, tp = planners()
    for f, s, tag in ((1, 9, None), (3, 9, None), (5, 9, "pm"),
                      (4, 40, "pm"), (8, 40, "pm"), (9, 40, None),
                      (2, 33, "pm")):
        mats, blocks = rand((f, 3, 5), P, f), rand((f, 5, s), P, s)
        for pc in (rp, tp):
            pc.matmul_batch(mats, blocks, tag=tag).host()
        assert tuple(tp.plan_stats()) == tuple(rp.plan_stats()), (f, s)
    assert {k: tuple(v) for k, v in tp.plan_stats_by_family().items()} == \
        {k: tuple(v) for k, v in rp.plan_stats_by_family().items()}
    assert len(tp) == len(rp)


def test_matmul_batch_validation():
    _, tp = planners()
    for mats, blocks in (((2, 3, 4), (3, 4, 8)), ((2, 3, 4), (2, 5, 8)),
                         ((3, 4), (2, 4, 8)), ((2, 3, 4), (4, 8))):
        with pytest.raises(ValueError, match="matmul_batch"):
            tp.matmul_batch(np.ones(mats, np.int32),
                            np.ones(blocks, np.int32))


@pytest.mark.parametrize("s", [1, 31, 32, 33, 4096, 4097, 100_000])
def test_stream_pad_keys_match_exact_extent(s):
    rp, tp = planners()
    rb, rpad = rp.stream_pad(s)
    tb, tpad = tp.stream_pad(s)
    assert tb == rb == rpad       # the same plan-key bucket
    assert tpad == s              # ... but an exact staging extent


def test_caller_staged_buffer_used_in_place_on_cpu():
    """On the CPU planner a caller-staged pool buffer is read where it
    lies: the result equals the reference, the pool is not touched and
    the buffer stays the caller's."""
    rp, tp = planners()
    s = 45
    _, pad = tp.stream_pad(s)
    buf = tp.staging.acquire((8, pad), np.int32)
    buf[...] = rand((8, s), P, 3)
    st0 = tp.staging.stats()
    mat = rand((5, 8), P, 4)
    got = tp.matmul(mat, buf).host()
    assert tp.staging.holds(buf) and tp.staging.stats() == st0
    np.testing.assert_array_equal(got, rp.matmul(mat, buf.copy()).host())
    tp.staging.release(buf)
    assert not tp.staging.holds(buf)
    assert not tp.staging.holds(np.zeros(3, np.int32))
    assert not tp.staging.holds(torch.zeros(3))
