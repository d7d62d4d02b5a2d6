"""Port parity — execution layer.

repro_torch.exec.plan against repro.exec.plan: the same bucket ladder,
the same `.host()` results for every planned op at odd and even stream
extents, and the same hit / miss / compile accounting for the same
sequence of ops.  Plus the staging pool's acquire-until-release rule.
"""
import numpy as np
import pytest
import torch
from _torch_parity import rand

from repro.core.circulant import CodeSpec as RSpec
from repro.core.msr import DoubleCirculantMSR as RMSR
from repro.exec import plan as rplan
from repro.kernels import dispatch as rdispatch
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.exec import plan as tplan
from repro_torch.exec import staging as tstaging
from repro_torch.kernels import dispatch

P = 257
SPEC = CodeSpec.make(4, P)
RSPEC = RSpec.make(4, P)


def planners(bucket_min=32):
    """Fresh, unshared planners of both packages (zeroed stats)."""
    return (rplan.PlanCache(rdispatch.get("jnp-int32"), P,
                            bucket_min=bucket_min),
            tplan.PlanCache(dispatch.get("torch-int32"), P,
                            bucket_min=bucket_min, device="cpu"))


# ------------------------------------------------------------ bucket ladder
@pytest.mark.parametrize("bucket_min,ratio", [(4096, 2.0), (64, 2.0),
                                              (32, 1.5), (1, 3.0)])
def test_bucket_ladder_matches(bucket_min, ratio):
    for s in list(range(1, 300)) + [4095, 4096, 4097, 12345, 1 << 20,
                                    (1 << 20) + 1, 1 << 26]:
        assert tplan.bucket_symbols(s, bucket_min=bucket_min, ratio=ratio) \
            == rplan.bucket_symbols(s, bucket_min=bucket_min, ratio=ratio)


def test_bucket_ladder_defaults_and_invalid():
    assert (tplan.BUCKET_MIN, tplan.BUCKET_RATIO, tplan.BATCH_BUCKET_MIN) == \
        (rplan.BUCKET_MIN, rplan.BUCKET_RATIO, rplan.BATCH_BUCKET_MIN)
    assert tplan.bucket_symbols(1000) == 4096
    assert tplan.bucket_symbols(4097) == 8192
    with pytest.raises(ValueError):
        tplan.bucket_symbols(0)
    with pytest.raises(ValueError):
        tplan.bucket_symbols(10, ratio=1.0)


# ------------------------------------------------------ planned op parity
@pytest.mark.parametrize("s", [1, 31, 32, 33, 100])
def test_planned_matmul_host_matches(s):
    rp, tp = planners()
    mat = rand((6, 8), P, s)
    blocks = rand((8, s), P, s + 1)
    want = rp.matmul(mat, blocks).host()
    got = tp.matmul(mat, blocks).host()
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [3, 32, 57, 64])
def test_planned_circulant_host_matches(s):
    rp, tp = planners()
    data = rand((SPEC.n, s), P, s)
    np.testing.assert_array_equal(
        tp.circulant_encode(data, SPEC.c).host(),
        rp.circulant_encode(data, RSPEC.c).host())


@pytest.mark.parametrize("s", [9, 40])
def test_planned_regenerate_and_batch_host_match(s):
    rp, tp = planners()
    code = RMSR(RSPEC)
    data = rand((SPEC.n, s), P, s)
    red = np.asarray(code.encode(data))
    nodes = [2, 5, 7]
    r_prevs = np.stack([red[code.repair_plan(i).prev_node - 1]
                        for i in nodes])
    helpers = np.stack([data[list(code.repair_plan(i).data_indices)]
                        for i in nodes])
    rmat = code.repair.repair_matrix()
    one = tp.regenerate(rmat, r_prevs[0], helpers[0]).host()
    np.testing.assert_array_equal(
        one, rp.regenerate(rmat, r_prevs[0], helpers[0]).host())
    np.testing.assert_array_equal(one, np.stack([data[1], red[1]]))
    batch = tp.regenerate_batch(rmat, r_prevs, helpers).host()
    want = rp.regenerate_batch(rmat, r_prevs, helpers).host()
    assert batch.shape == want.shape == (3, 2, s)
    np.testing.assert_array_equal(batch, want)


def test_same_ops_same_accounting():
    """One sequence of planned ops: identical (hits, misses, compiles)
    after every op, and identical per-family rows with tags."""
    rp, tp = planners(bucket_min=32)
    mat = np.eye(8, dtype=np.int32)
    rmat = RMSR(RSPEC).repair.repair_matrix()
    seq = []
    for s in (10, 20, 32, 33, 40, 10, 64, 65):
        seq.append(("matmul", s, None))
    seq += [("circ", 10, None), ("circ", 40, None), ("matmul", 12, "pm"),
            ("matmul", 12, "pm"), ("regen", 9, None), ("regen", 30, None),
            ("regen", 33, None), ("batch", 9, 3), ("batch", 9, 4),
            ("batch", 9, 5), ("batch", 40, 2)]
    for op, s, extra in seq:
        blocks = np.ones((8, s), np.int32)
        for pc, c in ((rp, RSPEC.c), (tp, SPEC.c)):
            if op == "matmul":
                pc.matmul(mat, blocks, tag=extra).host()
            elif op == "circ":
                pc.circulant_encode(blocks, c).host()
            elif op == "regen":
                pc.regenerate(rmat, blocks[0], blocks[:4]).host()
            else:
                pc.regenerate_batch(rmat, np.ones((extra, s), np.int32),
                                    np.ones((extra, 4, s), np.int32)).host()
        assert tuple(tp.plan_stats()) == tuple(rp.plan_stats()), (op, s)
    assert {k: tuple(v) for k, v in tp.plan_stats_by_family().items()} == \
        {k: tuple(v) for k, v in rp.plan_stats_by_family().items()}
    assert len(tp) == len(rp)
    tp.reset_stats()
    assert tuple(tp.plan_stats()) == (0, 0, 0)


def test_disabled_planning_bypasses_cache():
    _, tp = planners()
    mat, blocks = rand((4, 8), P, 0), rand((8, 21), P, 1)
    with tplan.planning_disabled():
        assert not tplan.planning_enabled()
        out = tp.matmul(mat, blocks)
        assert isinstance(out, tplan.PlanResult)
        np.testing.assert_array_equal(
            out.host(), (mat.astype(np.int64) @ blocks) % P)
    assert tplan.planning_enabled()
    assert tp.plan_stats() == (0, 0, 0)


def test_failed_first_launch_is_a_miss_not_a_compile():
    _, tp = planners()
    with pytest.raises(ValueError):
        tp.matmul(np.ones((2, 3), np.int32), np.ones((4, 40), np.int32))
    st = tp.plan_stats()
    assert (st.misses, st.compiles) == (1, 0)


def test_plan_result_trims_stream_and_batch():
    raw = np.arange(4 * 2 * 8).reshape(4, 2, 8)
    res = tplan.PlanResult(raw, symbols=5, batch=3)
    out = res.host()
    assert out.shape == (3, 2, 5)
    np.testing.assert_array_equal(out, raw[:3, :, :5])
    np.testing.assert_array_equal(np.asarray(res), out)
    traw = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    np.testing.assert_array_equal(tplan.PlanResult(traw, 8).host(),
                                  traw.numpy())


def test_registry_shares_per_backend_and_device():
    be = dispatch.get("torch-int32")
    a = tplan.get_planner(be, P, device="cpu")
    assert a is tplan.get_planner(be, P, device=torch.device("cpu"))
    assert a is not tplan.get_planner(dispatch.get("cuda"), P, device="cpu")
    assert tplan.plan_stats().compiles >= a.plan_stats().compiles
    # a mesh of 2 (on ["cpu"] * 2) is a planner of its own whose results
    # equal the unsharded one's; a 1-shard mesh is the unsharded planner
    from repro_torch.sharding.mesh import StreamMesh
    cpus = lambda m: StreamMesh(m, devices=["cpu"] * m)  # noqa: E731
    m2 = tplan.get_planner(be, P, mesh=cpus(2), device="cpu")
    assert m2 is not a and m2.mesh.size == 2
    assert m2 is tplan.get_planner(be, P, mesh=cpus(2))
    mat, data = rand((3, 8), P, 1), rand((8, 1001), P, 2)
    np.testing.assert_array_equal(m2.matmul(mat, data).host(),
                                  a.matmul(mat, data).host())
    assert tplan.get_planner(be, P, mesh=cpus(1), device="cpu") is a
    code = DoubleCirculantMSR(SPEC, mesh=cpus(4), device="cpu")
    assert code.planner.mesh.size == 4
    np.testing.assert_array_equal(
        code.encode_planned(data).host(),
        DoubleCirculantMSR(SPEC, device="cpu").encode_planned(data).host())


def test_code_planned_paths_match_reference():
    code = DoubleCirculantMSR(SPEC, device="cpu")
    rcode = RMSR(RSPEC)
    data = rand((SPEC.n, 77), P, 5)
    np.testing.assert_array_equal(code.encode_planned(data).host(),
                                  rcode.encode_planned(data).host())
    red = np.asarray(rcode.encode(data))
    nodes = [1, 8]
    r_prevs = np.stack([red[rcode.repair_plan(i).prev_node - 1]
                        for i in nodes])
    helpers = np.stack([data[list(rcode.repair_plan(i).data_indices)]
                        for i in nodes])
    np.testing.assert_array_equal(
        code.repair.regenerate_batch_planned(nodes, r_prevs, helpers).host(),
        rcode.repair.regenerate_batch_planned(nodes, r_prevs, helpers).host())
    np.testing.assert_array_equal(
        code.repair.regenerate_planned(1, r_prevs[0], helpers[0]).host(),
        rcode.repair.regenerate_planned(1, r_prevs[0], helpers[0]).host())
    use = [2, 3, 5, 7]
    dl = np.concatenate([data[[i - 1 for i in use]], red[[i - 1 for i in use]]])
    mat = rcode.repair.decode_matrix(use)
    np.testing.assert_array_equal(code.repair.apply_planned(mat, dl).host(),
                                  data)
    with tplan.planning_disabled():           # eager fallback, same answers
        np.testing.assert_array_equal(code.encode_planned(data).host(), red)


def test_planned_validation_errors():
    code = DoubleCirculantMSR(SPEC, device="cpu")
    with pytest.raises(ValueError, match="helper"):
        code.repair.regenerate_planned(1, np.ones(8, np.int32),
                                       np.ones((SPEC.k + 1, 8), np.int32))
    with pytest.raises(ValueError, match="blocks"):
        code.encode_planned(np.ones((SPEC.n - 1, 8), np.int32))
    with pytest.raises(ValueError, match="helper shapes"):
        code.repair.regenerate_batch_planned(
            [1, 2], np.ones((3, 8), np.int32),
            np.ones((2, SPEC.k, 8), np.int32))


# ---------------------------------------------------------------- staging
def test_pool_acquire_until_release():
    pool = tstaging.StagingPool()
    a = pool.acquire((3, 100), np.int32)
    b = pool.acquire((3, 100), np.int32)
    assert a.shape == (3, 100) and a.dtype == np.int32
    assert not np.shares_memory(a, b)        # never reissued while held
    st = pool.stats()
    assert (st.hits, st.misses, st.in_use) == (0, 2, 2)
    pool.release(a)
    c = pool.acquire((2, 50), np.int32)       # same ladder slot: reused
    assert np.shares_memory(a, c)
    assert pool.stats().hits == 1
    pool.release(b)
    pool.release(b)                           # double release: no-op
    pool.release(np.zeros(4, np.int32))       # foreign: no-op
    pool.release(c)
    st = pool.stats()
    assert (st.released, st.in_use) == (3, 0) and st.pooled_bytes > 0
    d = pool.acquire((10_000,), np.uint8)     # other dtype, other slot
    assert d.dtype == np.uint8 and pool.stats().misses == 3
    pool.clear()
    assert pool.stats() == (0, 0, 0, 0, 0)


def test_pool_bucket_ladder_matches_reference():
    from repro.exec import staging as rstaging
    assert tstaging.POOL_BUCKET_MIN == rstaging.POOL_BUCKET_MIN
    # every stage the reference names but its dead t_pad
    assert set(rstaging.STAGE_NAMES) - {"t_pad"} <= \
        set(tstaging.STAGE_NAMES) and "t_pad" not in tstaging.STAGE_NAMES
    for e in (1, 4096, 4097, 10**6):
        assert tstaging._bucket_elems(e) == rstaging._bucket_elems(e)


def test_stage_clock():
    tstaging.reset_stage_times()
    with tstaging.staged("h2d"):
        pass
    tstaging.record_stage("h2d", 0.5)
    assert tstaging.stage_calls() == {"h2d": 2}
    assert tstaging.stage_times()["h2d"] >= 0.5
    tstaging.reset_stage_times()
    assert tstaging.stage_times() == {}
