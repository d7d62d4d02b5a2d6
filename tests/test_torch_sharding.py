"""Port parity — the stream-axis mesh layer (mirrors tests/test_sharding.py).

The guarantee: sharding over a StreamMesh changes WHERE the columns
compute, never WHAT they are.  The reference's own sharded path fails on
the installed jax (``shard_map(check_rep=...)``), and its design defines
a sharded result as bit-identical to the unsharded one, so the port's
meshed planner, store and checkpointer are held here against the
reference's UNSHARDED planner, store and checkpointer, bit for bit.

torch has no ``--xla_force_host_platform_device_count``: a CPU mesh of m
shards is ``StreamMesh(m, devices=["cpu"] * m)`` (a device may repeat),
so every case runs in this process.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_parity import rand

from repro.core.circulant import CodeSpec as RSpec
from repro.exec import plan as rplan
from repro.kernels import dispatch as rdispatch
from repro.sharding import mesh as rmesh
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.exec import plan as tplan
from repro_torch.kernels import dispatch, ref
from repro_torch.launch import mesh as tlaunch
from repro_torch.sharding import mesh as tmesh
from repro_torch.sharding.mesh import MeshConfigError, StreamMesh, use_mesh

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

P = 257
SIZES = (1, 2, 4, 8)


def cpus(m: int) -> StreamMesh:
    return StreamMesh(m, devices=["cpu"] * m)


def cards() -> int:
    return torch.cuda.device_count()


# ===================================================== mesh construction
class TestStreamMeshValidation:
    def test_bad_sizes_raise_typed(self):
        for bad in (0, -1, True, 2.5, "4"):
            with pytest.raises(MeshConfigError):
                StreamMesh(bad, devices=["cpu"] * 4)

    def test_too_many_devices_names_the_fix(self):
        with pytest.raises(MeshConfigError) as ei:
            StreamMesh(999)
        msg = str(ei.value)
        assert "999" in msg and "devices=" in msg
        with pytest.raises(MeshConfigError, match="devices="):
            StreamMesh(5, devices=["cpu"] * 4)

    def test_mesh_config_error_is_value_error(self):
        assert issubclass(MeshConfigError, ValueError)

    def test_default_uses_all_devices(self):
        if cards() == 0:
            with pytest.raises(MeshConfigError, match="devices="):
                StreamMesh()
        else:
            assert StreamMesh().size == cards()
        assert StreamMesh(devices=["cpu"] * 3).size == 3

    def test_as_stream_mesh_coercion(self):
        assert tmesh.as_stream_mesh(None) is None
        m = cpus(1)
        assert tmesh.as_stream_mesh(m) is m
        if cards() == 0:                # an int mesh is over the cards
            with pytest.raises(MeshConfigError, match="devices="):
                tmesh.as_stream_mesh(1)
        else:
            assert isinstance(tmesh.as_stream_mesh(1), StreamMesh)
        with pytest.raises(MeshConfigError):
            tmesh.as_stream_mesh("stream")
        with pytest.raises(MeshConfigError):
            tmesh.as_stream_mesh(True)

    def test_shard_extent(self):
        m = cpus(1)
        assert m.shard_extent(7) == 7
        assert m.is_trivial

    def test_repeated_devices_key_and_windows(self):
        m = cpus(4)
        assert m.devices == (torch.device("cpu"),) * 4
        assert m.key() == ("stream", ("cpu",) * 4)
        assert m.key() != cpus(2).key()
        assert m.windows(10) == [(0, 3), (3, 6), (6, 9), (9, 10)]
        assert m.windows(3) == [(0, 1), (1, 2), (2, 3), (3, 3)]   # empty
        assert m.windows(0) == [(0, 0)] * 4

    def test_planner_device_follows_the_mesh(self):
        be = dispatch.get("torch-int32")
        m2 = cpus(2)
        pl = tplan.get_planner(be, P, mesh=m2)
        assert pl.device == torch.device("cpu")
        assert pl.mesh.key() == m2.key()
        assert tmesh.mesh_device(m2, None) == torch.device("cpu")
        with pytest.raises(MeshConfigError, match="first device"):
            tmesh.mesh_device(StreamMesh(2, devices=["cuda:0"] * 2)
                              if cards() else m2,
                              "cpu" if cards() else "meta")


class TestLaunchMeshValidation:
    """launch/mesh.py: typed construction errors, as the reference's."""

    def test_production_mesh_on_one_device_raises_typed(self):
        from repro.launch.mesh import make_production_mesh as rmake
        with pytest.raises(rmesh.MeshConfigError) as ref_err:
            rmake()
        with pytest.raises(MeshConfigError) as ei:
            tlaunch.make_production_mesh()
        assert "256" in str(ei.value) and "256" in str(ref_err.value)
        assert "devices=" in str(ei.value)
        with pytest.raises(MeshConfigError, match="512"):
            tlaunch.make_production_mesh(multi_pod=True,
                                         devices=["cpu"] * 256)
        mesh = tlaunch.make_production_mesh(devices=["cpu"] * 256)
        assert mesh.shape == {"data": 16, "model": 16}
        assert mesh.devices.shape == (16, 16)

    def test_storage_mesh_bad_sizes(self):
        for bad in (0, -3, True, 1.5):
            with pytest.raises(MeshConfigError):
                tlaunch.make_storage_mesh(bad, devices=["cpu"] * 4)

    def test_checked_mesh_shape_name_mismatch(self):
        with pytest.raises(MeshConfigError):
            tlaunch.checked_mesh((1, 1), ("data",), ["cpu"])
        with pytest.raises(MeshConfigError):
            tlaunch.checked_mesh((1, 1), ("data", "data"), ["cpu"])

    def test_host_mesh_matches_device_count(self):
        if cards() == 0:
            with pytest.raises(MeshConfigError, match="devices="):
                tlaunch.make_host_mesh()
        else:
            assert tlaunch.make_host_mesh().shape["data"] == cards()
        mesh = tlaunch.make_host_mesh(devices=["cpu"] * 3)
        assert mesh.shape == {"data": 3}
        assert tmesh.axis_devices(mesh, "data") == [torch.device("cpu")] * 3


# ======================================================== rule registry
class TestRuleRegistry:
    def test_all_planned_ops_registered(self):
        assert set(tmesh.known_rules()) >= {
            "matmul", "circulant_encode", "regenerate", "regenerate_batch",
            "matmul_batch"}

    def test_rule_arity_matches_op(self):
        for op, n_args in [("matmul", 2), ("circulant_encode", 1),
                           ("regenerate", 3), ("regenerate_batch", 3),
                           ("matmul_batch", 2)]:
            assert len(tmesh.get_rule(op).in_specs) == n_args, op

    def test_stream_axis_on_last_dim(self):
        for op in tmesh.known_rules():
            rule = tmesh.get_rule(op)
            assert tuple(rule.out_specs)[-1] == tmesh.STREAM_AXIS, op

    def test_rules_are_the_references(self):
        assert tmesh.known_rules() == rmesh.known_rules()
        assert tmesh.STREAM_AXIS == rmesh.STREAM_AXIS
        for op in rmesh.known_rules():
            r, t = rmesh.get_rule(op), tmesh.get_rule(op)
            assert t.in_specs == tuple(tuple(s) for s in r.in_specs), op
            assert t.out_specs == tuple(r.out_specs), op
            assert t.doc == r.doc, op

    def test_unknown_op_lists_known(self):
        with pytest.raises(KeyError) as ei:
            tmesh.get_rule("nope")
        assert "circulant_encode" in str(ei.value)

    def test_duplicate_registration_needs_override(self):
        orig = tmesh.get_rule("matmul")
        with pytest.raises(ValueError):
            tmesh.register_rule(tmesh.ShardingRule("matmul", (tmesh.P(),),
                                                   tmesh.P()))
        tmesh.register_rule(orig, override=True)      # idempotent restore
        assert tmesh.get_rule("matmul") is orig


# ============================================= 1-shard fallback identity
class TestSingleDeviceFallback:
    """A 1-shard mesh must resolve to the SAME planner object as no mesh:
    identical results, zero spurious compiles."""

    def test_trivial_mesh_normalizes_to_plain_planner(self):
        be = dispatch.get("torch-int32")
        plain = tplan.get_planner(be, P, device="cpu")
        assert plain is tplan.get_planner(be, P, mesh=cpus(1))
        assert plain is tplan.get_planner(be, P, mesh=cpus(1),
                                          device="cpu")
        assert plain.mesh is None

    @pytest.mark.parametrize("backend", ["torch-int32", "cuda"])
    def test_env_backend_with_trivial_mesh(self, backend, monkeypatch):
        monkeypatch.setenv(dispatch.ENV_VAR, backend)
        spec = CodeSpec.make(2, P)
        plain = DoubleCirculantMSR(spec, device="cpu")
        with use_mesh(cpus(1)):
            meshed = DoubleCirculantMSR(spec, device="cpu")
        assert plain.backend_name == meshed.backend_name == backend
        assert plain.planner is meshed.planner       # no second cache
        assert meshed.mesh.size == 1
        data = rand((4, 5000), P, 0)
        want = plain.encode_planned(data).host()
        meshed.planner.reset_stats()
        np.testing.assert_array_equal(meshed.encode_planned(data).host(),
                                      want)
        st_ = meshed.planner.plan_stats()
        assert st_.compiles == 0 and st_.misses == 0, st_  # pure cache hit


class TestAmbientMesh:
    def test_use_mesh_scopes_and_none_override(self):
        assert tmesh.current_mesh() is None
        m = cpus(1)
        with use_mesh(m):
            assert tmesh.current_mesh() is m
            with use_mesh(None):            # explicit disable
                assert tmesh.current_mesh() is None
            assert tmesh.current_mesh() is m
        assert tmesh.current_mesh() is None

    def test_int_coercion_in_scope(self):
        if cards() == 0:
            with pytest.raises(MeshConfigError):
                with use_mesh(1):
                    pass
        else:
            with use_mesh(1):
                assert tmesh.current_mesh().size == 1
        with use_mesh(cpus(2)):
            code = DoubleCirculantMSR(CodeSpec.make(2, P), device="cpu")
        assert code.mesh.size == 2
        assert code.planner.mesh.key() == code.mesh.key()


# ===================================== window/shard round trip (hyp)
@settings(max_examples=60, deadline=None)
@given(s=st.integers(min_value=0, max_value=5000),
       m=st.sampled_from([1, 2, 3, 4, 8]),
       bucket_min=st.sampled_from([4, 64, 4096]))
def test_pad_shard_roundtrip(s, m, bucket_min):
    """Per-shard windows and buckets, the port's form of the reference's
    pad -> split -> concat -> slice: the windows tile [0, s) in order,
    each at most shard_extent wide; the plan key's bucket covers a shard;
    and shard_body's split -> per-shard op -> assemble reproduces the
    input bit-exactly, ragged and empty last shards included."""
    mesh = cpus(m)
    wins = mesh.windows(s)
    assert wins[0][0] == 0 and wins[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(wins, wins[1:]))
    assert all(0 <= hi - lo <= mesh.shard_extent(s) for lo, hi in wins)
    if s:
        b = tplan.bucket_symbols(mesh.shard_extent(s), bucket_min=bucket_min)
        assert b >= mesh.shard_extent(s) and b * m >= s
    arr = torch.from_numpy(rand((3, s), P, s * 31 + m))
    calls = []

    def copy(x, out=None):
        calls.append(x.shape[-1])
        return x.clone() if out is None else out.copy_(x)

    out = torch.full((3, s), -1, dtype=torch.int32)
    tmesh.shard_body(copy, "circulant_encode", mesh)(arr, out=out)
    assert torch.equal(out, arr)
    assert calls == [hi - lo for lo, hi in wins if hi > lo]


@settings(max_examples=30, deadline=None)
@given(s=st.integers(min_value=1, max_value=100_000),
       m=st.sampled_from([2, 4, 8]))
def test_shard_bucket_ladder_membership(s, m):
    """Per-shard buckets stay on the reference's geometric ladder."""
    pl = tplan.get_planner(dispatch.get("torch-int32"), P, mesh=cpus(m))
    b, extent = pl.stream_pad(s)
    assert extent == s                      # exact: the kernels mask
    assert b == rplan.bucket_symbols(-(-s // m))
    j = 0
    while tplan.BUCKET_MIN * tplan.BUCKET_RATIO ** j < b:
        j += 1
    assert int(tplan.BUCKET_MIN * tplan.BUCKET_RATIO ** j) == b


# ========================= meshed planner vs the reference's unsharded
def _operands(s):
    rng = np.random.default_rng(s)
    r = lambda *shape: rng.integers(0, P, size=shape).astype(np.int32)  # noqa
    rmat = r(2, 5)
    rmat[1, 0] = 0          # as every repair matrix: R[1, 0] = 0
    return {"data": r(8, s), "mat": r(5, 8), "rmat": rmat, "rp": r(s),
            "nd": r(4, s), "rps": r(3, s), "nds": r(3, 4, s),
            "mats": r(3, 2, 4)}


def _ops(pl, x, c, torch_sources=False):
    head, tail = x["data"][:3], x["data"][3:]
    if torch_sources:                      # tensor operands, row sources
        head, tail = torch.from_numpy(head), torch.from_numpy(tail)
    out = [pl.circulant_encode(x["data"], c).host(),
           pl.matmul(x["mat"], x["data"]).host(),
           pl.regenerate(x["rmat"], x["rp"], x["nd"]).host(),
           pl.regenerate_batch(x["rmat"], x["rps"], x["nds"]).host(),
           pl.matmul_batch(x["mats"], x["nds"]).host()]
    if torch_sources:
        out.append(pl.matmul(x["mat"], (head, tail)).host())
    return out


_REF_OUT: dict = {}


def _reference(s):
    """The reference's unsharded planner on jnp-int32 (memoized)."""
    if s not in _REF_OUT:
        spec = RSpec.make(4, P)
        x = _operands(s)
        pl = rplan.get_planner(rdispatch.get("jnp-int32"), P, bucket_min=64)
        want = _ops(pl, x, tuple(int(v) for v in spec.c))
        want.append(np.asarray(pl.matmul(x["mat"], x["data"]).host()))
        _REF_OUT[s] = want
    return _REF_OUT[s]


@pytest.mark.parametrize("backend", ["torch-int32", "cuda"])
@pytest.mark.parametrize("m", SIZES)
def test_parity_across_mesh_sizes_all_ops(backend, m):
    """THE parity matrix: every planned op x backend x odd/even stream
    length, meshed over m CPU shards, bit-equal to the reference's
    unsharded planner."""
    be = dispatch.get(backend)
    c = tuple(int(v) for v in CodeSpec.make(4, P).c)
    plain = tplan.get_planner(be, P, bucket_min=64, device="cpu")
    pl = tplan.get_planner(be, P, bucket_min=64, mesh=cpus(m))
    assert (pl is plain) == (m == 1)
    for s in (513, 1024):
        got = _ops(pl, _operands(s), c, torch_sources=True)
        for i, (w, g) in enumerate(zip(_reference(s), got)):
            np.testing.assert_array_equal(
                np.asarray(w), g, err_msg=f"{backend} op{i} m={m} s={s}")


def _counting_backend(name):
    """A plain-torch backend that counts its calls (one per shard)."""
    calls = {"matmul": 0, "circulant_encode": 0}

    def mm(a, b, p, out=None):
        calls["matmul"] += 1
        return ref.gf_matmul_ref(a, b, p, out=out)

    def enc(data, c, p, out=None):
        calls["circulant_encode"] += 1
        return ref.circulant_encode_ref(data, c, p, out=out)

    return dispatch.GFBackend(name, mm, enc, dispatch.get("torch-int32").axpy
                              ), calls


@pytest.mark.parametrize("m", SIZES)
def test_one_call_per_nonempty_shard(m):
    be, calls = _counting_backend(f"counting-sharding-{m}")
    pl = tplan.get_planner(be, P, bucket_min=64, mesh=cpus(m))
    c = tuple(int(v) for v in CodeSpec.make(4, P).c)
    for s in (3, 513):                     # s = 3 < m leaves empty shards
        x = _operands(s)
        shards = sum(hi > lo for lo, hi in cpus(m).windows(s))
        pl.circulant_encode(x["data"], c).host()
        assert calls["circulant_encode"] == shards
        pl.regenerate(x["rmat"], x["rp"], x["nd"]).host()
        pl.regenerate_batch(x["rmat"], x["rps"], x["nds"]).host()
        pl.matmul(x["mat"], x["data"]).host()
        assert calls["matmul"] == 3 * shards
        calls.update(matmul=0, circulant_encode=0)


def test_sharded_plan_zero_steady_state_recompiles():
    """After warm-up, a mixed-size stream through a 4-shard planner
    performs ZERO new compiles, with the counts the reference's sharded
    test asserts (hits per op call, not per shard)."""
    c = tuple(int(v) for v in CodeSpec.make(4, P).c)
    rng = np.random.default_rng(2)
    pl = tplan.PlanCache(dispatch.get("torch-int32"), P, bucket_min=64,
                         mesh=cpus(4))
    assert pl.mesh is not None and pl.mesh.size == 4 and not pl.donate
    sizes = (100, 513, 777, 1024, 90, 1000)
    mat = rng.integers(0, P, size=(8, 8)).astype(np.int32)
    rmat = rng.integers(0, P, size=(2, 5)).astype(np.int32)

    def sweep():
        for s in sizes:
            d = rng.integers(0, P, size=(8, s)).astype(np.int32)
            pl.circulant_encode(d, c).host()
            pl.matmul(mat, d).host()
            pl.regenerate_batch(
                rmat, rng.integers(0, P, size=(2, s)).astype(np.int32),
                rng.integers(0, P, size=(2, 4, s)).astype(np.int32)).host()

    sweep()                                  # warm-up compiles
    buckets = {tplan.bucket_symbols(-(-s // 4), bucket_min=64)
               for s in sizes}
    assert pl.plan_stats().compiles == 3 * len(buckets)
    pl.reset_stats()
    for _ in range(3):
        sweep()
    st_ = pl.plan_stats()
    assert st_.compiles == 0 and st_.misses == 0, st_
    assert st_.hits == 3 * len(sizes) * 3


# ================================================ store and checkpoint
def test_store_parity_sharded_degraded_read_and_scrub():
    """The store twin harness with the port's store under use_mesh of 4
    CPU shards: put, get, node 1 lost (degraded get), replace, drain,
    verify and scrub — shares, CRC ledgers, receipts, metrics and queue
    equal to the reference's unsharded store after every step."""
    import test_torch_store as ts
    with use_mesh(cpus(4)):
        tw = ts.Twin(k=2, stripe_symbols=4096)
    assert tw.port.code.mesh.size == 4
    assert tw.port.code.planner.mesh.key() == tw.port.code.mesh.key()
    sizes = (100, 60_000, 200_001)
    tw.run(ts.put_some(sizes, seed=3))
    tw.run(ts.get_all)
    tw.run(ts.lose(1))
    tw.run(ts.drain())
    tw.run(lambda pkg, st_, sc: st_.verify())
    tw.run(lambda pkg, st_, sc: [st_.scrub_node(v)
                                 for v in range(1, st_.n_nodes + 1)])
    tw.run(ts.get_all)


def test_store_known_answer_under_a_mesh():
    """chip_smoke's store rehearsal under use_mesh of 4: the reference's
    digest (pinned by test_torch_store)."""
    import repro_torch.codes as tcodes
    import repro_torch.store as tstore
    with use_mesh(cpus(4)):
        digest = chip_smoke.store_rehearsal(
            CodeSpec, tstore.CodedObjectStore, tstore.RepairScheduler,
            tcodes.CodeClass, device="cpu")
    assert digest == chip_smoke.KA_STORE_SHA256


def test_checkpoint_restore_parity_sharded(tmp_path):
    """A checkpoint saved through a 4-shard mesh writes the reference's
    unsharded step directory byte for byte, and restores bit-exactly."""
    import repro.checkpoint.msr_checkpoint as rck
    import repro_torch.checkpoint.msr_checkpoint as tck
    state = chip_smoke.ckpt_known_state(np)
    want = chip_smoke.ckpt_rehearsal(rck.MSRCheckpointer, RSpec,
                                     tmp_path / "ref", state)
    tstate = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              for k, v in state.items()}
    got = chip_smoke.ckpt_rehearsal(tck.MSRCheckpointer, CodeSpec,
                                    tmp_path / "port", tstate, mesh=cpus(4),
                                    device="cpu")
    assert got == want == chip_smoke.KA_CKPT_SHA256
    ck = tck.MSRCheckpointer(tmp_path / "port", CodeSpec.make(8, P),
                             mesh=cpus(4), save_tile_symbols=1 << 10,
                             device="cpu")
    assert ck.code.planner.mesh.size == 4
    for failed in ((), (5,), (2, 9, 14)):
        out, _rep = ck.restore(tstate, 3, failed_nodes=list(failed))
        for k in tstate:
            for kk in tstate[k]:
                assert torch.equal(out[k][kk], tstate[k][kk]), (failed, kk)
