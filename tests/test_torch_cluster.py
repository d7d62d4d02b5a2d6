"""Port parity — the cluster simulator, degraded-read serving
(`CodedReadServer`) and the fault-tolerance control plane (mirrors
tests/test_cluster.py without the model-serving engine, and the cases of
tests/test_fault_tolerance.py that need no training loop).

Each twin runs the SAME script on both packages — the port's simulator
on the CPU, its node blocks int32 tensors — and holds the port to the
reference exactly: returned blocks, ``ScenarioReport.to_json()``, the
metrics summary, the simulator's event log and the node blocks.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_parity import no_cuda  # noqa: F401 (fixture)

import repro.checkpoint.msr_checkpoint as rck
import repro.cluster as rcluster
import repro.io as rio
import repro.serve.engine as rengine
import repro.train.fault_tolerance as rft
import repro_torch.checkpoint.msr_checkpoint as tck
import repro_torch.cluster as tcluster
import repro_torch.io as tio
import repro_torch.serve.engine as tengine
import repro_torch.train.fault_tolerance as tft
from repro.core.circulant import CodeSpec as RSpec
from repro.core.placement import RackLayout as RRack
from repro_torch.core.baselines import rs_scenario_repair_symbols
from repro_torch.core.circulant import CodeSpec as TSpec
from repro_torch.core.placement import RackLayout, rack_layout

K, P, S = 4, 257, 256

PORT = SimpleNamespace(name="port", CodeSpec=TSpec, cluster=tcluster,
                       engine=tengine, ft=tft, ck=tck, io=tio,
                       kw={"device": "cpu"})
REF = SimpleNamespace(name="ref", CodeSpec=RSpec, cluster=rcluster,
                      engine=rengine, ft=rft, ck=rck, io=rio, kw={})


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return rng.integers(0, P, (2 * K, S), dtype=np.int64).astype(np.int32)


def norm(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, BaseException):
        return ("exc", type(x).__name__, str(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((repr(k), norm(v))
                                     for k, v in x.items())))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def sim_state(sim):
    return norm({"a": sim.node_a, "r": sim.node_r, "state": sim.state,
                 "metrics": sim.metrics.summary(), "log": sim.log})


def both(script):
    """Run ``script(pkg)`` on each package; assert equal results."""
    outs = [norm(script(pkg)) for pkg in (PORT, REF)]
    assert outs[0] == outs[1]
    return outs[0]


def sim_of(pkg, data, k=K, **kw):
    return pkg.cluster.ClusterSimulator(pkg.CodeSpec.make(k, P), data,
                                        **kw, **pkg.kw)


def scenario_of(pkg, name, *args, **kw):
    return getattr(pkg.cluster.events, name)(*args, **kw)


# ------------------------------------------------------------- node loss
@pytest.mark.parametrize("failures", range(1, K + 1))   # 1..n-k
def test_node_loss_bit_exact(data, failures):
    def script(pkg):
        sim = sim_of(pkg, data)
        rep = sim.run(scenario_of(pkg, "multi_node_loss", 2 * K, K,
                                  failures=failures))
        return rep.to_json(), sim_state(sim)

    rep = dict(both(script)[0][1])
    assert rep["'bit_exact'"] is True
    m = dict(rep["'repair'"][1])
    assert m["'rs_baseline_symbols'"] == rs_scenario_repair_symbols(
        K, S, failures)
    assert m["'symbols_moved'"] == ((K + 1) * S if failures == 1
                                    else 2 * K * S)


def test_single_loss_serves_degraded_reads(data):
    both(lambda pkg: pkg.cluster.run_scenario(
        pkg.CodeSpec.make(K, P), data,
        scenario_of(pkg, "single_node_loss", 2 * K), **pkg.kw))


def test_beyond_budget_is_unrecoverable(data):
    def script(pkg):
        sim = sim_of(pkg, data)
        for v in range(1, 2 * K - K + 2):
            sim.fail_node(v)
        return sim.read_block(0), sim.repair_now(), sim_state(sim)

    out = both(script)
    assert out[0] is None and out[1] is False


# ------------------------------------------------------- corruption + scrub
def test_corruption_scrub_repairs_bit_exact(data):
    both(lambda pkg: sim_of(pkg, data).run(
        scenario_of(pkg, "latent_corruption", 2 * K)).to_json())


@pytest.mark.parametrize("where", ["a", "r"])
def test_scrub_flags_and_convicts_corruption(data, where):
    def script(pkg):
        sim = sim_of(pkg, data)
        blocks = sim.node_a if where == "a" else sim.node_r
        blocks[4, 3] = (blocks[4, 3] + 1) % P
        return sim.run_scrub(), sim_state(sim)

    flagged, _ = both(script)
    assert 5 in flagged


def test_clean_scrub_and_skipped_scrub(data):
    def script(pkg):
        sim = sim_of(pkg, data)
        clean = sim.run_scrub()
        sim.state[0] = "down"
        return clean, sim.run_scrub(), sim_state(sim)

    out = both(script)
    assert out[0] == () and out[1] == ()


def test_event_validation():
    for pkg in (PORT, REF):
        ev = pkg.cluster.events
        with pytest.raises(ValueError):
            ev.corrupt(1.0, 2, where="data")
        with pytest.raises(ValueError):
            ev.Event(t=0.0, kind="bogus")
        with pytest.raises(ValueError):
            ev.Event(t=0.0, kind="fail")
        with pytest.raises(ValueError):
            ev.fail(1.0, 0)


def test_node_targeted_events_validate_node(data):
    for pkg in (PORT, REF):
        sim = sim_of(pkg, data)
        for bad in (0, 2 * K + 1):
            with pytest.raises(ValueError):
                sim.fail_node(bad)
        with pytest.raises(ValueError):
            sim.run(pkg.cluster.events.Scenario("bad", (
                pkg.cluster.events.Event(t=0.0, kind="slow",
                                         node=2 * K + 3),)))
    with pytest.raises(ValueError):
        sim_of(PORT, data[:5])


def test_read_all_unservable_bills_nothing(data):
    def script(pkg):
        sim = sim_of(pkg, data)
        for v in range(1, 2 * K - K + 2):
            sim.fail_node(v)
        return sim.read_all(), sim_state(sim)

    assert both(script)[0] is None


# ------------------------------------------------------------ rack failure
def test_rack_layout_placement():
    lay = rack_layout(8, 4)
    assert lay.n_racks == 4 and lay.max_rack_size == 2
    assert lay.nodes_in(0) == (1, 5) and lay.rack_of(5) == 0
    assert lay.survives_rack_loss(k=4)
    assert not RackLayout(8, racks=(0, 0, 0, 0, 0, 1, 1, 1)) \
        .survives_rack_loss(k=4)


def test_rack_correlated_failure_bit_exact(data):
    def script(pkg):
        lay = (rack_layout(8, 4) if pkg is PORT
               else RRack(8, racks=rack_layout(8, 4).racks))
        return pkg.cluster.run_scenario(
            pkg.CodeSpec.make(K, P), data,
            scenario_of(pkg, "rack_failure", lay, K, rack=1), layout=lay,
            **pkg.kw).to_json()

    assert dict(both(script)[1])["'bit_exact'"] is True
    with pytest.raises(ValueError):
        tcluster.events.rack_failure(RackLayout(8, racks=(0,) * 5 + (1,) * 3),
                                     K, rack=0)


# -------------------------------------------------- stragglers + restarts
@pytest.mark.parametrize("mitigation", [True, False])
def test_straggler_mitigation_routes_around(data, mitigation):
    both(lambda pkg: pkg.cluster.run_scenario(
        pkg.CodeSpec.make(K, P), data,
        scenario_of(pkg, "straggler", 2 * K, factor=50.0),
        straggler_mitigation=mitigation, **pkg.kw).to_json())


def test_rolling_restart_degrades_without_repair(data):
    both(lambda pkg: pkg.cluster.run_scenario(
        pkg.CodeSpec.make(K, P), data,
        scenario_of(pkg, "rolling_restart", 2 * K), **pkg.kw).to_json())


# ------------------------------------------------------------ degraded reads
def test_degraded_read_bit_exact_and_single_solve(data):
    def script(pkg):
        sim = sim_of(pkg, data)
        sim.fail_node(3)
        sim.code.repair.decode_cache.clear()
        outs = [sim.read_block(2) for _ in range(5)]
        return outs, tuple(sim.code.repair.decode_cache.cache_info()), \
            sim_state(sim)

    outs, info, _ = both(script)
    assert outs[0] == norm(data[2]) and info[:2] == (4, 1)


def test_read_all_mixes_systematic_and_one_decode(data):
    def script(pkg):
        sim = sim_of(pkg, data)
        sim.fail_node(1)
        sim.fail_node(6)
        return sim.read_all(), sim_state(sim)

    assert both(script)[0] == norm(data)


def test_degraded_read_is_one_launch_over_row_sources(data, monkeypatch):
    """The one-row decode hands the data and redundancy downloads to one
    matmul as two row sources (no concatenated download)."""
    sim = sim_of(PORT, data)
    sim.fail_node(3)
    calls = []
    mm = sim.code.planner.backend.matmul

    def spy(a, b, p, out=None):
        calls.append(tuple(tuple(x.shape) for x in b)
                     if isinstance(b, tuple) else tuple(b.shape))
        return mm(a, b, p, out=out)

    monkeypatch.setattr(sim.code.planner, "backend", dataclasses.replace(
        sim.code.planner.backend, matmul=spy))
    np.testing.assert_array_equal(sim.read_block(2), data[2])
    assert calls == [((K, S), (K, S))]


# ----------------------------------------------------------- serving layer
def test_coded_read_server_pytree_roundtrip():
    state = {"w": np.arange(600, dtype=np.float32).reshape(20, 30),
             "step": np.asarray(41, np.int32)}

    def script(pkg):
        tree = {k: torch.from_numpy(v) for k, v in state.items()} \
            if pkg is PORT else state
        srv = pkg.engine.CodedReadServer.for_pytree(
            tree, pkg.CodeSpec.make(3, P), **pkg.kw)
        st0 = srv.plan_stats()
        for victim in (2, 5):
            srv.sim.fail_node(victim)
        got = srv.read_state()
        st1 = srv.plan_stats()
        return got, srv.sim.repair_now(), sim_state(srv.sim), \
            [b - a for a, b in zip(st0, st1)]

    got = both(script)[0]
    assert got == norm(state)


def test_coded_read_server_requires_pytree_mode(data):
    def script(pkg):
        srv = pkg.engine.CodedReadServer(sim_of(pkg, data))
        with pytest.raises(RuntimeError):
            srv.read_state()
        return srv.read_block(4), srv.read_blocks()

    assert both(script)[0] == norm(data[4])


# ------------------------------------------------------- scenario reports
def test_standard_scenarios_reports_equal(data):
    """ScenarioReport.to_json() of every standard scenario, at [8, 4] and
    at the production width [16, 8], equals the reference's."""
    for k in (K, 8):
        blocks = np.random.default_rng(k).integers(
            0, P, (2 * k, 1031)).astype(np.int32)
        reps = both(lambda pkg: [
            pkg.cluster.run_scenario(pkg.CodeSpec.make(k, P), blocks, sc,
                                     **pkg.kw).to_json()
            for sc in pkg.cluster.events.standard_scenarios(2 * k, k)])
        assert len(reps) == 6
        for rep in reps:
            d = dict(rep[1])
            assert d["'bit_exact'"] is True and d["'availability'"] == 1.0


def test_simulator_defaults_to_the_card(data, no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        tcluster.ClusterSimulator(TSpec.make(K, P), data)


# ------------------------------------------------------- training wiring
def test_cluster_schedule_injector_maps_time_to_steps():
    def script(pkg):
        sc = pkg.cluster.events.single_node_loss(8, node=5, at=3.0)
        inj = pkg.ft.ClusterScheduleInjector(8, sc, steps_per_time=2.0)
        return [dataclasses.astuple(e) for e in inj.at(6)], inj.at(3)

    assert both(script) == (((6, 5, "crash"),), ())


def test_supervisor_records_repair_into_cluster_metrics(tmp_path):
    def script(pkg):
        spec = pkg.CodeSpec.make(3, P)
        ck = pkg.ck.MSRCheckpointer(tmp_path / pkg.name, spec, **pkg.kw)
        metrics = pkg.cluster.MetricsLog()
        sc = pkg.cluster.events.single_node_loss(spec.n, node=2, at=3.0)
        inj = pkg.ft.ClusterScheduleInjector(spec.n, sc)
        sup = pkg.ft.Supervisor(ck, inj, ckpt_every=2, metrics=metrics)
        x = np.arange(128, dtype=np.float32)
        state = {"x": torch.from_numpy(x) if pkg is PORT else x}

        def step_fn(s, batch):
            return {"x": s["x"] + 1.0}, {"loss": float(s["x"][0])}

        out = sup.run(state, step_fn, lambda step: None, n_steps=6)
        return out, sup.log, metrics.summary(), metrics.repair_events

    out, log, _, events = both(script)
    assert out == norm({"x": np.arange(128, dtype=np.float32) + 6.0})
    assert events == 1 and any(dict(e[1]).get("'event'") == "repair"
                               for e in log)


# ------------------------------------------ tests/test_fault_tolerance.py
def test_failure_injector_deterministic_and_poisson_draws_equal():
    def script(pkg):
        fe = pkg.ft.FailureEvent
        inj = pkg.ft.FailureInjector(8, schedule=[fe(5, 3), fe(9, 1)])
        fixed = [inj.at(s) for s in (5, 6, 9)]
        poisson = pkg.ft.FailureInjector(16, rate_per_step=0.7, seed=11)
        return [[dataclasses.astuple(e) for e in evs]
                for evs in fixed + [poisson.at(s) for s in range(40)]]

    out = both(script)
    assert out[0] == ((5, 3, "crash"),) and out[1] == ()
    assert sum(len(x) for x in out[3:]) > 10


def test_heartbeat_straggler_death_and_rejoin():
    def script(pkg):
        mon = pkg.ft.HeartbeatMonitor(4, timeout_s=10, lag_threshold=2)
        for node, step in ((1, 10), (2, 3), (3, 10), (4, 10)):
            mon.beat(node, step, 100.0)
        out = [mon.stragglers(101.0), mon.dead(now=200.0)]
        mon.beat(1, 11, 195.0)
        out.append(mon.dead(now=200.0))
        mon.declare_dead(3)
        out.append(mon.suspects(196.0))
        mon.beat(3, 12, 197.0)
        out += [mon.rejoined(), mon.dead(197.5)]
        wall = pkg.ft.HeartbeatMonitor(3, timeout_s=100, lag_threshold=2,
                                       straggler_s=10)
        for node in (1, 2, 3):
            wall.beat(node, 5, 0.0)
        wall.beat(1, 6, 50.0)
        wall.beat(2, 6, 50.0)
        return out + [wall.stragglers(55.0), wall.dead(55.0)]

    out = both(script)
    assert out[0] == (2,) and out[-2] == (3,)


def test_heartbeat_threshold_validation():
    for pkg in (PORT, REF):
        hb = pkg.ft.HeartbeatMonitor
        for kw in ({"timeout_s": 0}, {"timeout_s": -5.0},
                   {"lag_threshold": -1}):
            with pytest.raises(ValueError):
                hb(4, **kw)
        for kw in ({"timeout_s": 10, "straggler_s": 10},
                   {"timeout_s": 10, "straggler_s": 0}):
            with pytest.raises(ValueError, match="straggler_s"):
                hb(4, **kw)
        with pytest.raises(ValueError):
            hb(0)
        mon = hb(3)
        with pytest.raises(ValueError):
            mon.declare_dead(9)
        with pytest.raises(ValueError):
            mon.beat(9, 1, 0.0)


def test_elastic_plan():
    out = both(lambda pkg: [dataclasses.astuple(pkg.ft.plan_elastic(16, d))
                            for d in ([3], [], [1, 2, 3, 4, 5, 6, 7])])
    assert out[0] == (15, 8, (3,), 2.0)
    with pytest.raises(RuntimeError):
        tft.plan_elastic(2, dead=[1, 2])


def _int_step(state, batch):
    return {"w": state["w"] + batch["x"]}, {"loss": float(batch["x"][0])}


def _int_data(step):
    return {"x": torch.full((256,), step + 1, dtype=torch.int64)}


def _int_ref(n_steps):
    w = torch.zeros(256, dtype=torch.int64)
    for s in range(n_steps):
        w = w + (s + 1)
    return w


def test_write_behind_bit_exact_vs_stop_world(tmp_path):
    outs = {}
    for mode in (False, True):
        ck = tck.MSRCheckpointer(tmp_path / f"wb{mode}", TSpec.make(2, P),
                                 device="cpu")
        sup = tft.Supervisor(ck, ckpt_every=3, write_behind=mode)
        outs[mode] = sup.run({"w": torch.zeros(256, dtype=torch.int64)},
                             _int_step, _int_data, 10)
        ck.close()
        assert any(e["event"] == ("ckpt_async" if mode else "ckpt")
                   for e in sup.log)
        assert ck.steps()[-1] == 9
    assert torch.equal(outs[False]["w"], outs[True]["w"])
    assert torch.equal(outs[True]["w"], _int_ref(10))


def test_crash_mid_save_restores_previous_generation(tmp_path):
    faults = tio.FaultInjector(seed=0)
    faults.add(op="write", match="step_000008", kind="transient")
    ck = tck.MSRCheckpointer(tmp_path, TSpec.make(2, P),
                             io_backend=tio.FaultyBlob(tio.LocalBlob(),
                                                       faults),
                             retry=tio.fast_retry(), device="cpu")
    inj = tft.FailureInjector(4, schedule=[tft.FailureEvent(step=9, node=2)])
    sup = tft.Supervisor(ck, inj, ckpt_every=4, write_behind=True,
                         on_save_error="log")
    out = sup.run({"w": torch.zeros(256, dtype=torch.int64)}, _int_step,
                  _int_data, 12)
    ck.close()
    assert "ckpt_failed" in [e["event"] for e in sup.log]
    repair = [e for e in sup.log if e["event"] == "repair"][0]
    assert repair["ckpt_step"] == 4
    assert torch.equal(out["w"], _int_ref(12))
    assert tio.count_tmp_orphans(tmp_path) == 0


def test_write_behind_save_error_raise_mode(tmp_path):
    faults = tio.FaultInjector(seed=0)
    faults.add(op="write", match="step_000004", kind="transient")
    ck = tck.MSRCheckpointer(tmp_path, TSpec.make(2, P),
                             io_backend=tio.FaultyBlob(tio.LocalBlob(),
                                                       faults),
                             retry=tio.fast_retry(), device="cpu")
    sup = tft.Supervisor(ck, ckpt_every=4, write_behind=True)
    with pytest.raises(tio.GiveUpError):
        sup.run({"w": torch.zeros(256, dtype=torch.int64)}, _int_step,
                _int_data, 8)
    ck.close()


def test_supervisor_config_validation(tmp_path):
    ck = tck.MSRCheckpointer(tmp_path, TSpec.make(2, P), device="cpu")
    with pytest.raises(ValueError, match="on_save_error"):
        tft.Supervisor(ck, on_save_error="ignore")
    with pytest.raises(ValueError, match="save_async"):
        tft.Supervisor(object(), write_behind=True)
