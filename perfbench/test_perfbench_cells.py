"""Every cell end to end on the CPU at a tiny size: correct against the
reference, the result line's keys, the control coming out not correct,
and each fault a cell can have, planted in the program, caught."""
import numpy as np
import pytest
import torch

from perfbench import control, harness, reference, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", tiny.cells())
def test_cell_runs_correct_with_its_metrics(cell):
    res = tiny.run(cell)
    assert list(res) == KEYS
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in harness.metric_specs(tiny.bench(), cell,
                                                    False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])


def test_traced_run_adds_the_breakdown():
    res = tiny.run("rgw-degraded-read", trace=True)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in harness.metric_specs(
        tiny.bench(), "rgw-degraded-read", True)}
    assert set(res["metrics"]) <= names
    assert "frontend.service_ms" in res["metrics"]


def test_reference_equals_the_port():
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.core.msr import DoubleCirculantMSR
    c = [195, 101, 85, 228, 68, 59, 183, 160]
    code = DoubleCirculantMSR(CodeSpec.make(8, 257, c=c), device="cpu")
    gen = torch.Generator().manual_seed(0)
    data = torch.randint(0, 257, (16, 1000), generator=gen,
                         dtype=torch.int32)
    red = reference.encode(data, c, 257)
    assert torch.equal(red, code.encode(data))
    for node in (1, 2, 9, 16):
        prev, nxt = reference.helpers(node, 16)
        plan = code.repair_plan(node)
        assert (prev, nxt) == (plan.prev_node, plan.next_nodes)
        helpers = data[[x - 1 for x in nxt]]
        a, r = reference.regenerate(node, red[prev - 1], helpers, c, 257)
        pa, pr = code.regenerate(node, red[prev - 1], helpers)
        assert torch.equal(a, pa) and torch.equal(r, pr)
        assert torch.equal(a, data[node - 1]) and torch.equal(r,
                                                              red[node - 1])
    m = torch.randint(0, 257, (3, 16), generator=gen, dtype=torch.int32)
    assert torch.equal(reference.gf_matmul(m, data, 257),
                       torch.remainder(m.long() @ data.long(), 257).int())


@pytest.mark.parametrize("cell", tiny.cells())
def test_control_comes_out_not_correct(cell):
    res = tiny.run(cell, backend=control.register())
    assert not res["correct"]
    assert res["checks"]["share_mismatch"]["value"] > 0 or \
        res["checks"].get("read_mismatch", {"value": 0})["value"] > 0


def _altered_host(orig):
    def host(self):
        out = np.array(orig(self), copy=True)
        flat = out.reshape(-1)
        flat[0] = (flat[0] + 1) % 257
        return out
    return host


def plant(monkeypatch, run: harness.Cell, fault: str) -> None:
    """Break the step the cell's window drives: one symbol altered where
    the GF op's result lands on the host, or one of the driver's own
    faults (``FAULTS``)."""
    from repro_torch.exec.plan import PlanResult
    if fault == "altered":
        monkeypatch.setattr(PlanResult, "host",
                            _altered_host(PlanResult.host))
        return
    owner, name, fn = run.driver.FAULTS[fault]()
    monkeypatch.setattr(owner, name, fn)


FAULTS = [(cell, fault) for cell in tiny.cells()
          for fault in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_comes_out_not_correct(monkeypatch, cell, fault):
    entry = harness.cell_entry(tiny.bench(), cell)
    run = harness.Cell(cell, tiny.config(entry["config"]),
                       tiny.mix(entry["traffic"]), 5, 0.6, device="cpu")
    try:
        run.setup()
        plant(monkeypatch, run, fault)
        run.window()
        run.finish()
        checks = run.check()
    finally:
        monkeypatch.undo()
        run.close()
    failed = {k: v for k, v in checks.items()
              if k in harness.verify.LIMITS and v > harness.verify.LIMITS[k]}
    assert failed, checks


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card):
    bench = tiny.bench()
    for cell in tiny.cells():
        entry = harness.cell_entry(bench, cell)
        import time
        res = harness.run_cell(bench, cell, 9, 0.6, True,
                               t_start=time.perf_counter(), device=None,
                               config=tiny.config(entry["config"]),
                               mix=tiny.mix(entry["traffic"]))
        assert res["correct"], (cell, res["checks"])
        assert res["device"]["busy_s"] > 0


def test_every_driver_has_a_run_and_its_faults():
    used = {tiny.mix(harness.cell_entry(tiny.bench(), c)["traffic"])
            ["driver"] for c in tiny.cells()}
    assert used == set(tiny.drivers())
    for name in tiny.drivers():
        drv = harness.load_driver(name)
        assert {"unchanged", "half"} <= set(drv.FAULTS), name
        assert callable(drv.setup) and callable(drv.window), name
    with pytest.raises(KeyError):
        harness.load_driver("no-such-driver")


def test_the_cells_tested_are_benchmark_json_s():
    names = [w["name"] for w in harness.load_benchmark()["workloads"]]
    assert tiny.cells()[:len(names)] == names
    assert not set(tiny.RIGS) & set(names)
