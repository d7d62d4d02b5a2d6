"""Every cell end to end on the CPU at a tiny size: correct against the
reference, the result line's keys, the control coming out not correct,
and each fault a cell can have, planted in the program, caught."""
import numpy as np
import pytest
import torch

from perfbench import control, deploy, harness, reference, reference_pm, \
    tiny, verify

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


# product-matrix classes and their points: (16, 8, 14) needs no
# shortening, (8, 4, 7) has one virtual node
PM_CLASSES = [((16, 8, 14), tuple(range(1, 17))),
              ((8, 4, 7), tuple(range(1, 10)))]


def helper_sets(n: int, d: int, node: int) -> list[tuple[int, ...]]:
    """The first d, the last d and every other one of the nodes but
    ``node`` (all one set where d = n - 1)."""
    rest = [j for j in range(1, n + 1) if j != node]
    return [tuple(rest[:d]), tuple(rest[-d:]),
            tuple(sorted(rest[::2] + rest[1::2][:d - len(rest[::2])]))]


@pytest.mark.parametrize("nkd,g", PM_CLASSES)
def test_product_matrix_reference_equals_the_port(nkd, g):
    from repro_torch.codes import CodeClass, make_code
    n, k, d = nkd
    code = make_code(CodeClass("product-matrix", n, k, d, 257), device="cpu")
    assert tuple(int(x) for x in code.gens) == g
    ref = reference_pm.make(n, k, d, 257, g)
    assert (ref.alpha, ref.data_blocks) == (code.share_blocks,
                                            code.data_blocks)
    gen = torch.Generator().manual_seed(1)
    data = torch.randint(0, 257, (ref.data_blocks, 500), generator=gen,
                         dtype=torch.int32)
    shares = reference_pm.encode(ref, data)
    assert torch.equal(shares, torch.from_numpy(
        code.encode_shares(data.numpy())))
    for m in range(ref.data_blocks):
        node, blk = reference_pm.data_location(ref, m)
        assert (node, blk) == code.data_location(m)
        assert torch.equal(shares[node - 1, blk], data[m])
    for node in (1, k, n):
        for hs in helper_sets(n, d, node):
            plan = code.repair_plan(node, available=hs)
            assert plan.helpers == hs
            sends = torch.stack([reference_pm.send(ref, node, shares[h - 1])
                                 for h in hs])
            port_sends = code.helper_sends(
                [(sm, shares[h - 1].numpy())
                 for sm, h in zip(plan.send_matrices, hs)])
            assert np.array_equal(port_sends, sends.numpy())
            rebuilt = reference_pm.regenerate(ref, node, hs, sends)
            assert torch.equal(rebuilt, shares[node - 1])
            assert np.array_equal(code.regenerate(plan, port_sends),
                                  rebuilt.numpy())


def test_product_matrix_reference_refuses_bad_points():
    with pytest.raises(ValueError):
        reference_pm.make(16, 8, 14, 257, tuple(range(1, 16)))
    with pytest.raises(ValueError):     # 1 and 16 have one fourth power
        reference_pm.make(8, 4, 7, 257, (1, 2, 3, 4, 5, 6, 7, 8, 16))
    with pytest.raises(ValueError):
        reference_pm.make(16, 8, 13, 257, tuple(range(1, 17)))


class _Puts:
    """A store that records each ``put`` call as it was made."""
    placement_of = None

    def __init__(self):
        self.calls = []

    def put(self, *args, **kw):
        self.calls.append((args, kw))


@pytest.mark.parametrize("name", ["dc16-hdfs128m", "pm16-tiny"])
def test_each_put_names_the_family_s_class(name):
    cfg = tiny.config(name)
    cell = harness.Cell("x", cfg, {"driver": "repair_loop"}, 1, 0.1,
                        device="cpu")
    cell.store = _Puts()
    cell.ledger = verify.Ledger(cell.n, cell.s, None,
                                data_blocks=cell.data_blocks)
    assert cell.put("a", b"xyz", 0)
    if cfg["code"]["family"] == "double-circulant":
        assert cell.store.calls == [(("a", b"xyz"), {})]
        assert deploy.code_class(cfg) is None
    else:
        from repro_torch.codes import CodeClass
        assert cell.store.calls == [(("a", b"xyz"), {
            "code_class": CodeClass("product-matrix", 16, 8, 14, 257)})]
    geo = deploy.geometry(cfg["code"])
    assert cell.rec.code == {"k": 8, "p": 257, "S": 256,
                             "family": cfg["code"]["family"], **geo}


def test_an_unknown_family_is_refused():
    cfg = tiny.config("dc16-hdfs128m")
    cfg["code"]["family"] = "reed-solomon"
    for call in (lambda: deploy.build_store(cfg, device="cpu"),
                 lambda: deploy.geometry(cfg["code"]),
                 lambda: verify.check_store(None, None, cfg["code"],
                                            lost=set(), rebuilt=set(),
                                            device="cpu")):
        with pytest.raises(ValueError, match="unknown code family"):
            call()


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


def plant(monkeypatch, run: harness.Cell, fault: str) -> str:
    """Break the step the cell's window drives: one symbol altered where
    the GF op's result lands on the host, or one of the driver's own
    faults (``FAULTS``).  Returns the name of what was replaced."""
    from repro_torch.exec.plan import PlanResult
    if fault == "altered":
        monkeypatch.setattr(PlanResult, "host",
                            _altered_host(PlanResult.host))
        return "host"
    owner, name, fn = run.driver.FAULTS[fault]()
    monkeypatch.setattr(owner, name, fn)
    return name


def put_once_more_if_back_at_fill(run: harness.Cell, filled: dict) -> None:
    """Where the window's puts left every key at the version its fill
    put (closed-loop ingest does after every lcm(keys, versions) puts),
    put one key's payload once more, changed, through the path under
    test: a broken put then shows in every run, not only in the runs
    whose window ends elsewhere."""
    if any(run.ledger.objs[key].version != v for key, v in filled.items()):
        return
    key = run.keys[0]
    obj = run.ledger.objs[key]
    run.put(key, bytes([obj.payload[0] ^ 1]) + obj.payload[1:],
            obj.version + 1)


FAULTS = [(cell, fault) for cell in tiny.cells()
          for fault in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_comes_out_not_correct(monkeypatch, cell, fault):
    entry = harness.cell_entry(tiny.bench(), cell)
    run = harness.Cell(cell, tiny.config(entry["config"]),
                       tiny.mix(entry["traffic"]), 5, 0.6, device="cpu")
    try:
        run.setup()
        filled = {key: obj.version for key, obj in run.ledger.objs.items()}
        replaced = plant(monkeypatch, run, fault)
        run.window()
        if replaced == "put":
            put_once_more_if_back_at_fill(run, filled)
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
