"""Fault-injection drill harness (the port of ``repro.cluster.drills``).

Each drill is a scripted failure timeline run against the REAL
durability stack — `MSRCheckpointer` atop a fault-injected
`repro_torch.io.BlobBackend`, `CodedObjectStore` with its per-node fault
seam, the `Supervisor`'s write-behind loop, the `RepairScheduler`, the
`ReadFrontEnd` — on one device (``device=``; None is the CUDA card), and
every drill's pass criterion is machine-checked:

* **bit-exact resume** — training state restored after the drill equals
  the no-fault reference run, element for element;
* **bounded data loss** — a crash loses at most the steps since the
  last *committed* generation (``data_loss_steps``);
* **zero orphans** — after recovery, no ``*.tmp`` residue on disk
  (`repro_torch.io.count_tmp_orphans`) and a clean store ``audit()``.

The harness is deterministic end to end: the training step is an exact
int32 recurrence on tensors of the drill's device (so a write-behind
save snapshots card tensors), fault rules fire from a seeded
`repro_torch.io.FaultInjector`, and retry backoff jitter is hashed, not
drawn — two runs with the same seed take identical paths.  `run_drills`
is the entry point; each drill returns a :class:`DrillResult`.

Drills double as executable documentation of the crash-consistency
contract: read ``crash_mid_save`` next to DESIGN.md §12.2 and each
assertion is one clause of the commit protocol.  Their code is the
reference's [6, 3] over GF(257) at its own sizes.
"""
from __future__ import annotations

import dataclasses
import pathlib
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.msr_checkpoint import MSRCheckpointer
from repro_torch.core.circulant import CodeSpec
from repro_torch.device import resolve_device
from repro_torch.io import (FaultInjector, FaultyBlob, GiveUpError,
                            LocalBlob, count_tmp_orphans, fast_retry)
from repro_torch.train.fault_tolerance import Supervisor


@dataclasses.dataclass
class DrillResult:
    """One drill's verdict.

    ``bit_exact`` is the restored-state comparison against the no-fault
    reference; ``orphans`` counts post-recovery ``*.tmp`` residue (must
    be 0); ``data_loss_steps`` is how many steps of progress the crash
    cost (bounded by the checkpoint cadence); ``resumed_from`` is the
    generation recovery restored.  ``passed`` folds in every
    drill-specific assertion, not just the headline two.
    """
    name: str
    passed: bool
    bit_exact: bool
    orphans: int
    resumed_from: Optional[int] = None
    data_loss_steps: Optional[int] = None
    time_to_resume_s: float = 0.0
    detail: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ----------------------------------------------------- synthetic trainer
# An exact int32 recurrence: w_{t+1} = w_t + (t+1) * iota.  Deterministic,
# overflow-free at drill scale, and cheap — drills exercise the I/O stack,
# not the model.  The state is int32 tensors on the drill's device.
_STATE_SYMBOLS = 4096


def _init_state(device) -> dict:
    return {"w": torch.zeros(_STATE_SYMBOLS, dtype=torch.int32,
                             device=device),
            "b": torch.arange(_STATE_SYMBOLS // 4, dtype=torch.int32,
                              device=device)}


def _data_fn(device) -> Callable[[int], dict]:
    def data(step: int) -> dict:
        return {"x": torch.full((_STATE_SYMBOLS,), step + 1,
                                dtype=torch.int32, device=device)}
    return data


def _step_fn(state: dict, batch: dict) -> tuple[dict, dict]:
    w = state["w"] + batch["x"]
    return ({"w": w, "b": state["b"] + 1},
            {"loss": float(batch["x"][0])})


def _run_reference(n_steps: int, device) -> dict:
    state, data = _init_state(device), _data_fn(device)
    for step in range(n_steps):
        state, _ = _step_fn(state, data(step))
    return state


def _states_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(torch.as_tensor(a[k]).cpu(),
                           torch.as_tensor(b[k]).cpu()) for k in ("w", "b"))


def _spec() -> CodeSpec:
    return CodeSpec.make(3, 257)        # n = 6 nodes, survives 3 losses


def _ckpt(d: pathlib.Path, device, *, blob=None,
          faults: Optional[FaultInjector] = None) -> MSRCheckpointer:
    iob = blob
    if iob is None and faults is not None:
        iob = FaultyBlob(LocalBlob(fsync=False), faults)
    return MSRCheckpointer(d, _spec(),
                           io_backend=iob or LocalBlob(fsync=False),
                           retry=fast_retry(), device=device)


# ---------------------------------------------------------------- drills
def crash_mid_save(root: pathlib.Path, seed: int = 0, *,
                   device=None) -> DrillResult:
    """A write-behind save dies mid-write (every write into the step-10
    staging dir fails persistently).  The commit protocol must keep
    generation 5 intact and invisible damage: recovery restores step 5
    bit-exactly, loses exactly the 7 post-checkpoint steps, and leaves
    zero ``*.tmp`` orphans."""
    device = resolve_device(device)
    d = root / "crash_mid_save"
    n_steps, every = 12, 5
    faults = FaultInjector(seed=seed)
    faults.add(op="write", match="step_000010", kind="transient")
    ck = _ckpt(d, device, faults=faults)
    sup = Supervisor(ck, ckpt_every=every, write_behind=True,
                     on_save_error="log")
    sup.run(_init_state(device), _step_fn, _data_fn(device), n_steps)
    ck.close()
    save_failed = any(e["event"] == "ckpt_failed" for e in sup.log)

    # restart: a fresh process recovers, then resumes from the last
    # committed generation
    t0 = time.perf_counter()
    ck2 = _ckpt(d, device)                       # clean blob; recover() runs here
    steps = ck2.steps()
    resumed_from = steps[-1] if steps else None
    state, _ = ck2.restore(_init_state(device), resumed_from)
    t_resume = time.perf_counter() - t0
    bit_exact = _states_equal(state, _run_reference(resumed_from or 0, device))
    # resume training to the horizon: the replayed run must converge to
    # the no-fault final state (stateless data_fn => exact replay)
    sup2 = Supervisor(ck2, ckpt_every=every)
    final = sup2.run(state, _step_fn, _data_fn(device),
                     n_steps - (resumed_from or 0),
                     start_step=resumed_from or 0)
    resumed_exact = _states_equal(final, _run_reference(n_steps, device))
    ck2.close()
    orphans = count_tmp_orphans(d)
    loss = n_steps - (resumed_from or 0)
    passed = (save_failed and resumed_from == 5 and bit_exact
              and resumed_exact and orphans == 0 and loss <= n_steps - every)
    return DrillResult("crash_mid_save", passed,
                       bit_exact and resumed_exact, orphans,
                       resumed_from=resumed_from, data_loss_steps=loss,
                       time_to_resume_s=t_resume,
                       detail=f"save_failed={save_failed} steps={steps}")


def kill_rack_write_behind(root: pathlib.Path, seed: int = 0, *,
                           device=None) -> DrillResult:
    """Two-phase rack drill.  Phase A: a whole rack's node files become
    unwritable during the write-behind save of step 8 — the save gives
    up, the run continues on generation 4, recovery resumes from it.
    Phase B: after a clean commit, the rack dies AT REST (its node files
    deleted); ``restore(failed_nodes=...)`` must rebuild the pairs
    bit-exactly and a scrub must come back clean."""
    device = resolve_device(device)
    d = root / "kill_rack"
    n_steps, every = 10, 4
    rack = (1, 2)                        # n=6: within the n-k=3 budget
    faults = FaultInjector(seed=seed)
    for node in rack:
        faults.add(op="write", match=f"step_000008.tmp/node_{node:02d}",
                   kind="transient")
    ck = _ckpt(d, device, faults=faults)
    sup = Supervisor(ck, ckpt_every=every, write_behind=True,
                     on_save_error="log")
    sup.run(_init_state(device), _step_fn, _data_fn(device), n_steps)
    ck.close()
    phase_a_failed = any(e["event"] == "ckpt_failed" for e in sup.log)

    t0 = time.perf_counter()
    ck2 = _ckpt(d, device)
    steps = ck2.steps()
    resumed_from = steps[-1] if steps else None
    state, _ = ck2.restore(_init_state(device), resumed_from)
    t_resume = time.perf_counter() - t0
    phase_a_exact = _states_equal(state, _run_reference(resumed_from or 0, device))

    # phase B: commit a clean generation, then kill the rack at rest
    ck2.save(n_steps, _run_reference(n_steps, device))
    for node in rack:
        a, r = ck2._node_files(n_steps, node)
        ck2.iob.remove(a)
        ck2.iob.remove(r)
    state_b, rep = ck2.restore(_init_state(device), n_steps,
                               failed_nodes=list(rack))
    phase_b_exact = (_states_equal(state_b, _run_reference(n_steps, device))
                     and rep.path == "reconstruct"
                     and rep.repaired_nodes == rack)
    scrub_clean = ck2.scrub(n_steps).clean
    ck2.close()
    orphans = count_tmp_orphans(d)
    passed = (phase_a_failed and resumed_from == 4 and phase_a_exact
              and phase_b_exact and scrub_clean and orphans == 0)
    return DrillResult("kill_rack_write_behind", passed,
                       phase_a_exact and phase_b_exact, orphans,
                       resumed_from=resumed_from,
                       data_loss_steps=n_steps - (resumed_from or 0),
                       time_to_resume_s=t_resume,
                       detail=f"phase_a_failed={phase_a_failed} "
                              f"repaired={rep.repaired_nodes} "
                              f"scrub_clean={scrub_clean}")


def _store_classes():
    # deferred: repro_torch.store pulls in repro_torch.cluster.events, so
    # a module-level import here would be circular via the package init
    from repro_torch.store import CodedObjectStore, RepairScheduler
    return CodedObjectStore, RepairScheduler


def crash_mid_put(root: pathlib.Path, seed: int = 0, *,
                  device=None) -> DrillResult:
    """A store ``put`` dies mid-flight (one node's share writes fail
    persistently).  Atomic-put contract: the key must not become
    visible, an overwritten key must keep its old value fully readable,
    and the audit must find zero orphan shares.  A hard-crash orphan
    (poked into node state directly) must be flagged and collected."""
    device = resolve_device(device)
    faults = FaultInjector(seed=seed)
    # n_nodes = n: every stripe places a share on EVERY node, so the
    # node:03 write fault is guaranteed to hit each put
    CodedObjectStore, _ = _store_classes()
    store = CodedObjectStore(_spec(), n_nodes=6, stripe_symbols=64,
                             faults=faults, retry=fast_retry(),
                             device=device)
    old = bytes(range(256)) * 4
    store.put("obj", old)
    faults.add(op="write", match="node:03", kind="transient")
    gave_up = False
    try:
        store.put("obj", bytes(reversed(old)))      # overwrite dies
    except GiveUpError:
        gave_up = True
    new_key_invisible = True
    try:
        store.put("fresh", b"zz" * 128)             # new key dies too
    except GiveUpError:
        new_key_invisible = "fresh" not in store.keys()
    faults.clear()
    t0 = time.perf_counter()
    old_intact = store.get("obj") == old
    t_resume = time.perf_counter() - t0
    audit_clean = store.audit().clean
    # hard-crash residue: a share no committed object accounts for
    store._shares[0][("ghost", 0)] = [1, np.zeros(64, np.int32),
                                      np.zeros(64, np.int32)]
    flagged = not store.audit().clean and not store.verify()
    collected = store.gc_orphans() == 1 and store.verify()
    store.close()
    passed = (gave_up and new_key_invisible and old_intact and audit_clean
              and flagged and collected)
    return DrillResult("crash_mid_put", passed, old_intact, 0,
                       time_to_resume_s=t_resume,
                       detail=f"gave_up={gave_up} "
                              f"new_key_invisible={new_key_invisible} "
                              f"orphan_flagged={flagged} "
                              f"orphan_collected={collected}")


def corrupt_then_scrub(root: pathlib.Path, seed: int = 0, *,
                       device=None) -> DrillResult:
    """Silent on-disk corruption: a byte of one node's data block flips
    after commit.  The scrub's manifest content CRCs must convict that
    node exactly, ``repair_node`` must rebuild it from its d = k+1
    helpers, and the re-scrub + restore must be clean and bit-exact."""
    device = resolve_device(device)
    d = root / "corrupt_scrub"
    ck = _ckpt(d, device)
    state = _run_reference(7, device)
    ck.save(7, state)
    victim = 2
    a_path = ck._node_files(7, victim)[0]
    raw = bytearray(ck.iob.read(a_path))
    raw[-1] ^= 0xFF                      # payload byte, not the npy header
    ck.iob.write(a_path, bytes(raw))
    flagged = victim in ck.scrub(7).mismatched_nodes
    ck.repair_node(7, victim)
    rescrub_clean = ck.scrub(7).clean
    t0 = time.perf_counter()
    restored, _ = ck.restore(_init_state(device), 7)
    t_resume = time.perf_counter() - t0
    bit_exact = _states_equal(restored, state)
    ck.close()
    orphans = count_tmp_orphans(d)
    passed = flagged and rescrub_clean and bit_exact and orphans == 0
    return DrillResult("corrupt_then_scrub", passed, bit_exact, orphans,
                       resumed_from=7, time_to_resume_s=t_resume,
                       detail=f"flagged={flagged} "
                              f"rescrub_clean={rescrub_clean}")


def restart_mid_drain(root: pathlib.Path, seed: int = 0, *,
                      device=None) -> DrillResult:
    """The repair scheduler crashes with its queue half-drained.  A new
    scheduler has no memory of the failure events; ``enqueue_scan`` must
    rebuild the queue from store ground truth and ``drain_all`` must
    re-protect every stripe (verify() bit-exact, zero lost shares)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    CodedObjectStore, RepairScheduler = _store_classes()
    store = CodedObjectStore(_spec(), n_nodes=8, stripe_symbols=64,
                             device=device)
    for i in range(3):
        store.put(f"o{i}", rng.integers(0, 256, 2048).astype(np.uint8)
                  .tobytes())
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    store.fail_node(2)
    before = sched.pending()
    sched.drain(budget_symbols=(store.k + 1) * store.S)   # one stripe's worth
    partially_drained = 0 < sched.pending() < before
    del sched                                             # the "crash"

    t0 = time.perf_counter()
    sched2 = RepairScheduler(store)                       # fresh process
    rescanned = sched2.enqueue_scan()
    rep = sched2.drain_all()
    t_resume = time.perf_counter() - t0
    verified = store.verify() and store.total_lost_shares() == 0
    store.close()
    passed = (partially_drained and rescanned > 0 and rep.unrecoverable == 0
              and sched2.pending() == 0 and verified)
    return DrillResult("restart_mid_drain", passed, verified, 0,
                       time_to_resume_s=t_resume,
                       detail=f"queued={before} rescanned={rescanned} "
                              f"repaired={rep.repaired_stripes}")


def transient_fault_storm(root: pathlib.Path, seed: int = 0, *,
                          device=None) -> DrillResult:
    """A storm of ~10%-probability transient faults on every blob read
    and write.  The retry policy must absorb all of it: saves and
    restores succeed, zero give-ups, restored state bit-exact, and the
    retry amplification stays within the policy's attempt budget."""
    device = resolve_device(device)
    d = root / "fault_storm"
    faults = FaultInjector(seed=seed)
    faults.add(op="write", kind="transient", prob=0.1)
    faults.add(op="read", kind="transient", prob=0.1)
    # 6 attempts: at a 10% fault rate the give-up probability per op is
    # 1e-6 — pool-thread scheduling reorders the RNG draws across runs,
    # so the budget must make give-ups negligible for ANY ordering
    ck = MSRCheckpointer(d, _spec(),
                         io_backend=FaultyBlob(LocalBlob(fsync=False),
                                               faults),
                         retry=fast_retry(max_attempts=6), device=device)
    state = _run_reference(5, device)
    ck.save(5, state)
    t0 = time.perf_counter()
    restored, _ = ck.restore(_init_state(device), 5)
    t_resume = time.perf_counter() - t0
    bit_exact = _states_equal(restored, state)
    scrub_clean = ck.scrub(5).clean
    stats = ck.retry_stats.summary()
    ck.close()
    orphans = count_tmp_orphans(d)
    passed = (bit_exact and scrub_clean and orphans == 0
              and stats["giveups"] == 0
              and stats["amplification"] < ck.retry.max_attempts)
    return DrillResult("transient_fault_storm", passed, bit_exact, orphans,
                       resumed_from=5, time_to_resume_s=t_resume,
                       detail=f"retry={stats}")


def serve_under_churn(root: pathlib.Path, seed: int = 0, *,
                      device=None) -> DrillResult:
    """Concurrent gets through the serving front end while the cluster
    churns (DESIGN.md §13): a node failure served mid-drain
    (`restart_mid_drain`'s shape), a ~10% transient read-fault storm
    (`transient_fault_storm`'s shape), then storage bit-rot on one node.
    Contract: every response bit-exact, ZERO corrupt payloads reach a
    caller, and the rotten node walks the full quarantine state machine
    — quarantined on the CRC catch, held through a dirty scrub that
    finds the rest of its rot, re-admitted only after repair + a clean
    scrub (the event log proves the ordering)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    CodedObjectStore, RepairScheduler = _store_classes()
    from repro_torch.serve.frontend import ReadFrontEnd   # deferred too
    faults = FaultInjector(seed=seed)
    store = CodedObjectStore(_spec(), n_nodes=8, stripe_symbols=64,
                             faults=faults, retry=fast_retry(max_attempts=6),
                             device=device)
    objs = {f"o{i}": rng.integers(0, 256, 2048).astype(np.uint8).tobytes()
            for i in range(3)}
    for key, val in objs.items():
        store.put(key, val)
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    fe = ReadFrontEnd(store, scheduler=sched, quarantine_threshold=2.0,
                      hedge_after_s=0.25, fetch_workers=4)
    corrupt_served = 0

    def serve_all() -> bool:
        nonlocal corrupt_served
        tickets = [fe.submit(key) for key in objs for _ in range(2)]
        fe.pump()
        ok = True
        for tk in tickets:
            if tk.error is not None:
                ok = False
            elif tk.obj != objs[tk.key]:
                corrupt_served += 1
                ok = False
        return ok

    # phase A: node failure served mid-drain (restart_mid_drain shape)
    store.fail_node(2)
    sched.drain(budget_symbols=(store.k + 1) * store.S)  # half-drained queue
    a_ok = serve_all()
    sched.drain_all()

    # phase B: transient read-fault storm (transient_fault_storm shape)
    faults.add(op="read", kind="transient", prob=0.1)
    b_ok = serve_all()
    faults.clear()

    # phase C: storage bit-rot on node 5 — two shares of DIFFERENT keys,
    # only one of which the next reads touch, so re-admission provably
    # requires the dirty scrub to find the second
    victim = 5
    by_key: dict[str, tuple[str, int]] = {}
    for key, t in sorted(store._shares[victim - 1]):
        by_key.setdefault(key, (key, t))
    (k1, t1), (k2, t2) = list(by_key.values())[:2]
    store._shares[victim - 1][(k1, t1)][1][0] ^= 0x55
    store._shares[victim - 1][(k2, t2)][1][0] ^= 0x55
    c_ok = fe.read(k1) == objs[k1]          # CRC catch -> quarantine
    quarantined = victim in fe.quarantined_nodes()
    t0 = time.perf_counter()
    first_scrub = fe.scrub_quarantined()    # dirty: finds (k2, t2)'s rot
    held = victim in fe.quarantined_nodes()
    sched.drain_all()                       # rebuild both dropped shares
    second_scrub = fe.scrub_quarantined()   # clean: re-admit
    t_recover = time.perf_counter() - t0
    readmitted = victim not in fe.quarantined_nodes()
    c_ok = c_ok and serve_all()             # serving clean again
    seqs = {e["what"]: e["seq"] for e in fe.events
            if e.get("node") == victim
            and e["what"] in ("quarantine", "scrub_dirty", "readmit")}
    ordered = (len(seqs) == 3 and
               seqs["quarantine"] < seqs["scrub_dirty"] < seqs["readmit"])
    audit = store.audit()
    verified = store.verify() and store.total_lost_shares() == 0
    fe.close()
    store.close()
    bit_exact = a_ok and b_ok and c_ok
    passed = (bit_exact and corrupt_served == 0 and quarantined and held
              and not first_scrub[0]["readmitted"]
              and second_scrub[0]["readmitted"] and readmitted
              and ordered and audit.clean and verified)
    return DrillResult("serve_under_churn", passed, bit_exact,
                       len(audit.orphan_shares),
                       time_to_resume_s=t_recover,
                       detail=f"corrupt_served={corrupt_served} "
                              f"quarantine_order={ordered} "
                              f"crc_rejected={fe.metrics.crc_rejected} "
                              f"served={fe.metrics.served}")


DRILLS: dict[str, Callable[..., DrillResult]] = {
    "crash_mid_save": crash_mid_save,
    "kill_rack_write_behind": kill_rack_write_behind,
    "crash_mid_put": crash_mid_put,
    "corrupt_then_scrub": corrupt_then_scrub,
    "restart_mid_drain": restart_mid_drain,
    "transient_fault_storm": transient_fault_storm,
    "serve_under_churn": serve_under_churn,
}


def run_drills(root: Optional[pathlib.Path] = None,
               names: Optional[Sequence[str]] = None,
               seed: int = 0, device=None) -> list[DrillResult]:
    """Run the selected drills (all by default) under ``root`` (a fresh
    temp dir by default) on ``device`` (None is the CUDA card); returns
    their results in registry order."""
    tmp = None
    if root is None:
        tmp = tempfile.TemporaryDirectory()
        root = pathlib.Path(tmp.name)
    root = pathlib.Path(root)
    try:
        selected = list(DRILLS) if names is None else list(names)
        unknown = [n for n in selected if n not in DRILLS]
        if unknown:
            raise KeyError(f"unknown drill(s) {unknown}; "
                           f"available: {list(DRILLS)}")
        device = resolve_device(device)
        return [DRILLS[n](root, seed, device=device)
                for n in selected]
    finally:
        if tmp is not None:
            tmp.cleanup()


__all__ = ["DrillResult", "DRILLS", "run_drills", "crash_mid_save",
           "kill_rack_write_behind", "crash_mid_put", "corrupt_then_scrub",
           "restart_mid_drain", "transient_fault_storm", "serve_under_churn"]
