"""Port parity — the crash-consistency drills (mirrors tests/test_drills.py).

Every drill of the port passes on the CPU — bit-exact resume, bounded
data loss, zero orphans — and its `DrillResult`, all but the measured
``time_to_resume_s``, equals the reference's drill of the same name and
seed.
"""
import dataclasses

import pytest
from _torch_parity import no_cuda  # noqa: F401 (fixture)

from repro.cluster import drills as rdrills
from repro_torch.cluster import drills as tdrills


def untimed(res) -> dict:
    out = dataclasses.asdict(res)
    out.pop("time_to_resume_s")
    return out


@pytest.mark.parametrize("name", sorted(rdrills.DRILLS))
def test_drill_passes_and_matches_reference(tmp_path, name):
    (got,) = tdrills.run_drills(tmp_path / "port", names=[name],
                                device="cpu")
    assert got.passed, f"{name}: {got.detail}"
    assert got.bit_exact and got.orphans == 0
    (want,) = rdrills.run_drills(tmp_path / "ref", names=[name])
    assert untimed(got) == untimed(want)


def test_every_reference_drill_is_ported():
    assert list(tdrills.DRILLS) == list(rdrills.DRILLS)


def test_data_loss_bounded_by_cadence():
    results = {r.name: r for r in tdrills.run_drills(
        names=["crash_mid_save", "kill_rack_write_behind"], device="cpu")}
    assert results["crash_mid_save"].resumed_from == 5
    assert results["crash_mid_save"].data_loss_steps == 7
    assert results["kill_rack_write_behind"].resumed_from == 4


def test_unknown_drill_rejected(tmp_path):
    with pytest.raises(KeyError):
        tdrills.run_drills(tmp_path, names=["meteor_strike"], device="cpu")


def test_deterministic_across_runs(tmp_path):
    a = tdrills.run_drills(tmp_path / "a", names=["transient_fault_storm"],
                           seed=3, device="cpu")
    b = tdrills.run_drills(tmp_path / "b", names=["transient_fault_storm"],
                           seed=3, device="cpu")
    assert a[0].passed and untimed(a[0]) == untimed(b[0])


def test_drills_default_to_the_card(tmp_path, no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        tdrills.run_drills(tmp_path, names=["crash_mid_put"])
