"""Port parity — the MSR checkpointer (mirrors tests/test_checkpoint.py).

Every twin drives the SAME script through a checkpointer of each package —
repro_torch.checkpoint on the CPU with torch leaves, repro.checkpoint with
numpy leaves — and holds the port to the reference exactly: restored
states, restore and scrub reports, manifests, the exceptions raised, and
the step directories on disk (every file byte for byte; an ``.npz`` by
its members, since its zip container carries the write time).  Also: a
step saved by either package restored by the other on every restore
path, the store-backed mode over twin stores, write-behind under an
in-place update, and the checkpoint known-answer digest chip_smoke.py
checks on the card.
"""
import dataclasses
import json
import re
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import no_cuda  # noqa: F401 (fixture)

import repro.checkpoint.msr_checkpoint as rck
import repro.io as rio
import repro.store as rstore
import repro_torch.checkpoint.msr_checkpoint as tck
import repro_torch.io as tio
import repro_torch.store as tstore
from repro.core import gf as rgf
from repro.core.circulant import CodeSpec as RSpec
from repro_torch.core.circulant import CodeSpec as TSpec

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def make_state(seed=0) -> dict:
    """A training-state tree as numpy (both packages' leaves come from it)."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((37, 19)).astype(np.float32),
                       "b": np.arange(11, dtype=np.int32)},
            "opt": {"mu": (rng.standard_normal((37, 19)) * 1e-3).astype(
                        np.float32),
                    "step": np.asarray(7, np.int32)}}


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def leaves_of(side, tree):
    return as_torch(tree) if side == "port" else tree


def norm(x, root=None):
    """A comparable, package-neutral form of a checkpointer result."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":
            x = x.view(np.int16)
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, BaseException):
        msg = str(x) if root is None else str(x).replace(str(root), "<root>")
        return ("exc", type(x).__name__,
                re.sub(r" in \d+\.\d+s", " in <t>s", msg))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((repr(k), norm(v, root))
                                     for k, v in x.items())))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v, root) for v in x)
    return x


def dir_state(root: Path) -> list:
    """Every file under ``root`` with its content (an .npz by members)."""
    out = []
    for f in sorted(root.rglob("*")):
        if f.is_dir():
            out.append((str(f.relative_to(root)), "dir"))
        elif f.suffix == ".npz":
            with zipfile.ZipFile(f) as z:
                out.append((str(f.relative_to(root)),
                            [(m, z.read(m)) for m in sorted(z.namelist())]))
        else:
            out.append((str(f.relative_to(root)), f.read_bytes()))
    return out


class Twin:
    """One checkpointer per package, built alike in sibling directories;
    ``run`` applies a script to both and asserts equal results and equal
    directories."""

    def __init__(self, tmp_path, k=4, faults=None, **kw):
        self.sides = []
        for side, mod, spec, io, extra in (
                ("port", tck, TSpec, tio, {"device": "cpu"}),
                ("ref", rck, RSpec, rio, {})):
            root = tmp_path / side
            if faults is not None:
                inj = io.FaultInjector(seed=0)
                for rule in faults:
                    inj.add(**rule)
                extra = dict(extra, io_backend=io.FaultyBlob(io.LocalBlob(),
                                                             inj),
                             retry=io.fast_retry())
            self.sides.append((side, mod.MSRCheckpointer(
                root, spec.make(k, 257), **kw, **extra), root))

    def run(self, script, raises=False):
        """``raises``: the script is expected to raise (on both sides)."""
        outs = []
        for side, ck, root in self.sides:
            try:
                out = script(ck, side)
            except Exception as e:                  # noqa: BLE001
                if not raises:
                    raise
                out = e
            outs.append((norm(out, root), dir_state(root)))
        (got, got_dir), (want, want_dir) = outs
        assert got == want
        assert got_dir == want_dir
        return got

    @property
    def port(self):
        return self.sides[0][1]

    def close(self):
        for _, ck, _ in self.sides:
            ck.close()


def save(step, seed=0):
    return lambda ck, side: ck.save(step, leaves_of(side,
                                                    make_state(seed)))


def restore(step=None, failed=(), seed=0, **kw):
    return lambda ck, side: ck.restore(leaves_of(side, make_state(seed)),
                                       step, failed_nodes=failed, **kw)


# ------------------------------------------ twins of tests/test_checkpoint.py
def test_save_restore_systematic(tmp_path):
    tw = Twin(tmp_path)
    tw.run(save(3))
    state, rep = tw.run(restore(3))
    assert rep[2] == ("path", "systematic")
    got, _ = tw.port.restore(as_torch(make_state()), 3)
    assert all(torch.equal(got["params"][k], as_torch(make_state())
                           ["params"][k]) for k in ("w", "b"))


def test_restore_latest_step(tmp_path):
    tw = Twin(tmp_path)
    tw.run(save(1, seed=1))
    tw.run(save(2, seed=2))
    tw.run(restore(seed=1))


def test_single_failure_regeneration_gamma(tmp_path):
    tw = Twin(tmp_path)
    tw.run(save(5))
    tw.run(restore(5, failed=[3]))
    tw.run(lambda ck, side: ck.repair_node(5, 2))


def test_multi_failure_reconstruction(tmp_path):
    tw = Twin(tmp_path)
    tw.run(save(1))
    tw.run(restore(1, failed=[1, 4, 6]))
    tw.run(restore(1))


def test_unrecoverable_raises(tmp_path):
    tw = Twin(tmp_path)
    tw.run(save(1))
    out = tw.run(restore(1, failed=[1, 2, 3, 4, 5]), raises=True)
    assert out[:2] == ("exc", "RuntimeError")


@pytest.mark.parametrize("n_failed", [2, 3, 4])
def test_multi_failure_repair_and_rewrite(tmp_path, n_failed):
    tw = Twin(tmp_path)
    tw.run(save(1, seed=n_failed))
    failed = list(range(2, 2 + n_failed))

    def kill(ck, side):
        for f in failed:
            for path in ck._node_files(1, f):
                path.unlink()

    tw.run(kill)
    tw.run(restore(1, failed=failed, seed=n_failed))
    tw.run(lambda ck, side: ck.scrub(1))
    tw.run(restore(1, seed=n_failed))


def test_multi_failure_no_repair(tmp_path):
    tw = Twin(tmp_path)
    tw.run(save(1, seed=9))
    for _, ck, _ in tw.sides:
        for f in (3, 7):
            for path in ck._node_files(1, f):
                path.unlink()
    tw.run(restore(1, failed=[3, 7], seed=9, repair=False))


def test_scrub_clean_then_flags_corruption(tmp_path):
    tw = Twin(tmp_path)
    tw.run(save(1, seed=11))
    tw.run(lambda ck, side: ck.scrub(1))

    def flip(ck, side):
        _, rf = ck._node_files(1, 5)
        z = np.load(rf)
        r = rgf.unpack257(z["low"], z["hi"])
        r[0] = (r[0] + 1) % 257
        low, hi = rgf.pack257(r)
        np.savez(rf, low=low, hi=hi)
        return ck.scrub(1)

    # the rewritten .npz members are equal; only the container's time is not
    out = tw.run(flip)
    assert 5 in dict(out[1:])["mismatched_nodes"]
    tw.run(lambda ck, side: (ck.repair_node(1, 5), ck.scrub(1)))


def test_every_single_node_repairable(tmp_path):
    tw = Twin(tmp_path, k=3)
    tw.run(save(2, seed=4))
    for node in range(1, 7):
        tw.run(restore(2, failed=[node], seed=4))


def test_gc_keeps_last(tmp_path):
    tw = Twin(tmp_path, k=2, keep_last=2)
    for s in (1, 2, 3, 4):
        tw.run(save(s))
    tw.run(lambda ck, side: ck.steps())


def test_bit_exact_across_dtypes(tmp_path):
    import jax.numpy as jnp
    a = np.asarray([[1.5, -2.25]], np.float32)
    states = {"port": {"a": torch.from_numpy(a).to(torch.bfloat16),
                       "b": torch.tensor([3.14159e-8, 1e30]),
                       "c": torch.tensor([-5, 2 ** 30], dtype=torch.int32)},
              "ref": {"a": jnp.asarray(a, jnp.bfloat16),
                      "b": np.asarray([3.14159e-8, 1e30], np.float32),
                      "c": np.asarray([-5, 2 ** 30], np.int32)}}
    tw = Twin(tmp_path, k=2)
    tw.run(lambda ck, side: ck.save(1, states[side]))
    tw.run(lambda ck, side: ck.restore(states[side], 1, failed_nodes=[2]))
    got, _ = tw.port.restore(states["port"], 1)
    assert got["a"].dtype == torch.bfloat16
    assert all(torch.equal(got[k], states["port"][k]) for k in "abc")


class TestCrashConsistency:
    def test_steps_ignores_uncommitted(self, tmp_path):
        tw = Twin(tmp_path)
        tw.run(save(1))

        def orphans(ck, side):
            (ck.dir / "step_000002.tmp").mkdir()
            (ck.dir / "step_000003").mkdir()
            (ck.dir / "step_000003" / "node_01.a.npy").write_bytes(b"x")
            return ck.steps(), ck.restore(leaves_of(side, make_state()))

        tw.run(orphans)

    def test_recover_sweeps_orphans(self, tmp_path):
        tw = Twin(tmp_path)
        tw.run(save(1))

        def orphans(ck, side):
            (ck.dir / "step_000002.tmp").mkdir()
            (ck.dir / "step_000002.tmp" / "junk").write_bytes(b"x")
            (ck.dir / "step_000003").mkdir()
            (ck._step_dir(1) / "node_01.a.npy.tmp").write_bytes(b"x")
            removed = ck.recover()
            return (sorted(removed), tio.count_tmp_orphans(ck.dir),
                    ck.steps(), ck.scrub(1))

        out = tw.run(orphans)
        assert out[0] == ("step_000001/node_01.a.npy.tmp",
                          "step_000002.tmp", "step_000003")

    def test_recover_runs_at_construction(self, tmp_path):
        for side, mod, spec, extra in (("port", tck, TSpec,
                                        {"device": "cpu"}),
                                       ("ref", rck, RSpec, {})):
            (tmp_path / side / "step_000009.tmp").mkdir(parents=True)
            mod.MSRCheckpointer(tmp_path / side, spec.make(2, 257), **extra)
            assert tio.count_tmp_orphans(tmp_path / side) == 0

    def test_manifest_carries_content_crcs(self, tmp_path):
        tw = Twin(tmp_path)
        m = tw.run(save(4))
        assert len(dict(m[1])["'crc'"][1]) == 2 * 8
        tw.run(lambda ck, side: (ck.repair_node(4, 1), ck.scrub(4)))

    def test_save_heals_transient_faults(self, tmp_path):
        tw = Twin(tmp_path, k=2, faults=[{"op": "write", "kind": "transient",
                                          "times": 3}])
        tw.run(save(1))
        tw.run(restore(1))
        tw.run(lambda ck, side: ck.retry_stats.summary())
        assert tw.port.retry_stats.retries >= 3

    def test_persistent_fault_gives_up_leaves_no_generation(self, tmp_path):
        tw = Twin(tmp_path, k=2, faults=[{"op": "write",
                                          "match": "step_000002",
                                          "kind": "transient"}])
        tw.run(save(1))
        out = tw.run(save(2), raises=True)
        assert out[:2] == ("exc", "GiveUpError")
        tw.run(lambda ck, side: (ck.steps(),
                                 tio.count_tmp_orphans(ck.dir)))
        tw.run(restore())

    def test_overwrite_same_step_is_atomic(self, tmp_path):
        tw = Twin(tmp_path)
        tw.run(save(1, seed=1))
        tw.run(save(1, seed=2))
        tw.run(lambda ck, side: ck.steps())
        tw.run(restore(1, seed=1))
        tw.run(lambda ck, side: ck.scrub(1))


class TestWriteBehind:
    def test_save_async_roundtrip_and_barrier(self, tmp_path):
        tw = Twin(tmp_path)

        def script(ck, side):
            fut = ck.save_async(7, leaves_of(side, make_state()))
            manifest = ck.barrier()
            return manifest, fut.done(), ck.barrier(), \
                ck.restore(leaves_of(side, make_state()), 7)

        tw.run(script)
        tw.close()

    def test_snapshot_isolates_from_mutation(self, tmp_path):
        """The snapshot is the state AT CALL TIME: an in-place update of
        the caller's tensor right after save_async (the torch form of
        buffer donation) does not reach the checkpoint."""
        tw = Twin(tmp_path)

        def script(ck, side):
            w = np.arange(64, dtype=np.int32)
            state = {"w": torch.from_numpy(w.copy()) if side == "port"
                     else w.copy()}
            ck.save_async(1, state)
            state["w"] += 999
            ck.barrier()
            got, _ = ck.restore({"w": w}, 1)
            assert np.array_equal(np.asarray(got["w"]), w)
            return got

        tw.run(script)
        tw.close()

    def test_single_inflight(self, tmp_path):
        tw = Twin(tmp_path)

        def script(ck, side):
            for s in (1, 2, 3):
                ck.save_async(s, leaves_of(side, make_state(s)))
            ck.barrier()
            return ck.steps(), ck.restore(leaves_of(side, make_state()), 3)

        tw.run(script)
        tw.close()

    def test_failure_surfaces_at_barrier(self, tmp_path):
        tw = Twin(tmp_path, k=2, faults=[{"op": "write",
                                          "match": "step_000002",
                                          "kind": "transient"}])

        def script(ck, side):
            ck.save_async(2, leaves_of(side, make_state()))
            try:
                ck.barrier()
            except (rio.GiveUpError, tio.GiveUpError) as e:
                return type(e).__name__, ck.steps()
            return "no error"

        assert tw.run(script) == ("GiveUpError", ())
        tw.close()


# ------------------------------------------------- across the two packages
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("failed", [(), (5,), (2, 9, 14)])
def test_step_saved_by_one_package_restores_in_the_other(tmp_path, writer,
                                                         failed):
    """[16, 8] over GF(257) with several stream tiles: a step one package
    saved, restored by the other on the systematic, regenerate and
    reconstruct+repair paths — the state bit-exact, and the pairs the
    reader rewrote equal, byte for byte, to the writer's own files."""
    state = make_state(3)
    kw = {"save_tile_symbols": 1000}
    port = tck.MSRCheckpointer(tmp_path, TSpec.make(8, 257), device="cpu",
                               **kw)
    ref = rck.MSRCheckpointer(tmp_path, RSpec.make(8, 257), **kw)
    w, r = (ref, port) if writer == "ref" else (port, ref)
    w.save(4, leaves_of("ref" if w is ref else "port", state))
    before = dir_state(tmp_path)
    for f in failed:
        for path in r._node_files(4, f):
            path.unlink()
    got, rep = r.restore(leaves_of("ref" if r is ref else "port", state), 4,
                         failed_nodes=failed)
    assert rep.path == {0: "systematic", 1: "regenerate"}.get(
        len(failed), "reconstruct")
    assert rep.repaired_nodes == tuple(failed)
    assert norm(got) == norm(state)
    assert dir_state(tmp_path) == before


def test_files_byte_identical_at_production_width(tmp_path):
    """The same state saved by each package: manifest.json and every
    node file equal byte for byte (an .npz by its members)."""
    state = make_state(8)
    tck.MSRCheckpointer(tmp_path / "port", TSpec.make(8, 257), device="cpu",
                        save_tile_symbols=777).save(2, as_torch(state))
    rck.MSRCheckpointer(tmp_path / "ref", RSpec.make(8, 257),
                        save_tile_symbols=777).save(2, state)
    got, want = dir_state(tmp_path / "port"), dir_state(tmp_path / "ref")
    assert [name for name, _ in got] == [name for name, _ in want]
    assert len(got) == 1 + 1 + 2 * 16              # step dir, manifest, 32
    assert got == want
    m = json.loads((tmp_path / "port" / "step_000002" / "manifest.json")
                   .read_text())
    assert m["tree"] == json.loads((tmp_path / "ref" / "step_000002" /
                                    "manifest.json").read_text())["tree"]


# --------------------------------------------------------- store-backed mode
def test_store_backed_save_restore_over_twin_stores():
    stores, cks = [], []
    for mod, spec, store_mod, extra, tree in (
            (tck, TSpec, tstore, {"device": "cpu"}, as_torch(make_state(6))),
            (rck, RSpec, rstore, {}, make_state(6))):
        st = store_mod.CodedObjectStore(spec.make(2, 257), n_nodes=6,
                                        stripe_symbols=32, **extra)
        ck = mod.MSRCheckpointer(None, store=st, leaf_group_bytes=1500)
        ck.save(1, tree)
        ck.save(2, tree)
        st.fail_node(3)
        cks.append((ck, tree))
        stores.append(st)
    outs = [(ck.steps(), ck.restore(tree, 2), ck.recover())
            for ck, tree in cks]
    assert norm(outs[0]) == norm(outs[1])
    assert norm([s._shares for s in stores][0]) == \
        norm([s._shares for s in stores][1])
    for ck, tree in cks:
        with pytest.raises(ValueError):
            ck.restore(tree, 2, failed_nodes=[1])
        with pytest.raises(RuntimeError):
            ck.scrub(2)
    got, rep = cks[0][0].restore(cks[0][1], 1)
    assert rep.path == "store" and got["opt"]["mu"].device.type == "cpu"


def test_checkpointer_validation(tmp_path):
    # a 2-shard mesh (on ["cpu"] * 2) now works: the step directory it
    # writes is the unsharded checkpointer's, byte for byte
    from repro_torch.sharding.mesh import StreamMesh
    digests = []
    for name, mesh in (("plain", None),
                       ("meshed", StreamMesh(2, devices=["cpu"] * 2))):
        ck = tck.MSRCheckpointer(tmp_path / name, TSpec.make(2, 257),
                                 mesh=mesh, save_tile_symbols=64,
                                 device="cpu")
        assert (ck.code.planner.mesh is None) == (mesh is None)
        ck.save(1, as_torch(make_state()))
        ck.close()
        digests.append(chip_smoke.ckpt_digest(tmp_path / name
                                              / "step_000001"))
    assert digests[0] == digests[1]
    with pytest.raises(ValueError):
        tck.MSRCheckpointer(tmp_path, None, device="cpu")
    st = tstore.CodedObjectStore(TSpec.make(2, 257), device="cpu")
    with pytest.raises(ValueError):
        tck.MSRCheckpointer(tmp_path, store=st)
    with pytest.raises(ValueError):
        tck.MSRCheckpointer(None, TSpec.make(3, 257), store=st)


def test_defaults_to_the_card(tmp_path, no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.MSRCheckpointer(tmp_path, TSpec.make(2, 257))


# ---------------------------------------------------- write-behind, in place
def test_write_behind_survives_in_place_update(tmp_path):
    """save_async, then every leaf updated in place at once (weights,
    moments, the step counter): the saved step is the state before."""
    ck = tck.MSRCheckpointer(tmp_path, TSpec.make(4, 257), device="cpu",
                             save_tile_symbols=512)
    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((300, 41), generator=gen).to(torch.bfloat16),
             "m": torch.randn((300, 41), generator=gen),
             "step": torch.tensor(12, dtype=torch.int64)}
    before = {k: v.clone() for k, v in state.items()}
    ck.save_async(12, state)
    for v in state.values():
        v.add_(1)
    ck.barrier()
    got, rep = ck.restore(state, 12)
    assert rep.path == "systematic"
    assert all(torch.equal(got[k], before[k]) for k in state)
    ck.close()


# ------------------------------------------------------------ known answer
def test_checkpoint_known_answer_digest_pinned(tmp_path):
    """The digest chip_smoke.py holds the card's checkpoint to is the
    reference's, and the port on the CPU reproduces it."""
    state = chip_smoke.ckpt_known_state(np)
    want = chip_smoke.ckpt_rehearsal(rck.MSRCheckpointer, RSpec,
                                     tmp_path / "ref", state)
    assert want == chip_smoke.KA_CKPT_SHA256
    assert chip_smoke.ckpt_rehearsal(
        tck.MSRCheckpointer, TSpec, tmp_path / "port", as_torch(state),
        device="cpu") == want
