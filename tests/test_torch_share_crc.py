"""The store's share check, `share_crc`, in its native library
(`csrc/share_crc.cpp`, built by `kernels/_build.py` with the host's C++
compiler) against the reference's formula.

Held here, on the CPU: each native path (carry-less multiply, table),
called by its own entry point, equals the reference's `share_crc` and the
port's numpy formula at every length around the fold's 16- and 64-byte
steps, with no 256, some and all 256 in the redundancy block, on corrupt
symbols, on rows of a (T, n, S) array and on a strided view; threads
checking at once get the serial values and the path counter loses no
check; a put leaves the reference's ledger; a rotten share still raises
after its re-reads; and the build: without `nvcc`, keyed by source and
flags, the numpy path where no compiler is found, and an error where a
compiler fails."""
import os
import shutil
import sys
import threading

import numpy as np
import pytest

import repro.store as rstore
from repro.core.circulant import CodeSpec as RSpec
from repro.store.object_store import share_crc as ref_share_crc
from repro_torch.codes import crc as crc_module
from repro_torch.core.circulant import CodeSpec as TSpec
from repro_torch.kernels import _build
from repro_torch.store import CodedObjectStore, ShareIntegrityError
from repro_torch.store.object_store import share_crc, share_crc_paths

LENGTHS = (1, 15, 16, 63, 64, 65, 4095, 4096, (1 << 20) + 3)
DEADLINE_S = 60.0


def native():
    mod = _build.load_host("share_crc")
    if mod is None:
        pytest.skip("no C++ compiler on this host: share_crc takes numpy")
    return mod


def entry(path):
    mod = native()
    if path == "clmul" and not mod.has_clmul():
        pytest.skip("this CPU lacks PCLMULQDQ or SSE4.1")
    return getattr(mod, f"share_crc_{path}")


def share(n, kind, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, n).astype(np.int32)
    if kind == "no256":
        r = rng.integers(0, 256, n).astype(np.int32)
    elif kind == "some256":
        r = rng.integers(0, 257, n).astype(np.int32)
    elif kind == "all256":
        r = np.full(n, 256, np.int32)
    else:                                   # corrupt: any int32 symbol
        a = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        r = rng.integers(-300, 600, n).astype(np.int32)
    return a, r


@pytest.mark.parametrize("path", ["clmul", "table"])
@pytest.mark.parametrize("case", [f"{kind}-{n}" for kind in
                                  ("no256", "some256", "all256", "corrupt")
                                  for n in LENGTHS]
                         + ["rows", "strided"])
def test_native_paths_equal_the_reference(path, case):
    crc = entry(path)
    if case == "rows":
        rng = np.random.default_rng(7)
        blocks = rng.integers(0, 257, (3, 8, 4096)).astype(np.int32)
        red = rng.integers(0, 257, (3, 8, 4096)).astype(np.int32)
        pairs = [(blocks[t, j], red[t, j]) for t in range(3) for j in range(8)]
    elif case == "strided":
        a, r = share(8192, "some256", 8)
        pairs = [(a[::2], r[::2]), (a.reshape(64, 128)[:, 3:90],
                                    r.reshape(64, 128)[:, 3:90])]
    else:
        kind, n = case.rsplit("-", 1)
        pairs = [share(int(n), kind, int(n))]
    for a, r in pairs:
        want = ref_share_crc(a, r)
        assert crc_module._share_crc_numpy(a, r) == want
        assert share_crc(a, r) == want
        if a.flags.c_contiguous and r.flags.c_contiguous:
            assert crc(a, r) == want
        else:   # the entry point takes only C-contiguous int32
            assert crc(a, r) is None
            assert crc(np.ascontiguousarray(a), np.ascontiguousarray(r)) \
                == want


def test_other_dtypes_are_converted_first():
    a, r = share(1000, "some256", 3)
    want = ref_share_crc(a, r)
    assert native().share_crc(a.astype(np.int64), r) is None
    assert share_crc(a.astype(np.int64), r.astype(np.int64)) == want
    assert share_crc(a.astype(np.uint8), r) == want
    assert share_crc(list(a), list(r)) == want


def test_path_counter_counts_each_check_once():
    mod = native()
    a, r = share(4096, "some256", 11)
    before = share_crc_paths()
    share_crc(a, r)
    share_crc(a[::2], r[::2])               # converted: one check all the same
    mod.share_crc_table(a, r)
    mod.share_crc_table(a[::2], r)          # refused: not counted
    after = share_crc_paths()
    best = "clmul" if mod.has_clmul() else "table"
    delta = {k: after[k] - before[k] for k in after}
    want = {"clmul": 0, "table": 1, "numpy": 0}
    want[best] += 2
    assert delta == want


def test_threads_checking_at_once_get_the_serial_values():
    """More threads than cores, switching often, each on its own shares of
    2^16 symbols (long enough for the unlocked CRCs to overlap): every
    value is the serial one and the counter loses no check."""
    native()
    threads = max(8, 2 * (os.cpu_count() or 1))
    rounds = 12
    shares = [share(1 << 16, "some256", 100 + i) for i in range(threads)]
    serial = [share_crc(a, r) for a, r in shares]
    got = [[] for _ in range(threads)]
    start = threading.Barrier(threads)

    def work(i):
        start.wait()
        for _ in range(rounds):
            got[i].append(share_crc(*shares[i]))

    before = sum(share_crc_paths().values())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,), daemon=True)
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(DEADLINE_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    assert got == [[c] * rounds for c in serial]
    assert sum(share_crc_paths().values()) - before == threads * rounds


@pytest.mark.parametrize("S", [4096, 1 << 16])
def test_put_leaves_the_reference_ledger(S):
    native()
    k, nodes = 4, 12
    payload = np.random.default_rng(S).integers(
        0, 256, size=2 * 2 * k * S + 123, dtype=np.uint8).tobytes()
    port = CodedObjectStore(TSpec.make(k, 257), n_nodes=nodes,
                            stripe_symbols=S, device="cpu")
    ref = rstore.CodedObjectStore(RSpec.make(k, 257), n_nodes=nodes,
                                  stripe_symbols=S)
    before = share_crc_paths()
    with port:
        got = port.put("obj", payload).share_crcs
        checks = share_crc_paths()
        red = [s[2] for held in port._shares for s in held.values()]
    want = ref.put("obj", payload).share_crcs
    assert got == want and len(got) == 3
    assert any((np.asarray(r) == 256).any() for r in red)
    assert checks["numpy"] == before["numpy"]
    assert sum(checks.values()) - sum(before.values()) == 3 * 2 * k


def test_flipped_symbol_raises_after_its_rereads():
    native()
    k, S = 4, 4096
    store = CodedObjectStore(TSpec.make(k, 257), n_nodes=12, stripe_symbols=S,
                             device="cpu")
    with store:
        store.put("obj", bytes(range(256)) * 64)
        phys = store.placement_of("obj", 0)[2]
        assert store._read_share_verified(phys, "obj", 0)
        store._shares[phys - 1][("obj", 0)][2][S // 2] ^= 1
        before = sum(share_crc_paths().values())
        with pytest.raises(ShareIntegrityError) as err:
            store._read_share_verified(phys, "obj", 0, attempts=3)
        assert sum(share_crc_paths().values()) - before == 3
    assert err.value.phys == phys and err.value.stripe == 0


# ------------------------------------------------------------------ build
@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build directory and source tree of the test's own, nothing
    loaded, and the store's CRC not yet resolved."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(_build.CSRC / "share_crc.cpp", csrc / "share_crc.cpp")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_HOST_MODULES", {})
    monkeypatch.setattr(crc_module, "_native_crc", None)
    return csrc


def test_host_library_builds_without_nvcc(fresh_build, monkeypatch):
    compiler = _build.host_compiler()
    if compiler is None:
        pytest.skip("no C++ compiler on this host")
    which = shutil.which
    monkeypatch.setattr(shutil, "which",
                        lambda name, *a, **kw: None if name == "nvcc"
                        else which(name, *a, **kw))
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert _build.build_host("share_crc", compiler) > 0.0
    assert _build.library_path("share_crc").exists()
    assert _build.build_host("share_crc", compiler) == 0.0     # reused
    a, r = share(5000, "some256", 5)
    assert share_crc(a, r) == ref_share_crc(a, r)
    assert crc_module._native_crc is _build._HOST_MODULES["share_crc"]


def test_host_library_name_is_keyed_by_source_and_flags(fresh_build,
                                                        monkeypatch):
    so = _build.library_path("share_crc")
    assert so.parent == _build.BUILD_DIR and so.suffix == ".so"
    assert so.name.startswith("share_crc-")
    assert _build.library_path("share_crc") == so
    assert "-march=native" not in _build.host_flags()
    src = fresh_build / "share_crc.cpp"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _build.library_path("share_crc")
    assert edited != so
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-O2",))
    assert _build.library_path("share_crc") not in (so, edited)


def test_no_compiler_takes_the_numpy_formula(fresh_build, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name, *a, **kw: None)
    a, r = share(3000, "some256", 9)
    before = share_crc_paths()
    assert share_crc(a, r) == ref_share_crc(a, r)
    assert share_crc(a[::3], r[::3]) == ref_share_crc(a[::3], r[::3])
    after = share_crc_paths()
    assert crc_module._native_crc is False
    assert after == {**before, "numpy": before["numpy"] + 2}
    assert not _build.BUILD_DIR.exists()


def test_broken_source_raises_where_a_compiler_is(fresh_build):
    if _build.host_compiler() is None:
        pytest.skip("no C++ compiler on this host")
    (fresh_build / "share_crc.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed for share_crc.cpp"):
        _build.load_host("share_crc")
    a, r = share(64, "no256", 1)
    with pytest.raises(RuntimeError, match="failed for share_crc.cpp"):
        share_crc(a, r)
    assert not _build.library_path("share_crc").exists()
