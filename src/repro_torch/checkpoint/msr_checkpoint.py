"""MSR-coded distributed checkpointing (the port of
``repro.checkpoint.msr_checkpoint``) — the paper's technique as the
framework's fault-tolerance layer.

Layout on disk (one directory per step, one file pair per storage node —
in a real cluster each host writes only its own pair), the reference's
byte for byte, so a step saved by either package restores in the other:

    step_000042/
      manifest.json            code spec, tree metadata, content CRCs
      node_01.a.npy            a_0   (raw systematic block: uncoded bytes)
      node_01.r.npz            r_1   (circulant redundancy block, pack257)
      ...
      node_NN.a.npy / node_NN.r.npz

Restore paths (all byte-metered):
  * happy path (all nodes up): read ONLY the n data blocks — systematic, so
    restore costs B bytes and ZERO field operations;
  * single failure: the paper's d = k+1 regeneration — read r_{i-1} from the
    previous node + k data blocks from the next k nodes:
    gamma = (k+1) * B / (2k)  (eq. 7) and rebuild node i bit-exactly, one
    ``gf_matmul`` launch per stream tile over the row sources
    ``(r_prev, next_data)``;
  * <= n-k failures, as long as k nodes survive: any-k reconstruction
    (2 blocks from each of k nodes = B bytes), one launch per stream tile
    that also re-encodes every lost pair;
  * > n-k failures: unrecoverable (raises).

Every streaming path (save, restore, repair_node, scrub) runs on a
`repro_torch.exec.Pipeline` over ``save_tile_symbols`` stream tiles: the
save is one ``circulant_encode`` launch per tile, and the planner's pinned
staging pool holds the big host buffers.  Restored leaves are tensors on
the checkpointer's device (the card by default); the reference returns
numpy leaves.

Store-backed mode (``MSRCheckpointer(None, store=...)``): redundancy is
delegated to a coded object store — one object per leaf group plus a
manifest — and restores ride the store's transparent degraded reads.

Crash consistency: every byte goes through a `repro_torch.io.BlobBackend`
wrapped in a `repro_torch.io.RetryPolicy`, and a save is *atomic*: files
land in ``step_X.tmp``, the manifest — carrying per-block content CRCs —
is written last, and one directory rename publishes the generation.
``steps()`` and ``restore`` only ever see committed generations;
``recover()`` (run at construction) removes orphaned temp dirs and
manifest-less step dirs.  ``save_async`` is the write-behind mode: each
leaf is cloned where it lies (a card tensor on the caller's current
stream, so the caller may update the state in place as soon as the call
returns) and the step is encoded and committed on a background writer —
at most ONE checkpoint in flight, ``barrier()`` is the completion fence.
"""
from __future__ import annotations

import dataclasses
import io as _pyio
import json
import pathlib
import re
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gf, placement
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.exec.pipeline import Pipeline
from repro_torch.exec.plan import planning_enabled
from repro_torch.exec.staging import staged
from repro_torch.io.blob import BlobBackend, LocalBlob
from repro_torch.io.retry import RetryPolicy, RetryStats
from repro_torch.sharding.place import Sharded

# Stream-axis tile (symbols) for the streaming encode: bounds the int32
# intermediates on device and lets host file writes overlap device compute.
SAVE_TILE_SYMBOLS = 1 << 20

_STEP_DIR_RE = re.compile(r"step_(\d+)$")


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = _pyio.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _npz_bytes(**arrs: np.ndarray) -> bytes:
    buf = _pyio.BytesIO()
    np.savez(buf, **arrs)
    return buf.getvalue()


def _crc_data(block: np.ndarray) -> int:
    """Content CRC of a systematic block (over its stored uint8 bytes)."""
    return zlib.crc32(np.ascontiguousarray(block, np.uint8).tobytes())


def _crc_red(low: np.ndarray, hi: np.ndarray) -> int:
    """Content CRC of a packed redundancy block — over the logical
    (low, hi) payload, NOT the .npz container bytes (which carry a write
    time), so a bit-exact repair rewrite keeps the manifest CRC valid."""
    c = zlib.crc32(np.ascontiguousarray(low, np.uint8).tobytes())
    return zlib.crc32(np.ascontiguousarray(hi, np.int64).tobytes(), c)


def _snapshot_leaf(x):
    """Snapshot of one tree leaf that the caller may update in place right
    after: a tensor is cloned where it lies (a card tensor on the
    caller's current stream, so program order puts the clone before the
    caller's next update), a numpy array copied, a Sharded leaf gathered
    whole into a new tensor."""
    if isinstance(x, Sharded):
        return x.gather().clone()
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return np.copy(x)
    return x


def _land_into(out: np.ndarray):
    """The consume stage of a tiled op: ``res.host()`` returns the tile in
    fresh pageable pages, then it is copied into ``out`` — that copy is
    timed as stage ``"land"`` (`repro_torch.exec.staging.stage_times`)."""
    def land(sl: slice, res) -> None:
        tile = res.host()
        with staged("land"):
            out[:, sl] = tile
    return land


@dataclasses.dataclass
class RestoreReport:
    step: int
    path: str                    # systematic | regenerate | reconstruct
    failed_nodes: tuple[int, ...]
    bytes_read: int
    bytes_total_stored: int
    repaired_nodes: tuple[int, ...] = ()


@dataclasses.dataclass
class ScrubReport:
    """Result of a degraded-read verification pass.

    A node appears in ``mismatched_nodes`` when its re-derived pair
    (regenerated from r_{i-1} + the next k data blocks through the batched
    repair engine) disagrees with the stored pair, or a manifest content
    CRC convicts one of its blocks.  A single corrupt block flags its own
    node and can flag the neighbours whose regeneration consumed it — the
    flagged set localizes, not convicts.
    """
    step: int
    nodes_checked: int
    mismatched_nodes: tuple[int, ...]
    bytes_read: int

    @property
    def clean(self) -> bool:
        return not self.mismatched_nodes


class _MeteredReader:
    """The single byte-accounting funnel for checkpoint reads: every
    node-file and store-object read submits through here and lands
    through :meth:`take`, so bytes_read accumulates in one place."""

    def __init__(self, ckpt: "MSRCheckpointer", pipe: Pipeline):
        self._ckpt = ckpt
        self._pipe = pipe
        self.bytes_read = 0

    def submit(self, ref) -> Future:
        """Async read of a node file path or a store object key."""
        return self._pipe.submit(self._ckpt._read_block, ref)

    def submit_packed(self, ref) -> Future:
        """Async read of a packed ``.npz`` redundancy block WITHOUT
        unpacking: lands ``(low, hi)`` so row-batched callers expand every
        row in one `gf.unpack257_rows`."""
        return self._pipe.submit(self._ckpt._read_packed, ref)

    def take(self, fut: Future):
        """Land one read: returns the payload, meters its bytes."""
        arr, nbytes = fut.result()
        self.bytes_read += nbytes
        return arr


class MSRCheckpointer:
    """MSR-coded checkpointing, directory- or store-backed.

    Parameters
    ----------
    directory : path or None
        Where step directories live (directory mode).
    spec : CodeSpec, optional
        The code (directory mode needs it; store mode takes the store's).
    matmul, backend :
        As for `repro_torch.core.msr.DoubleCirculantMSR`.
    keep_last : int
        Committed generations kept; older ones are removed after a save.
    save_tile_symbols : int
        Stream tile of every streaming path (one launch per tile).
    io_workers, pipeline_depth : int
        The per-operation pipeline's pool width and launch depth.
    store : repro_torch.store.CodedObjectStore, optional
        Store-backed mode: leaf groups and the manifest become objects.
    object_prefix, leaf_group_bytes :
        Store-mode object keys and leaf-group size.
    io_backend : BlobBackend, optional
        File I/O seam (fault injection); default `LocalBlob`.
    retry : RetryPolicy, optional
        How blob operations retry transient faults.
    mesh : StreamMesh | int | None, optional
        Stream-axis device mesh of the directory-mode code: the
        stream-tile save / restore pipeline runs every tile once per
        shard through the code's planner (None inherits the ambient
        ``use_mesh`` scope).  Store mode uses the store's code and mesh.
    device : torch.device or str, optional
        Where the code computes and restored leaves land; None is the CUDA
        card (raises without one), or the mesh's first device.  Store mode
        uses the store's device.

    ``repair_node``/``scrub`` are directory-mode-only (the store's
    scheduler owns repair in store mode).
    """

    def __init__(self, directory, spec: Optional[CodeSpec] = None, *,
                 matmul=None,
                 backend: Optional[str] = None, keep_last: int = 3,
                 save_tile_symbols: int = SAVE_TILE_SYMBOLS,
                 io_workers: int = 4, pipeline_depth: int = 2, store=None,
                 object_prefix: str = "ckpt",
                 leaf_group_bytes: int = 1 << 20,
                 io_backend: Optional[BlobBackend] = None,
                 retry: Optional[RetryPolicy] = None,
                 mesh=None, device=None):
        self._store = store
        self._prefix = object_prefix.rstrip("/")
        self.leaf_group_bytes = max(1, leaf_group_bytes)
        self.iob = io_backend or LocalBlob()
        self.retry = retry or RetryPolicy()
        self.retry_stats = RetryStats()
        self._writer_ex: Optional[ThreadPoolExecutor] = None
        self._inflight: Optional[Future] = None
        if store is not None:
            if directory is not None:
                raise ValueError(
                    "pass a directory OR a store, not both: store-backed "
                    "checkpoints live entirely in the object store")
            spec = spec or store.spec
            if spec is not store.spec and spec != store.spec:
                raise ValueError("spec disagrees with the store's code spec")
        elif spec is None:
            raise ValueError("directory mode needs an explicit CodeSpec")
        self.spec = spec
        self.code = store.code if store is not None else \
            DoubleCirculantMSR(spec, matmul=matmul, backend=backend,
                               mesh=mesh, device=device)
        self.device = self.code.device
        self.keep_last = keep_last
        self.save_tile_symbols = max(1, save_tile_symbols)
        self.io_workers = max(1, io_workers)
        self.pipeline_depth = max(1, pipeline_depth)
        self.dir = None
        if directory is not None:
            self.dir = pathlib.Path(directory)
            self.iob.mkdir(self.dir)
        elif store is None:
            raise ValueError("need a directory (or a store=)")
        # startup recovery: a crashed writer's orphans must not survive
        # into this process's view of the generation sequence
        self.recover()

    def _pipe(self, io_workers: Optional[int] = None) -> Pipeline:
        """One streaming engine per operation: pooled host I/O +
        depth-bounded compute/consume overlap."""
        return Pipeline(io_workers=io_workers or self.io_workers,
                        depth=self.pipeline_depth)

    def _staging_pool(self):
        """The planner's host staging pool (pinned when the code computes
        on the card), or None when the planner path is off — save,
        restore and scrub stage their big landing / pack / download
        buffers there."""
        planner = getattr(self.code, "planner", None)
        if planner is None or not planning_enabled():
            return None
        return planner.staging

    # ------------------------------------------------------------------ paths
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:06d}"

    def _okey(self, step: int, name: str) -> str:
        """Store-object key for one piece of a checkpoint step."""
        return f"{self._prefix}/step_{step:06d}/{name}"

    def _node_files(self, step: int, i: int) -> tuple[pathlib.Path, pathlib.Path]:
        """(data_path, redundancy_path) for node v_i at `step`."""
        d = self._step_dir(step)
        return d / f"node_{i:02d}.a.npy", d / f"node_{i:02d}.r.npz"

    # ------------------------------------------------------ retried blob I/O
    def _write_blob(self, path: pathlib.Path, data: bytes, *,
                    atomic: bool = False) -> None:
        """Retry-wrapped backend write.  ``atomic=True`` uses the
        single-file tmp+rename protocol — required for any write into an
        already-committed generation (repair/restore rewrites)."""
        if atomic:
            tmp = path.parent / (path.name + ".tmp")
            self.retry.call(lambda: self.iob.write(tmp, data),
                            op=f"write:{path.name}", stats=self.retry_stats)
            self.retry.call(lambda: self.iob.rename(tmp, path),
                            op=f"rename:{path.name}", stats=self.retry_stats)
        else:
            self.retry.call(lambda: self.iob.write(path, data),
                            op=f"write:{path.name}", stats=self.retry_stats)

    def _read_bytes(self, path: pathlib.Path) -> bytes:
        return self.retry.call(lambda: self.iob.read(path),
                               op=f"read:{path.name}",
                               stats=self.retry_stats)

    def _load(self, path: pathlib.Path):
        """np.load through the retried backend (npy and npz payloads)."""
        return np.load(_pyio.BytesIO(self._read_bytes(path)))

    def _write_node_pair(self, a_path: pathlib.Path, r_path: pathlib.Path,
                         a_block: np.ndarray, r_low: np.ndarray,
                         r_hi: np.ndarray) -> None:
        # repair writes land in committed generations: atomic per file
        self._write_blob(a_path, _npy_bytes(a_block.astype(np.uint8)),
                         atomic=True)
        self._write_blob(r_path, _npz_bytes(low=r_low, hi=r_hi), atomic=True)

    def steps(self) -> list[int]:
        """Committed generations only: a step counts iff its manifest
        exists."""
        if self._store is not None:
            pre = f"{self._prefix}/step_"
            return sorted(int(key[len(pre):].split("/")[0])
                          for key in self._store.keys()
                          if key.startswith(pre)
                          and key.endswith("/manifest"))
        out = []
        for name in self.iob.listdir(self.dir):
            m = _STEP_DIR_RE.fullmatch(name)
            if m and self.iob.exists(self.dir / name / "manifest.json"):
                out.append(int(m.group(1)))
        return sorted(out)

    # --------------------------------------------------------------- recovery
    def recover(self) -> list[str]:
        """Remove the orphans a crashed writer left behind; returns what
        was removed: ``*.tmp`` staging dirs and files, ``step_*`` dirs
        without a manifest, and — store-backed — leaf-group objects of a
        step whose manifest never committed."""
        removed: list[str] = []
        if self._store is not None:
            committed = {f"{self._prefix}/step_{s:06d}/" for s in self.steps()}
            pre = f"{self._prefix}/step_"
            for key in list(self._store.keys()):
                if not key.startswith(pre):
                    continue
                gen = key.rsplit("/", 1)[0] + "/"
                if gen not in committed:
                    self._store.delete(key)
                    removed.append(key)
            return removed
        for name in self.iob.listdir(self.dir):
            p = self.dir / name
            if name.endswith(".tmp"):
                self.iob.rmtree(p) if self.iob.isdir(p) else self.iob.remove(p)
                removed.append(name)
            elif _STEP_DIR_RE.fullmatch(name) and self.iob.isdir(p):
                if not self.iob.exists(p / "manifest.json"):
                    self.iob.rmtree(p)
                    removed.append(name)
                else:
                    for f in self.iob.listdir(p):
                        if f.endswith(".tmp"):    # torn atomic rewrite
                            self.iob.remove(p / f)
                            removed.append(f"{name}/{f}")
        return removed

    # --------------------------------------------------- write-behind (async)
    def save_async(self, step: int, state: Any) -> Future:
        """Write-behind save: snapshot ``state`` and encode + commit it on
        a background writer thread while the caller keeps training.

        Each card tensor is cloned on the caller's current stream, and an
        event recorded after the clones fences the writer: its copies to
        the host run on its own stream, which waits for that event first.
        The caller may update the state in place as soon as this returns.
        At most ONE checkpoint is in flight: a second call first waits out
        (and surfaces) the previous one.  The returned future resolves to
        the manifest; :meth:`barrier` is the completion fence."""
        self.barrier()
        leaves, treedef = placement.tree_flatten(state)
        leaves = [_snapshot_leaf(x) for x in leaves]
        fences = []
        for dev in {x.device for x in leaves
                    if isinstance(x, torch.Tensor) and x.is_cuda}:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            fences.append((dev, ev))
        if self._writer_ex is None:
            self._writer_ex = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-writer")
        fut = self._writer_ex.submit(self._save_fenced, step,
                                     treedef.unflatten(leaves), fences)
        self._inflight = fut
        return fut

    def _save_fenced(self, step: int, snap: Any, fences: list) -> dict:
        for dev, ev in fences:
            torch.cuda.current_stream(dev).wait_event(ev)
        return self.save(step, snap)

    def barrier(self) -> Optional[dict]:
        """Wait for the in-flight write-behind save (if any); returns its
        manifest or re-raises its failure (typed `GiveUpError` for I/O
        give-ups).  Idempotent."""
        fut, self._inflight = self._inflight, None
        if fut is not None:
            return fut.result()
        return None

    def close(self) -> None:
        """Fence and shut down the write-behind writer thread."""
        try:
            self.barrier()
        finally:
            if self._writer_ex is not None:
                self._writer_ex.shutdown(wait=True)
                self._writer_ex = None

    # ------------------------------------------------------- store-backed save
    def _leaf_groups(self, metas: list[dict]) -> list[tuple[int, int]]:
        """Greedy (start_byte, end_byte) spans: consecutive leaves packed
        until ``leaf_group_bytes`` (one oversized leaf still gets its own
        group) — one store object per span."""
        groups: list[tuple[int, int]] = []
        start = off = 0
        size = 0
        for m in metas:
            if size and size + m["nbytes"] > self.leaf_group_bytes:
                groups.append((start, off))
                start, size = off, 0
            off += m["nbytes"]
            size += m["nbytes"]
        groups.append((start, off))
        return groups

    def _save_store(self, step: int, state: Any) -> dict:
        payload, treedef, metas = placement.pytree_to_bytes(state)
        tspec = placement.TreeSpec(treedef_repr=str(treedef), leaves=metas,
                                   total_bytes=len(payload),
                                   n_blocks=self.spec.n, block_symbols=0)
        groups = self._leaf_groups(metas)
        for gi, (lo, hi) in enumerate(groups):
            self._store.put(self._okey(step, f"g{gi:04d}"), payload[lo:hi])
        manifest = {
            "step": step, "k": self.spec.k, "p": self.spec.p,
            "c": list(self.spec.c), "tree": tspec.to_json(),
            "n_groups": len(groups),
        }
        self._store.put(self._okey(step, "manifest"),
                        json.dumps(manifest).encode())
        self._gc()
        return manifest

    # ------------------------------------------------------------------- save
    def save(self, step: int, state: Any) -> dict:
        """Streaming checkpoint save.

        The redundancy encode runs as a depth-bounded stream-tile
        pipeline: one ``circulant_encode`` launch per tile, tile t+1
        queued before tile t lands in a pooled (n, S) host buffer.  Every
        node file write goes through the pipeline's pool, so the n
        systematic writes overlap the encode; the packed redundancy
        writes follow once the last tile has landed.

        Parameters
        ----------
        step : int
            Checkpoint step id; the on-disk directory is ``step_{step:06d}``
            (staged as ``.tmp`` and renamed only after all writes land).
        state : tree
            Nested dicts / lists / tuples of tensors, numpy arrays or
            scalars (`placement.pytree_to_blocks`).

        Returns
        -------
        dict
            The manifest written alongside the node files.
        """
        if self._store is not None:
            return self._save_store(step, state)
        n = self.spec.n
        blocks, treedef, tspec = placement.pytree_to_blocks(state, n, self.spec.p)
        d = self._step_dir(step)
        tmp = d.parent / (d.name + ".tmp")
        if self.iob.exists(tmp):
            self.iob.rmtree(tmp)
        self.iob.mkdir(tmp)
        s_total = blocks.shape[1]
        tile = self.save_tile_symbols
        crcs: dict[str, int] = {}
        pool = self._staging_pool()
        stage_bufs: list[np.ndarray] = []
        try:
            with self._pipe() as pipe:
                # systematic blocks are raw bytes — no compute, write
                # immediately (retried, content CRC recorded)
                for i in range(1, n + 1):
                    pipe.submit(self._save_data_block, tmp, i,
                                blocks[i - 1], crcs)
                if pool is not None:
                    red = pool.acquire((n, s_total), np.int32)
                    low_buf = pool.acquire((n, s_total), np.uint8)
                    stage_bufs += [red, low_buf]
                else:
                    red = np.empty((n, s_total), np.int32)
                    low_buf = None
                pipe.stream_tiles(
                    s_total, tile,
                    lambda sl: self.code.encode_planned(blocks[:, sl]),
                    _land_into(red))
                # vectorized pack over all nodes at once
                low, his = gf.pack257_rows(red, out=low_buf)
                for i in range(1, n + 1):
                    pipe.submit(self._save_red_block, tmp, i,
                                low[i - 1], his[i - 1], crcs)
                # context exit joins every write and surfaces any I/O error
            # the manifest commits LAST: a generation without one is torn
            manifest = {
                "step": step, "k": self.spec.k, "p": self.spec.p,
                "c": list(self.spec.c), "tree": tspec.to_json(),
                "crc": dict(sorted(crcs.items())),
            }
            self._write_blob(tmp / "manifest.json",
                             json.dumps(manifest).encode())
            self._commit_dir(tmp, d)
        except Exception:
            # immediate cleanup when possible; a hard crash leaves the
            # orphan for recover() instead
            try:
                if self.iob.exists(tmp):
                    self.iob.rmtree(tmp)
            except OSError:
                pass
            raise
        finally:
            # the pipe context exit joined every write, so the staged
            # buffers are quiescent — safe to recycle
            if pool is not None:
                for b in stage_bufs:
                    pool.release(b)
        self._gc()
        return manifest

    def _save_data_block(self, tmp: pathlib.Path, i: int,
                         block: np.ndarray, crcs: dict) -> None:
        raw = block.astype(np.uint8)
        crcs[f"node_{i:02d}.a"] = _crc_data(raw)
        self._write_blob(tmp / f"node_{i:02d}.a.npy", _npy_bytes(raw))

    def _save_red_block(self, tmp: pathlib.Path, i: int, low: np.ndarray,
                        hi: np.ndarray, crcs: dict) -> None:
        crcs[f"node_{i:02d}.r"] = _crc_red(low, hi)
        self._write_blob(tmp / f"node_{i:02d}.r.npz",
                         _npz_bytes(low=low, hi=hi))

    def _commit_dir(self, tmp: pathlib.Path, final: pathlib.Path) -> None:
        """Publish a fully-written staging dir with one rename (an existing
        generation is parked under ``*.old.tmp`` first, so a crash at any
        point leaves either the old or the new generation committed)."""
        old = None
        if self.iob.exists(final):
            old = final.parent / (final.name + ".old.tmp")
            if self.iob.exists(old):
                self.iob.rmtree(old)
            self.retry.call(lambda: self.iob.rename(final, old),
                            op=f"park:{final.name}", stats=self.retry_stats)
        self.retry.call(lambda: self.iob.rename(tmp, final),
                        op=f"commit:{final.name}", stats=self.retry_stats)
        if old is not None:
            self.iob.rmtree(old)
        self.iob.fsync_dir(final.parent)

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            if self._store is not None:
                pre = self._okey(s, "")
                for key in self._store.keys():
                    if key.startswith(pre):
                        self._store.delete(key)
            else:
                try:
                    self.iob.rmtree(self._step_dir(s))
                except OSError:
                    pass

    # ------------------------------------------------------------- block I/O
    def _read_block(self, ref) -> tuple[np.ndarray, int]:
        """One read -> (array, bytes read) — both backends.

        ``ref`` is a node-file path (``.npz`` is a packed redundancy
        block, anything else a raw systematic byte block) or a
        store-object key string (the object's payload bytes, metered by
        the store's transfer receipt)."""
        if isinstance(ref, str):
            res = self._store.get_ext(ref)
            return np.frombuffer(res.obj, np.uint8), res.bytes_read
        if ref.suffix == ".npz":
            z = self._load(ref)
            low, hi = z["low"], z["hi"]
            return gf.unpack257(low, hi), low.nbytes + hi.nbytes
        arr = self._load(ref)
        return arr.astype(np.int32), arr.nbytes

    def _read_packed(self, ref) -> tuple[tuple[np.ndarray, np.ndarray], int]:
        """One packed redundancy read -> ((low, hi), bytes), not unpacked."""
        z = self._load(ref)
        low, hi = z["low"], z["hi"]
        return (low, hi), low.nbytes + hi.nbytes

    # ---------------------------------------------------- tiled decode stages
    def _regenerate_tiled(self, pipe: Pipeline, node: int,
                          r_prev: np.ndarray,
                          next_data: np.ndarray) -> np.ndarray:
        """Stream-tile pipeline over the planned fused regenerate: one
        ``gf_matmul`` launch of the (2, k+1) repair matrix per tile over
        the row sources (r_prev, next_data)."""
        out = np.empty((2, r_prev.shape[-1]), np.int32)
        pipe.stream_tiles(
            r_prev.shape[-1], self.save_tile_symbols,
            lambda sl: self.code.repair.regenerate_planned(
                node, r_prev[sl], next_data[:, sl]),
            _land_into(out))
        return out

    def _decode_tiled(self, pipe: Pipeline, mat: np.ndarray,
                      downloads: np.ndarray) -> np.ndarray:
        """Stream-tile pipeline for (mat @ downloads) mod p — the any-k
        decode (and, with repair rows stacked, the lost-pair re-encode):
        one launch per tile."""
        out = np.empty((mat.shape[0], downloads.shape[-1]), np.int32)
        pipe.stream_tiles(
            downloads.shape[-1], self.save_tile_symbols,
            lambda sl: self.code.repair.apply_planned(mat, downloads[:, sl]),
            _land_into(out))
        return out

    # ---------------------------------------------------------------- restore
    def restore(self, template: Any, step: Optional[int] = None,
                failed_nodes: Sequence[int] = (), *, repair: bool = True,
                ) -> tuple[Any, RestoreReport]:
        """Rebuild the tree, repairing failed nodes along the way.

        Parameters
        ----------
        template : tree
            Any tree with the stored structure (values unused).
        step : int, optional
            Checkpoint step; None restores the latest.
        failed_nodes : sequence of int
            1-indexed dead hosts — their files are treated as unreadable.
        repair : bool
            When True the missing pairs are rebuilt bit-exactly and
            re-written to disk (the newcomer protocol); False only
            reconstructs the data in memory.

        Returns
        -------
        (state, report) : (tree, RestoreReport)
            The rebuilt tree, its leaves tensors on the checkpointer's
            device, and the byte-metered restore path taken
            (``systematic`` | ``regenerate`` | ``reconstruct``).

        Raises
        ------
        RuntimeError
            Fewer than k of the n nodes survive (> n - k failures).
        """
        if step is None:
            step = self.steps()[-1]
        if self._store is not None:
            return self._restore_store(template, step, failed_nodes)
        d = self._step_dir(step)
        manifest = json.loads(self._read_bytes(d / "manifest.json"))
        tspec = placement.TreeSpec.from_json(manifest["tree"])
        n, k = self.spec.n, self.spec.k
        failed = sorted(set(failed_nodes))
        alive = [i for i in range(1, n + 1) if i not in failed]
        if len(alive) < k:
            raise RuntimeError(f"unrecoverable: only {len(alive)} of n={n} "
                               f"nodes alive, need k={k}")
        repaired: list[int] = []

        with self._pipe() as pipe:
            reader = _MeteredReader(self, pipe)
            read_async, result = reader.submit, reader.take

            if not failed:
                futs = [read_async(self._node_files(step, i)[0])
                        for i in range(1, n + 1)]
                data = np.stack([result(f) for f in futs])
                path = "systematic"
            elif len(failed) == 1 and repair:
                f = failed[0]
                plan = self.code.repair_plan(f)
                fut_prev = read_async(self._node_files(step, plan.prev_node)[1])
                futs_help = [read_async(self._node_files(step, j)[0])
                             for j in plan.next_nodes]
                # the non-helper blocks are needed for the full restore
                # anyway — their reads overlap the regenerate compute
                rest = [i for i in range(1, n + 1)
                        if i != f and (i - 1) not in plan.data_indices]
                futs_rest = {i: read_async(self._node_files(step, i)[0])
                             for i in rest}
                r_prev = result(fut_prev)
                next_data = np.stack([result(x) for x in futs_help])
                pair = self._regenerate_tiled(pipe, f, r_prev, next_data)
                a_new, r_new = pair[0], pair[1]
                af, rf = self._node_files(step, f)
                low, hi = gf.pack257(r_new)
                pipe.submit(self._write_node_pair, af, rf, a_new, low, hi)
                repaired.append(f)
                data = np.zeros((n, tspec.block_symbols), np.int32)
                have = dict(zip(plan.data_indices, next_data))
                have[f - 1] = a_new
                for i in range(1, n + 1):
                    idx = i - 1
                    data[idx] = have[idx] if idx in have else result(futs_rest[i])
                path = "regenerate"
            else:
                use = alive[:k]                      # sorted by construction
                futs = [read_async(self._node_files(step, i)[0]) for i in use]
                futs_r = [reader.submit_packed(self._node_files(step, i)[1])
                          for i in use]
                # the (2k, S) download matrix stages in a pooled buffer:
                # data rows land in the top half as the reads resolve,
                # the redundancy rows expand into the bottom half in one
                # vectorized unpack
                pool = self._staging_pool()
                s_sym = tspec.block_symbols
                downloads = (pool.acquire((2 * k, s_sym), np.int32)
                             if pool is not None
                             else np.empty((2 * k, s_sym), np.int32))
                for j, x in enumerate(futs):
                    downloads[j] = result(x)
                packed = [result(x) for x in futs_r]
                gf.unpack257_rows(np.stack([lo for lo, _ in packed]),
                                  [hi for _, hi in packed],
                                  out=downloads[k:])
                if repair and failed:
                    # one decode launch per tile yields the data AND every
                    # lost pair
                    mat = self.code.repair.decode_repair_matrix(
                        tuple(use), failed)
                    data, red_f = self.code.repair.split_decode_output(
                        self._decode_tiled(pipe, mat, downloads))
                    low_f, his_f = gf.pack257_rows(red_f)
                    for j, fl in enumerate(failed):
                        af, rf = self._node_files(step, fl)
                        pipe.submit(self._write_node_pair, af, rf,
                                    data[fl - 1], low_f[j], his_f[j])
                        repaired.append(fl)
                else:
                    mat = self.code.repair.decode_matrix(tuple(use))
                    data = self._decode_tiled(pipe, mat, downloads)
                if pool is not None:
                    # every decode tile has landed — quiescent
                    pool.release(downloads)
                path = "reconstruct"
            # context exit joins the repaired-pair writes

        treedef = placement.tree_flatten(template)[1]
        state = placement.blocks_to_pytree(np.asarray(data, np.int32),
                                           treedef, tspec, self.device)
        total = 2 * n * tspec.block_symbols          # ~bytes (packed storage)
        report = RestoreReport(step=step, path=path,
                               failed_nodes=tuple(failed),
                               bytes_read=reader.bytes_read,
                               bytes_total_stored=total,
                               repaired_nodes=tuple(repaired))
        return state, report

    def _restore_store(self, template: Any, step: int,
                       failed_nodes: Sequence[int]) -> tuple[Any, RestoreReport]:
        """Store-backed restore: get the leaf-group objects back through
        the store's transparent read path (systematic when healthy, one
        decode launch per failure pattern otherwise) and reassemble.

        ``failed_nodes`` must be empty — which *store* nodes are dead is
        the store's internal state, and repair is its scheduler's job.
        """
        if failed_nodes:
            raise ValueError(
                "store-backed restore takes no failed_nodes: the store "
                "serves degraded reads transparently and its scheduler "
                "owns repair")
        manifest_raw, mbytes = self._read_block(self._okey(step, "manifest"))
        manifest = json.loads(bytes(manifest_raw))
        tspec = placement.TreeSpec.from_json(manifest["tree"])
        # store objects are in-memory: serial reads through the shared
        # metering funnel (no I/O latency to hide with a pool)
        with self._pipe(io_workers=1) as pipe:
            reader = _MeteredReader(self, pipe)
            reader.bytes_read += mbytes
            futs = [reader.submit(self._okey(step, f"g{gi:04d}"))
                    for gi in range(manifest["n_groups"])]
            payload = b"".join(reader.take(f).tobytes() for f in futs)
        leaves = placement.bytes_to_leaves(payload, tspec.leaves, self.device)
        state = placement.tree_flatten(template)[1].unflatten(leaves)
        total = sum(
            2 * self._store.n * st.n_stripes * st.stripe_symbols
            for key in self._store.keys()
            if key.startswith(self._okey(step, ""))
            for st in (self._store.stat(key),))
        report = RestoreReport(step=step, path="store", failed_nodes=(),
                               bytes_read=reader.bytes_read,
                               bytes_total_stored=total)
        return state, report

    # -------------------------------------------------------------- accounting
    def gamma_bytes(self, tspec_block_symbols: int, *, mode: str) -> int:
        """Ideal byte counts (packed symbols ~ 1 byte each) for the three
        restore paths — eq. (7) and §III-B of the paper."""
        s = tspec_block_symbols
        if mode == "regenerate":
            return (self.spec.k + 1) * s
        if mode == "reconstruct":
            return 2 * self.spec.k * s
        if mode == "systematic":
            return self.spec.n * s
        raise ValueError(mode)

    def repair_node(self, step: int, node: int) -> int:
        """The newcomer protocol in isolation: rebuild node's (a, r) pair
        from d = k+1 reads (fused tiled regenerate).  Returns bytes read
        (the measured gamma).  Directory mode only."""
        self._require_directory("repair_node")
        plan = self.code.repair_plan(node)
        with self._pipe() as pipe:
            reader = _MeteredReader(self, pipe)
            fut_prev = reader.submit(self._node_files(step, plan.prev_node)[1])
            futs = [reader.submit(self._node_files(step, j)[0])
                    for j in plan.next_nodes]
            r_prev = reader.take(fut_prev)
            helpers = [reader.take(f) for f in futs]
            pair = self._regenerate_tiled(pipe, node, r_prev,
                                          np.stack(helpers))
            af, rf = self._node_files(step, node)
            low, hi = gf.pack257(pair[1])
            pipe.submit(self._write_node_pair, af, rf, pair[0], low, hi)
        return reader.bytes_read

    def _require_directory(self, op: str) -> None:
        if self._store is not None:
            raise RuntimeError(
                f"{op} is directory-mode only: store-backed checkpoints "
                f"delegate node repair/verification to the store's "
                f"scheduler")

    # ------------------------------------------------------------------ scrub
    def scrub(self, step: int) -> ScrubReport:
        """Degraded-read verification pass over one checkpoint step.

        Reads EVERY node pair, checks the manifest's content CRCs, and
        re-derives each pair from its d = k+1 helpers through the batched
        fused engine (one launch per stream tile for all n nodes),
        comparing bit-exactly against what is stored.  A clean scrub
        certifies that every single-node repair of this step would
        succeed bit-exactly.

        Returns
        -------
        ScrubReport
            ``mismatched_nodes`` localizes damage; ``clean`` is True when
            every pair verified.
        """
        self._require_directory("scrub")
        n = self.spec.n
        manifest = json.loads(
            self._read_bytes(self._step_dir(step) / "manifest.json"))
        crcs = manifest.get("crc") or {}
        with self._pipe() as pipe:
            reader = _MeteredReader(self, pipe)
            futs_a = [reader.submit(self._node_files(step, i)[0])
                      for i in range(1, n + 1)]
            futs_r = [reader.submit_packed(self._node_files(step, i)[1])
                      for i in range(1, n + 1)]
            rows_a = [reader.take(f) for f in futs_a]
            packed = [reader.take(f) for f in futs_r]
            data = np.stack(rows_a)
            # manifest content CRCs convict a damaged block exactly (the
            # algebraic pass below only localizes); checked when present
            mismatched: set[int] = set()
            for i in range(1, n + 1):
                ca = crcs.get(f"node_{i:02d}.a")
                cr = crcs.get(f"node_{i:02d}.r")
                if ca is not None and _crc_data(rows_a[i - 1]) != ca:
                    mismatched.add(i)
                if cr is not None and _crc_red(*packed[i - 1]) != cr:
                    mismatched.add(i)
            # all n redundancy rows expanded in ONE vectorized unpack —
            # into a pooled staging buffer, recycled after the last tile
            pool = self._staging_pool()
            low_all = np.stack([lo for lo, _ in packed])
            red_buf = (pool.acquire(low_all.shape, np.int32)
                       if pool is not None else None)
            red = gf.unpack257_rows(low_all, [hi for _, hi in packed],
                                    out=red_buf)
            nodes = list(range(1, n + 1))
            prev = np.asarray([self.code.repair_plan(i).prev_node - 1
                               for i in nodes])
            helper_idx = np.asarray([self.code.repair_plan(i).data_indices
                                     for i in nodes])              # (n, k)

            def flag(sl: slice, res) -> None:
                out = res.host()
                bad = ((out[:, 0] != data[:, sl]).any(axis=1)
                       | (out[:, 1] != red[:, sl]).any(axis=1))
                mismatched.update(int(x) + 1 for x in np.nonzero(bad)[0])

            # compare tile t while t+1 computes, through the planned
            # batched engine (F = n is a fixed batch bucket)
            pipe.stream_tiles(
                data.shape[1], self.save_tile_symbols,
                lambda sl: self.code.repair.regenerate_batch_planned(
                    nodes, red[:, sl][prev], data[:, sl][helper_idx]),
                flag)
            if pool is not None:
                pool.release(red)       # last tile flagged — quiescent
        return ScrubReport(step=step, nodes_checked=n,
                           mismatched_nodes=tuple(sorted(mismatched)),
                           bytes_read=reader.bytes_read)


__all__ = ["MSRCheckpointer", "RestoreReport", "ScrubReport",
           "SAVE_TILE_SYMBOLS"]
