"""Blob backend (the port of ``repro.io.blob``): the byte-level I/O seam
(DESIGN.md §12.1).

Every file the checkpointer touches goes through a :class:`BlobBackend`
— writes, reads, renames, directory listings.  The seam exists so the
drill harness can wrap it (`repro_torch.io.faults.FaultyBlob`) and inject
torn writes, corrupt or partial reads, transient ``OSError``s and
per-node latency WITHOUT monkeypatching numpy or the filesystem; the
production implementation (:class:`LocalBlob`) is a thin, fsync-honest
local-filesystem backend.

Durability contract of :class:`LocalBlob`:

* :meth:`write` is *full-or-raise at the API level* but NOT atomic on
  disk — a crash (or an injected torn write) can leave a prefix.  The
  commit protocols one layer up (`MSRCheckpointer.save`'s
  stage-directory rename, the ``*.tmp`` + :meth:`rename` single-file
  protocol) are what make torn bytes unreachable;
* every write is fsync'd before returning, so a completed ``rename``
  publishes bytes that are actually on the platter;
* :meth:`fsync_dir` flushes directory entries (the rename itself).
"""
from __future__ import annotations

import os
import pathlib
import shutil
from typing import Union

PathLike = Union[str, os.PathLike]


class BlobBackend:
    """Abstract byte-level storage backend (the fault-injection seam)."""

    def write(self, path: PathLike, data: bytes) -> None:
        raise NotImplementedError

    def read(self, path: PathLike) -> bytes:
        raise NotImplementedError

    def exists(self, path: PathLike) -> bool:
        raise NotImplementedError

    def isdir(self, path: PathLike) -> bool:
        raise NotImplementedError

    def listdir(self, path: PathLike) -> list[str]:
        raise NotImplementedError

    def mkdir(self, path: PathLike) -> None:
        raise NotImplementedError

    def rename(self, src: PathLike, dst: PathLike) -> None:
        raise NotImplementedError

    def remove(self, path: PathLike) -> None:
        raise NotImplementedError

    def rmtree(self, path: PathLike) -> None:
        raise NotImplementedError

    def fsync_dir(self, path: PathLike) -> None:
        raise NotImplementedError


class LocalBlob(BlobBackend):
    """Local filesystem backend with fsync'd writes.

    Parameters
    ----------
    fsync : bool
        Flush file contents to stable storage on every :meth:`write`
        (and directory entries on :meth:`fsync_dir`).  Default True —
        the commit protocol's rename barrier is only meaningful if the
        bytes it publishes are durable.  Turn off for throwaway test
        dirs where wall time matters more than crash safety.
    """

    def __init__(self, *, fsync: bool = True):
        self.fsync = fsync

    def write(self, path: PathLike, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())

    def read(self, path: PathLike) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: PathLike) -> bool:
        return os.path.exists(path)

    def isdir(self, path: PathLike) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: PathLike) -> list[str]:
        return sorted(os.listdir(path))

    def mkdir(self, path: PathLike) -> None:
        os.makedirs(path, exist_ok=True)

    def rename(self, src: PathLike, dst: PathLike) -> None:
        os.rename(src, dst)

    def remove(self, path: PathLike) -> None:
        os.remove(path)

    def rmtree(self, path: PathLike) -> None:
        shutil.rmtree(path)

    def fsync_dir(self, path: PathLike) -> None:
        if not self.fsync:
            return
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def count_tmp_orphans(root: PathLike) -> int:
    """Uncommitted ``*.tmp`` entries under ``root`` (one level deep plus
    inside committed step directories) — the drill harness's
    zero-orphans assertion after recovery."""
    root = pathlib.Path(root)
    if not root.exists():
        return 0
    n = 0
    for entry in root.iterdir():
        if entry.name.endswith(".tmp"):
            n += 1
        elif entry.is_dir():
            n += sum(1 for f in entry.iterdir() if f.name.endswith(".tmp"))
    return n


__all__ = ["BlobBackend", "LocalBlob", "count_tmp_orphans", "PathLike"]
