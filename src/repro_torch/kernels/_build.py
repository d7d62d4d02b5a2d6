"""Build and load the port's Hopper kernels and its host libraries.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Nothing links
against PyTorch, so a build takes seconds, not minutes.  Libraries land in
``build/kernels/`` at the repository root under a name keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  The first call that needs any kernel builds every missing
library, one ``nvcc`` per source, all started together.

Each ``csrc/*.cpp`` source (``HOST_SOURCES``) is host code: a CPython
extension module built with the host's C++ compiler (no ``nvcc``, so the
CPU tests run it too), keyed and placed the same way, and loaded on first
use by :func:`load_host`.  Its flags take no ``-march``: the build
directory can outlive the host, so a source picks its instruction sets at
run time.

Nothing here runs at import: the CPU tests import every module on hosts
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from types import ModuleType
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gf_matmul", "circulant_encode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("share_crc",)
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_HOST_MODULES: dict[str, ModuleType] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the Hopper "
                       "kernels build on a host with the CUDA toolkit")


def host_compiler() -> Optional[str]:
    """The host's C++ compiler, or None where it has none."""
    return shutil.which("c++")


def host_flags() -> tuple[str, ...]:
    """The host build's flags: ``HOST_FLAGS`` and this Python's headers."""
    return (*HOST_FLAGS, "-I" + sysconfig.get_paths()["include"])


def _source_and_flags(name: str) -> tuple[Path, tuple[str, ...]]:
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp", host_flags()
    return CSRC / f"{name}.cu", NVCC_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source_and_flags(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Build every missing library in parallel; return the seconds spent
    (0.0 when all were present).  Raises RuntimeError with nvcc's output
    if a build fails."""
    todo = [(n, library_path(n)) for n in SOURCES]
    todo = [(n, so) for n, so in todo if not so.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit "
                          f"{proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)        # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_host(name: str, compiler: str) -> float:
    """Build ``csrc/<name>.cpp`` with ``compiler`` if its library is
    missing; return the seconds spent.  Raises RuntimeError with the
    compiler's output if the build fails."""
    so = library_path(name)
    if so.exists():
        return 0.0
    src, flags = _source_and_flags(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    so.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed for {name}.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)                # atomic: concurrent builds agree
    return time.perf_counter() - t0


def load_host(name: str) -> Optional[ModuleType]:
    """The extension module built from ``csrc/<name>.cpp``, built on
    first use; None on a host without a C++ compiler.  Raises if the host
    has a compiler and the build fails."""
    with _LOCK:
        mod = _HOST_MODULES.get(name)
        if mod is None:
            compiler = host_compiler()
            if compiler is None:
                return None
            build_host(name, compiler)
            loader = importlib.machinery.ExtensionFileLoader(
                name, str(library_path(name)))
            mod = importlib.util.module_from_spec(
                importlib.util.spec_from_loader(name, loader))
            loader.exec_module(mod)
            _HOST_MODULES[name] = mod
        return mod


def build_log(name: str) -> str:
    """The compiler's output (nvcc and ptxas for a kernel) of the last
    build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")


__all__ = ["BUILD_DIR", "HOST_FLAGS", "HOST_SOURCES", "SOURCES", "build_all",
           "build_host", "build_log", "check", "host_compiler", "host_flags",
           "library_path", "load", "load_host", "nvcc_path"]
