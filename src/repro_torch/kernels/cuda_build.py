"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through ``ctypes``.  Libraries go to
``build/`` at the repository root (ignored by git), named by a hash of
their source so an edited kernel is never served from a stale build.
Building happens at first use, never at import: the CPU-only test host
has no ``nvcc``.  :func:`build` starts one ``nvcc`` per source at once.

Building and loading hold one lock, so threads that make a kernel's
first call together (the sharded scanner calls its AND hook from a
thread pool) run one ``nvcc`` and load the library once; each temporary
output is named by process and thread.  The wrappers' launch counters
are bumped under :data:`counter_lock`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: library name -> CUDA source in ``csrc/``
SOURCES = {"pushdown": "pushdown.cu", "scan": "scan.cu",
           "bitvector_reduce": "bitvector_reduce.cu",
           "substring_match": "substring_match.cu",
           "key_value": "key_value.cu",
           "flash_attention": "flash_attention.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
#: held while building or loading a library (reentrant: load builds)
_lock = threading.RLock()
#: held by every kernel wrapper while it adds one to its launch counter
counter_lock = threading.Lock()
#: ptxas report (registers, shared memory, spills) per library built here
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> float:
    """Compile the named libraries that are not built yet, all at once.

    Returns the wall seconds spent; raises with the compiler's output if
    any build fails.
    """
    with _lock:
        return _build(list(SOURCES) if names is None else list(names))


def _build(names: list[str]) -> float:
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[n]}:\n{out}")
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.

    ``signatures`` maps an exported function to its ``(argtypes,
    restype)``; they are set once, under the lock, before any caller
    sees them (ctypes makes a function object at its first lookup, so
    two threads typing it at once could each type a different one).
    Every library exports ``ciao_error_string(int) -> const char*``.
    """
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.ciao_error_string.argtypes = [ctypes.c_int]
            lib.ciao_error_string.restype = ctypes.c_char_p
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
    return lib


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype[shape]`` on ``device``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype}{list(shape)}, "
                         f"got {t.dtype}{list(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise with CUDA's message if a launch returned an error code."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ciao_error_string(err).decode())
