"""ctypes bindings to the native host library (graph algorithms, MatrixMarket).

The port's counterpart of ``prealps_tpu/native.py``. The sources are
byte-equal copies of the JAX package's ``native/graph.cpp`` and
``native/mmio.cpp`` under ``prealps_tpu_torch/csrc/host/``
(``tests/test_torch_native.py`` holds them equal), built with the flags of
``native/Makefile`` (``g++ -O3 -fPIC -std=c++17 -Wall -Wextra -shared``),
so that the k-way partition, RCM order, vertex separator and MatrixMarket
load are bitwise the JAX package's native results.

The library is built on first use into ``prealps_tpu_torch/_build/`` (the
file name carries a hash of the sources, the compiler and its flags), under
an exclusive ``flock`` on ``_build/.host.lock`` and written under a
temporary name that is renamed into place, as ``ops/_kernels.py`` builds
the CUDA kernels. ``available()`` keeps the JAX meaning: False when the
library cannot be built or loaded, and then ``core/partition.py`` runs its
Python algorithms, as the JAX package does. ``build_info`` records the
compiler's time and log, or why the library did not load.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp

_PKG = Path(__file__).resolve().parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
SOURCES = ("graph.cpp", "mmio.cpp")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_state: dict = {}
build_info: dict = {}   # path, seconds, log; or error when the build failed


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _target() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update((HOST_SRC / src).read_bytes())
    h.update(" ".join((_cxx(),) + CXXFLAGS).encode())
    return BUILD_DIR / f"libprealps_host_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the host library into ``out`` unless another process did
    while this one waited for the lock."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".host.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released on close or exit
        if out.is_file():
            build_info.update(path=str(out), seconds=0.0, log="(cached)")
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cxx(), *CXXFLAGS, "-o", str(tmp),
               *(str(HOST_SRC / s) for s in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        build_info.update(path=str(out), seconds=secs,
                          log=(proc.stdout + proc.stderr).strip())


def _lib():
    """The loaded library, or None when it cannot be built or loaded (the
    outcome is kept: a failed build is not retried in this process)."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        lib = None
        try:
            out = _target()
            if out.is_file():
                build_info.update(path=str(out), seconds=0.0, log="(cached)")
            else:
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as err:
            build_info.update(error=f"{type(err).__name__}: {err}")
            lib = None
        if lib is not None:
            lib.prealps_kway.argtypes = [
                ctypes.c_int, _i32p, _i32p, ctypes.c_int, ctypes.c_int, _i32p]
            lib.prealps_rcm.argtypes = [ctypes.c_int, _i32p, _i32p, _i32p]
            lib.prealps_vertex_separator.argtypes = [
                ctypes.c_int, _i32p, _i32p, _i32p, _i8p]
            lib.prealps_mm_open.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.prealps_mm_fill.argtypes = [ctypes.c_void_p, _i32p, _i32p, _f64p]
            for fn in (lib.prealps_kway, lib.prealps_rcm, lib.prealps_vertex_separator,
                       lib.prealps_mm_open, lib.prealps_mm_fill):
                fn.restype = ctypes.c_int
        _state["lib"] = lib
        return lib


def available() -> bool:
    """Whether the native library is built and loadable."""
    return _lib() is not None


def _need():
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable: "
                           + build_info.get("error", "not built"))
    return lib


def _adj_int32(a: sp.spmatrix):
    from prealps_tpu_torch.core.partition import _adjacency

    adj = _adjacency(a)
    return adj.indptr.astype(np.int32), adj.indices.astype(np.int32), adj.shape[0]


def kway_partition(a: sp.spmatrix, k: int, refine_passes: int = 8) -> np.ndarray:
    """Part id of each vertex of A's graph (native/graph.cpp prealps_kway)."""
    lib = _need()
    indptr, indices, n = _adj_int32(a)
    part = np.empty(n, dtype=np.int32)
    rc = lib.prealps_kway(n, indptr, indices, k, refine_passes, part)
    if rc:
        raise RuntimeError(f"prealps_kway failed rc={rc}")
    return part.astype(np.int64)


def rcm_order(a: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee order of A's graph (prealps_rcm)."""
    lib = _need()
    indptr, indices, n = _adj_int32(a)
    perm = np.empty(n, dtype=np.int32)
    rc = lib.prealps_rcm(n, indptr, indices, perm)
    if rc:
        raise RuntimeError(f"prealps_rcm failed rc={rc}")
    return perm.astype(np.int64)


def vertex_separator(a: sp.spmatrix, part: np.ndarray) -> np.ndarray:
    """Boolean separator marking covering every cut edge of ``part``
    (prealps_vertex_separator)."""
    lib = _need()
    indptr, indices, n = _adj_int32(a)
    in_sep = np.empty(n, dtype=np.int8)
    rc = lib.prealps_vertex_separator(
        n, indptr, indices, np.ascontiguousarray(part, dtype=np.int32), in_sep)
    if rc:
        raise RuntimeError(f"prealps_vertex_separator failed rc={rc}")
    return in_sep.astype(bool)


def load_mtx(path: str) -> sp.csr_matrix:
    """MatrixMarket coordinate file -> CSR, symmetric storage expanded,
    duplicates summed, indices sorted (prealps_mm_open / prealps_mm_fill)."""
    lib = _need()
    handle = ctypes.c_void_p()
    n, m, nnz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.prealps_mm_open(str(path).encode(), ctypes.byref(handle),
                             ctypes.byref(n), ctypes.byref(m), ctypes.byref(nnz))
    if rc:
        raise RuntimeError(f"prealps_mm_open failed rc={rc} for {path}")
    row = np.empty(nnz.value, dtype=np.int32)
    col = np.empty(nnz.value, dtype=np.int32)
    val = np.empty(nnz.value, dtype=np.float64)
    lib.prealps_mm_fill(handle, row, col, val)     # frees the handle
    csr = sp.coo_matrix((val, (row, col)), shape=(n.value, m.value)).tocsr()
    csr.sum_duplicates()
    csr.sort_indices()
    return csr
