"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

The sources live in ``prealps_tpu_torch/csrc``. On first use they are
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface under ``prealps_tpu_torch/_build/`` (the file name carries a hash
of the sources, so an edited source is rebuilt), then loaded with ctypes.
Nothing is built or loaded at import time, and there is no fallback: a
missing ``nvcc`` or a failed build raises.

Tensors are passed as raw device pointers (``Tensor.data_ptr()``) and the
launch goes to ``torch.cuda.current_stream()``; the C functions return the
launch's ``cudaGetLastError()``.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("stencil_flat.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # path, seconds, compiler log of the loaded library


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from prealps_tpu_torch/csrc on first use")
    return found


def _build() -> Path:
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libprealps_kernels_{digest}.so"
    if out.is_file():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=secs,
                      log=(proc.stdout + proc.stderr).strip())
    return out


def load() -> ctypes.CDLL:
    """Build (once) and load the kernel library; returns the ctypes handle."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            ptr, c_int = ctypes.c_void_p, ctypes.c_int
            lib.prealps_stencil_flat_f32.argtypes = [
                ptr, ptr, ptr, ctypes.POINTER(c_int), c_int, c_int, c_int,
                c_int, c_int, c_int, ptr]
            lib.prealps_stencil_flat_f32.restype = c_int
            lib.prealps_max_offsets.argtypes = []
            lib.prealps_max_offsets.restype = c_int
            lib.prealps_cuda_error_string.argtypes = [c_int]
            lib.prealps_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.prealps_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stencil_flat_f32(blocks: torch.Tensor, offsets: tuple,
                     x_ext: torch.Tensor, y: torch.Tensor, halo: int,
                     br: int, t: int) -> None:
    """Launch the flat stencil kernel writing into ``y`` (checked by the
    caller: CUDA, f32, contiguous, shapes consistent)."""
    lib = load()
    n_off = len(offsets)
    if n_off > lib.prealps_max_offsets():
        raise ValueError(f"{n_off} stencil offsets; the kernel takes at most "
                         f"{lib.prealps_max_offsets()}")
    offs = (ctypes.c_int * n_off)(*offsets)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = lib.prealps_stencil_flat_f32(
        blocks.data_ptr(), x_ext.data_ptr(), y.data_ptr(), offs, n_off,
        br, t, y.shape[1], halo, y.device.index or 0, stream)
    _check(lib, rc, "stencil_flat_ext launch")
