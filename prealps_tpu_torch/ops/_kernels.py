"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

The sources live in ``prealps_tpu_torch/csrc``, one kernel family per file.
On first use every source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` into a shared library with a plain C
interface under ``prealps_tpu_torch/_build/`` (each file name carries a hash
of its source and flags, so an edited source is rebuilt), then loaded with
ctypes. Nothing is built or loaded at import time, and there is no
fallback: a missing ``nvcc`` or a failed build raises. Processes that load
at once (the ranks of a sharded solve) are safe: the build runs under an
exclusive lock on ``_build/.lock`` (``flock``, released when its holder
exits), so one process builds and the others, once it is done, find the
libraries; each library is written under a temporary name and renamed into
place, so none is ever seen half written.

Tensors are passed as raw device pointers (``Tensor.data_ptr()``) and the
launch goes to ``torch.cuda.current_stream()``; the C functions return the
launch's ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import fcntl
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
SOURCES = ("stencil.cu", "block_ell.cu", "bj_apply.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_info: dict = {}   # source -> path, seconds, compiler log of its library

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {         # C entry point -> (argtypes, restype)
    "prealps_stencil": ([_P, _I, _P, _P, ctypes.POINTER(_I)] + [_I] * 10
                        + [_P], _I),
    "prealps_stencil_max_offsets": ([], _I),
    "prealps_block_ell_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "prealps_bj_apply_f32": ([_P, _P, _P] + [_I] * 8 + [_P], _I),
    "prealps_bj_apply_max_rows": ([_I, _I], _I),
    "prealps_cuda_error_string": ([_I], ctypes.c_char_p),
}


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


def _target(src: str) -> Path:
    digest = hashlib.sha256((CSRC / src).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def _build_all() -> dict:
    """Compile every source that has no up-to-date library, in parallel;
    returns source -> library path."""
    outs = {src: _target(src) for src in SOURCES}
    if all(out.is_file() for out in outs.values()):
        for src in SOURCES:
            build_info[src] = dict(path=str(outs[src]), seconds=0.0, log="(cached)")
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released on close or exit
        _build_locked(outs)
    return outs


def _build_locked(outs: dict) -> None:
    """The build under the lock: whatever another process built while this
    one waited counts as cached."""
    todo = [src for src, out in outs.items() if not out.is_file()]
    for src in SOURCES:
        if src not in todo:
            build_info[src] = dict(path=str(outs[src]), seconds=0.0, log="(cached)")
    if todo:
        nvcc = _nvcc()
        procs = {}
        for src in todo:
            tmp = outs[src].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (cmd, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, (cmd, tmp, t0, proc) in procs.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
                continue
            os.replace(tmp, outs[src])
            build_info[src] = dict(path=str(outs[src]), seconds=secs, log=log.strip())
        if failed:
            raise RuntimeError("\n\n".join(failed))


def load() -> dict:
    """Build (once) and load the kernel libraries; returns source -> ctypes
    handle."""
    with _lock:
        if not _libs:
            for src, path in _build_all().items():
                lib = ctypes.CDLL(str(path))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    if hasattr(lib, name):
                        fn = getattr(lib, name)
                        fn.argtypes, fn.restype = argtypes, restype
                _libs[src] = lib
    return _libs


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.prealps_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


_BLOCK_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def stencil(blocks: torch.Tensor, offsets: tuple, x: torch.Tensor,
            y: torch.Tensor, *, br: int, t: int, nrb: int, ncol: int,
            lead: int, kmajor: bool, wrap: bool, planar: bool,
            what: str) -> None:
    """Launch the stencil kernel writing into ``y`` (checked by the caller:
    CUDA, contiguous, shapes consistent; x and y f32 with blocks f32, or
    bf16 on the lane-major maps; or x, y and blocks f64 on the lane-major
    maps). The index maps are those of ``csrc/stencil.cu``:
    ``kmajor`` (panel row k·t + j, else j·br + k), ``wrap`` (columns mod
    nrb, else r + lead + off of an extended panel of ``ncol`` columns) and
    ``planar`` (blocks (br, S·br, nrb), else (S, br, br, nrb)). ``what``
    names the wrapper in errors."""
    lib = load()["stencil.cu"]
    n_off = len(offsets)
    if n_off > lib.prealps_stencil_max_offsets():
        raise ValueError(f"{what}: {n_off} stencil offsets; the kernel takes "
                         f"at most {lib.prealps_stencil_max_offsets()}")
    offs = (ctypes.c_int * n_off)(*offsets)
    rc = lib.prealps_stencil(
        blocks.data_ptr(), _BLOCK_DTYPES[blocks.dtype], x.data_ptr(),
        y.data_ptr(), offs, n_off, br, t,
        nrb, ncol, lead, int(kmajor), int(wrap), int(planar),
        y.device.index or 0, _stream(y))
    _check(lib, rc, f"{what} launch")


def block_ell_f32(entries, x: torch.Tensor, y: torch.Tensor) -> None:
    """Launch the block-ELL kernel on the packed entries (``formats.py::
    BlockEllEntries``) writing into ``y`` (checked by the caller: CUDA,
    int32 / f32, contiguous, cols and vals 16-byte aligned, shapes
    consistent)."""
    lib = load()["block_ell.cu"]
    n, t = y.shape
    rc = lib.prealps_block_ell_f32(
        entries.row_ptr.data_ptr(), entries.cols.data_ptr(),
        entries.vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, t,
        y.device.index or 0, _stream(y))
    _check(lib, rc, "block_ell_spmm_pallas launch")


def bj_apply_max_rows(t: int, device: torch.device) -> int:
    """Largest block (mb rows) the block-Jacobi kernel takes at width t on
    ``device`` (its staged z block and B ring must fit one CTA's opt-in
    shared memory)."""
    return load()["bj_apply.cu"].prealps_bj_apply_max_rows(t, device.index or 0)


def bj_apply_f32(b2: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                 mb: int) -> None:
    """Launch the batched block-Jacobi kernel: lane-major z (t, br, nrb) ->
    w through the packed (nb, mbp, mbp) inverses b2, of which the first
    mb = br·nrb/nb rows and columns are read (checked by the caller: CUDA,
    f32, contiguous, shapes consistent)."""
    lib = load()["bj_apply.cu"]
    nb, mbp, _ = b2.shape
    t, br, nrb = z.shape
    rc = lib.prealps_bj_apply_f32(b2.data_ptr(), z.data_ptr(), w.data_ptr(),
                                  nb, mb, mbp, nrb // nb, br, nrb, t,
                                  w.device.index or 0, _stream(w))
    _check(lib, rc, "bj_apply_pallas launch")
