#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (prealps_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero before a result is printed):
 1. the card: ``nvidia-smi`` name and power limit, torch's device name;
 2. build the CUDA kernels from prealps_tpu_torch/csrc (one nvcc per
    source, all started together, sm_90a);
 3. the headline path's build at full size: elasticity3d 36³ (n = 147,852),
    stencil format, two-level block Jacobi (240-row blocks), ECG t = 12;
 4. ``[kernel]`` B1 (``stencil_flat_ext``) against its plain PyTorch version
    on the card, at the shapes the path gives it (t = 12 for the solver,
    t = 1 for the refinement residual) plus a br = 1 and a generic shape;
    CUDA-event times of both (median of 5 batches of 20 back-to-back calls
    each, in turns plain, kernel, kernel, plain);
 5. ``[main]`` the headline path: launch counts zeroed, one solve of
    b = default_rng(0).standard_normal(n) to tol 1e-5 (f32 with
    double-float refinement), counts read back; then three timed solves
    and one under torch.profiler (chiprun_out/profile_solve.txt);
 6. ``[small]`` a small f32 solve on the card against a scipy direct solve;
 7. the general-sparse path's build at full size: the same operator,
    fmt="block_ell" (bm 8, bk 128), host block Jacobi (240-row blocks), ECG
    t = 12 odir_fused on row-major panels;
 8. ``[kernel]`` B5 (``block_ell_spmm_pallas``) against ``block_ell_spmm``
    at the path's shape (t = 12), at t = 1 and at bk = 8, timed in turns;
 9. ``[general]`` the general path: counts zeroed, one warm solve and three
    timed solves; host f64 relres < 1e-5, no breakdown, B5 launches >=
    iterations, iterations within 5 % of GENERAL_ANCHOR_ITERS (the JAX
    package's CPU run of the same build with fmt="block_ell_xla"); one solve
    under torch.profiler (chiprun_out/profile_general.txt);
10. ``[ell]`` fmt="ell" f32 at elasticity3d 20³ through the device
    double-float refinement rounds;
11. ``[bj]`` the stencil path with precond="bj" (block Jacobi alone, the
    JAX driver's "bj_flat") at full size, within 5 % of the JAX package's
    TPU record of 199 iterations;
12. ``[kernel]`` B6 (``bj_apply_pallas``) on the [bj] build's packed
    inverses at t = 12 against its plain version, with ``torch.bmm`` on the
    unpadded inverses (the driver's apply) timed beside them (and again on
    the [dia] build's 1024-row inverses in phase 16);
13. ``[lorasc]`` the single-GPU LORASC path at full size:
    ``StencilLorascECG.build`` of heterogeneous elasticity3d 36³ (nparts 8,
    ECG t = 12 omin, max_deflation 256, balancing ("deflate") correction,
    f32 with double-float refinement) as ``bench.py`` configures its het
    LORASC record; build stages, band shapes, deflated pairs (held to the
    record's 97 within 10 %) and peak device memory;
14. ``[kernel]`` B2a (``stencil_bsr_spmm_t_pallas_bs``) on that build's
    operator at t = 12, 8, 1 and the build's nev, and B2b
    (``stencil_pallas_bs_ext``) at t = 1, each against its plain version,
    timed in turns;
15. ``[lorasc]`` the path's solve: launch counts zeroed, one warm solve to
    1e-5 (host f64 relres, no breakdown, iterations within 10 % of the
    record's 65, B2a launches >= 3 × iterations, B2b launched), counts read
    back; three timed solves; ``with_tol(1e-8)`` to relres < 1e-8 (the
    record: 128 iterations); one solve under torch.profiler
    (chiprun_out/profile_lorasc.txt) with its device-busy share;
16. ``[dia]`` fmt="dia" on lane-major panels at full size: elasticity3d 36³,
    its promoted diagonals (97 after RAC scaling, plus an ELL remainder) as
    a br = 1 stencil, device block Jacobi (1024-row blocks) from the
    diagonals, ECG t = 12, f32 with host-f64 refinement to 1e-5;
    ``[kernel]`` B1 on that table (t 12, t 1) and B1 (t 12, t 1) and B2b
    (t 12) at br 1 × D 99 on the unscaled operator's table; B6 on the
    build's packed block inverses (nb 145, mb 1024, t 12) beside
    ``torch.bmm``; the solve with
    B1's count zeroed
    (launches >= iterations, iterations within 10 % of DIA_ANCHOR_ITERS,
    the JAX package's CPU run of the same build); one solve under
    torch.profiler (chiprun_out/profile_dia.txt) with its device-busy share;
17. ``[auto]`` fmt="auto" on BENCH_r05.json's structure-hidden record
    (elasticity3d 20³ under ``default_rng(5).permutation``, bj with
    240-row blocks, t = 12 on ``nt``, f32, tol 1e-5): the cascade must
    choose Morton block-ELL, iterations within 10 % of the record's 100;
18. ``[spmm]`` the SpMM format sweep (prealps_tpu_torch.examples.bench_spmm)
    at nel = 36, t = 1, 4, 8, 12, 16, all five formats, its JSON lines
    printed; each format's y held to the ELL product within the kernel
    bound; B3 (``stencil_t_pallas``) launched;
20-24. the rest of the one-GPU driver, each a full-size f32 build of the
    headline operator (t 12, odir_fused on tbn, tol 1e-5, device
    double-float refinement) and a solve with B1's count zeroed before it
    and read after it (launches >= iterations), then three timed solves:
    ``[cheb]`` precond="chebyshev" (degree 8, κ 30; bench.py's
    PREALPS_BENCH_PRECOND=chebyshev): iterations within 10 % of
    CHEB_ANCHOR_ITERS, B1 launches >= 8 × iterations, one solve under
    torch.profiler (chiprun_out/profile_cheb.txt);
    ``[dedup]`` precond="bj" with grid= and the default bj_dedupe: x-line
    blocks (37 nodes), "bj_dedup", iterations within 10 % of
    DEDUP_ANCHOR_ITERS; ``[bj_lane]`` bj_dtype="bf16" without dedup: the
    apply's device time beside bj_apply_flat (information), w in f32,
    iterations <= max(1.3 × [bj]'s, [bj]'s + 12); ``[bj2l_nogrid]`` the
    headline with grid=None: iterations within 10 % of
    BJ2L_NOGRID_ANCHOR_ITERS; ``[omin_stacked]`` the headline build solved
    with variant="omin", stacked and unstacked: the stacked count within
    ±1 of the unstacked count plus one per inner solve (the stacked state's
    stop test reads the residual entering the iteration, as in the JAX
    package).

Beside the headline B1 checks, ``[kernel]`` lines hold B3 at t = 12 / 8 / 1
and B4 (planar) at t = 12 on the headline operator against their plain
versions. Every ``[kernel]`` line gives the kernel's and the plain
version's CUDA-event times, its bound (the larger of the bytes the
product needs -- each input read once, each output written once, the
stencil panel without its halo columns, B6's inverses unpadded -- over
3.35 TB/s and its flops over 67 TFLOP/s f32) and, at each kernel's
first shape, the library yardstick: ``torch.sparse.mm`` of the same
operator as a CSR matrix on the row-major (n, t) panel (cuSPARSE SpMM), and
for B6 ``torch.bmm`` of the unpadded inverses.

The last lines of standard output are a ``[summary]`` JSON line (every
check, every path's numbers), the card's ``nvidia-smi`` name and power
limit, the kernels' JSON record (seven entries; ``ms``/``plain_ms``/
``bound_ms``/``library_ms`` at each kernel's first shape and, under
``shapes``, at every shape checked; ``max_abs_err`` over its shapes,
``launches`` from its path's run — for B4 and B6, which no path runs,
chip_smoke's own calls; B1's entry also lists its count on every path's
solve under ``path_launches``), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-5          # max |y_kernel - y_plain| <= KERNEL_TOL * max(|B|·|x|)
SOLVE_TOL = 1e-5
TPU_ANCHOR_ITERS = 130     # iterations of the same solve in the JAX package's record
# the general path (block-ELL, host block Jacobi, nt, f32, tol 1e-5): the JAX
# package's run on a CPU with fmt="block_ell_xla" (2 host refinement rounds
# of 97 + 105 iterations, PERF.md)
GENERAL_ANCHOR_ITERS = 202
BJ_ANCHOR_ITERS = 199      # stencil + bj: BENCH_r05.json ..._t12_tol1e-5_bj
ANCHOR_BAND = 0.05
# het LORASC (BENCH_r05.json ecg_tts_elasticity3d_145k_het_lorasc): 65
# iterations and 97 deflated pairs at tol 1e-5; 128 iterations at 1e-8
LORASC_ANCHOR_ITERS = 65
LORASC_ANCHOR_PAIRS = 97
LORASC_DEEP_ANCHOR_ITERS = 128
LORASC_BAND = 0.10
# fmt="dia" on lane-major panels (elasticity3d 36³, bj, t 12, f32, tol 1e-5):
# the JAX package's run of the same build on a CPU
# (python -m tests.test_torch_anchors --nel 36: 182 iterations in 2 host
# refinement rounds, relres 1.0e-7)
DIA_ANCHOR_ITERS = 182
# fmt="auto" on the shuffled elasticity3d(20³) (BENCH_r05.json
# ecg_tts_elasticity3d_shuffled_26k_bj: Morton block-ELL, 100 iterations)
AUTO_ANCHOR_ITERS = 100
# the rest of the one-GPU driver (elasticity3d 36³, t 12, f32, tol 1e-5): the
# JAX package's runs of the same builds on a CPU
# (python -m tests.test_torch_anchors --path cheb|dedup|bj2l_nogrid --nel 36,
# each in 2 refinement rounds, relres 5.0e-7 / 5.0e-7 / 5.4e-7)
CHEB_ANCHOR_ITERS = 44          # precond="chebyshev", degree 8, κ 30
DEDUP_ANCHOR_ITERS = 234        # precond="bj", grid=, bj_dedupe: x-line blocks
BJ2L_NOGRID_ANCHOR_ITERS = 182  # precond="bj2l", grid=None
PATH_BAND = 0.10
# yardsticks: one H100 SXM's HBM3 rate and f32 rate outside the tensor cores
# (NVIDIA's data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, batches: int = 5, warm: int = 3):
    """CUDA-event time of one fn() call in ms: each of ``batches`` samples is
    ``reps`` calls back to back between two events, divided by ``reps`` (so
    the host's launch path overlaps the device work, as it does in a solve).
    Returns (median, samples)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times), times


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over the f32 rate."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOPS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def stencil_csr(blocks_t, offsets):
    """The stencil operator (S, br, br, nrb) as a torch CSR matrix on its
    device, its zero (boundary) entries dropped: the library yardstick's
    operand (torch.sparse.mm, cuSPARSE SpMM on a row-major (n, t) panel)."""
    import torch

    _, br, _, nrb = blocks_t.shape
    r = torch.arange(nrb, device=blocks_t.device)
    rows, cols, vals = [], [], []
    for s_i, off in enumerate(offsets):
        c = r + off
        inside = (c >= 0) & (c < nrb)
        for m in range(br):
            for k in range(br):
                v = blocks_t[s_i, m, k]
                keep = inside & (v != 0)
                rows.append(r[keep] * br + m)
                cols.append(c[keep] * br + k)
                vals.append(v[keep])
    n = nrb * br
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (n, n)).coalesce()
    return coo.to_sparse_csr()


def scipy_csr(a, dev):
    """A scipy CSR matrix as an f32 torch CSR matrix on the card."""
    import numpy as np
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data.astype(np.float32)), a.shape).to(dev)


def library_ms(csr, t, seed):
    """CUDA-event time of one torch.sparse.mm of the operator on an (n, t)
    panel: the library call that computes the kernel's function."""
    import numpy as np
    import torch

    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (csr.shape[1], t)).astype(np.float32)).to(csr.device)
    ms, _ = event_ms(lambda: torch.sparse.mm(csr, x), reps=10)
    return ms


def check_kernel(name, blocks_flat, offsets, halo, br, t, seed, csr=None):
    """Kernel vs plain version on the card for one shape; returns a record
    (with the cuSPARSE yardstick where ``csr`` is given)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.spmm import (
        extend_wrap,
        stencil_flat_ext,
        stencil_flat_ext_ref,
    )

    nrb = blocks_flat.shape[1]
    rng = np.random.default_rng(seed)
    xf = torch.from_numpy(rng.standard_normal((br * t, nrb)).astype(np.float32))
    x_ext = extend_wrap(xf.to(blocks_flat.device), halo).contiguous()
    y_k = stencil_flat_ext(blocks_flat, offsets, x_ext, halo, br)
    y_p = stencil_flat_ext_ref(blocks_flat, offsets, x_ext, halo, br)
    scale = stencil_flat_ext_ref(blocks_flat.abs(), offsets, x_ext.abs(), halo, br)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    # the bytes the product needs: the unextended panel (the halo columns
    # are copies of it)
    nbytes = 4 * (blocks_flat.numel() + xf.numel() + y_k.numel())
    rec = {"shape": name, "br": br, "t": t, "S": len(offsets), "nrb": nrb,
           "halo": halo, "max_abs_err": err, "err_bound": err_bound,
           **in_turns(lambda: stencil_flat_ext(blocks_flat, offsets, x_ext, halo, br),
                      lambda: stencil_flat_ext_ref(blocks_flat, offsets, x_ext, halo, br),
                      nbytes),
           **bound(nbytes, 2 * len(offsets) * br * br * t * nrb),
           "library_ms": None if csr is None else library_ms(csr, t, seed)}
    log_kernel(name, f"br={br} t={t} S={len(offsets)} nrb={nrb}", rec)
    return rec


def log_kernel(name, shape, rec):
    lib = ("" if rec.get("library_ms") is None
           else f" library {rec['library_ms']:.4f} ms")
    log(f"[kernel] {name}: {shape} max_abs_err={rec['max_abs_err']:.3e} (bound "
        f"{rec['err_bound']:.3e}) kernel {rec['ms']:.4f} ms ({rec['GBps']:.0f} "
        f"GB/s, {rec['reckoned_MB']:.1f} MB) plain {rec['plain_ms']:.4f} ms "
        f"({rec['plain_GBps']:.0f} GB/s) bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}){lib}")


def in_turns(kernel_fn, plain_fn, nbytes, reps=20):
    """CUDA-event times of a kernel and its plain version, in turns plain,
    kernel, kernel, plain; GB/s from the reckoned bytes of one call."""
    p1, pt1 = event_ms(plain_fn, reps=reps)
    k1, kt1 = event_ms(kernel_fn, reps=reps)
    k2, kt2 = event_ms(kernel_fn, reps=reps)
    p2, pt2 = event_ms(plain_fn, reps=reps)
    ms = statistics.median(kt1 + kt2)
    plain_ms = statistics.median(pt1 + pt2)
    return {"ms": ms, "plain_ms": plain_ms, "reckoned_MB": nbytes / 1e6,
            "GBps": nbytes / (ms * 1e-3) / 1e9,
            "plain_GBps": nbytes / (plain_ms * 1e-3) / 1e9,
            "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]}}


def check_lane(name, a_t, t, seed, ext=False, b3=False, csr=None):
    """B2a (B2b with ``ext``, B3 with ``b3``) against its plain version on
    the card at width t; returns a record."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.spmm import (
        extend_wrap,
        stencil_bsr_spmm_t_pallas,
        stencil_bsr_spmm_t_pallas_bs,
        stencil_pallas_bs_ext,
        stencil_scan_accumulate,
    )

    s_max, br, _, nrb = a_t.blocks_t.shape
    halo = max(abs(o) for o in a_t.offsets)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (t, br, nrb)).astype(np.float32)).to(a_t.blocks_t.device)
    x_ext = extend_wrap(x, halo).contiguous()
    if ext:
        kernel = lambda: stencil_pallas_bs_ext(a_t.blocks_t, a_t.offsets, x_ext, halo)
    elif b3:
        kernel = lambda: stencil_bsr_spmm_t_pallas(a_t, x)
    else:
        kernel = lambda: stencil_bsr_spmm_t_pallas_bs(a_t, x)
    plain = lambda: stencil_scan_accumulate(a_t.blocks_t, a_t.offsets, x_ext, halo)
    y_k = kernel()
    y_p = plain()
    scale = stencil_scan_accumulate(a_t.blocks_t.abs(), a_t.offsets, x_ext.abs(), halo)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    del scale, y_p
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    nbytes = 4 * (a_t.blocks_t.numel() + x.numel() + y_k.numel())
    rec = {"shape": name, "br": br, "t": t, "S": s_max, "nrb": nrb, "halo": halo,
           "max_abs_err": err, "err_bound": err_bound,
           **in_turns(kernel, plain, nbytes, reps=5 if t > 12 else 20),
           **bound(nbytes, 2 * s_max * br * br * t * nrb),
           "library_ms": None if csr is None else library_ms(csr, t, seed)}
    log_kernel(name, f"br={br} t={t} S={s_max} nrb={nrb}", rec)
    return rec


def check_planar(name, blocks_t, offsets, t, seed, csr=None):
    """B4 (planar panel, plane-major blocks) against its plain version on
    the card at width t; returns a record."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.spmm import (
        stencil_blocks_planar,
        stencil_spmm_planar,
        stencil_spmm_planar_ref,
    )

    s_max, br, _, nrb = blocks_t.shape
    b3 = stencil_blocks_planar(blocks_t).contiguous()
    x2 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (t, br * nrb)).astype(np.float32)).to(blocks_t.device)
    kw = dict(offsets=offsets, br=br, nrb=nrb)
    kernel = lambda: stencil_spmm_planar(b3, x2, **kw)
    plain = lambda: stencil_spmm_planar_ref(b3, x2, **kw)
    y_k = kernel()
    y_p = plain()
    scale = stencil_spmm_planar_ref(b3.abs(), x2.abs(), **kw)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    del scale, y_p
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    nbytes = 4 * (b3.numel() + x2.numel() + y_k.numel())
    rec = {"shape": name, "br": br, "t": t, "S": s_max, "nrb": nrb,
           "max_abs_err": err, "err_bound": err_bound,
           **in_turns(kernel, plain, nbytes),
           **bound(nbytes, 2 * s_max * br * br * t * nrb),
           "library_ms": None if csr is None else library_ms(csr, t, seed)}
    log_kernel(name, f"br={br} t={t} S={s_max} nrb={nrb}", rec)
    return rec


def device_busy_ms(prof) -> float:
    """Device time of a profiled window: the sum of the device events' self
    time, as torch's own table totals it."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3


def check_block_ell(name, mat, t, seed, csr=None):
    """B5 against block_ell_spmm on the card for one shape; returns a record."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.formats import BlockEllMatrix
    from prealps_tpu_torch.ops.spmm import block_ell_spmm, block_ell_spmm_pallas

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((mat.shape[1], t)).astype(
        np.float32)).to(mat.blocks.device)
    y_k = block_ell_spmm_pallas(mat, x)
    y_p = block_ell_spmm(mat, x)
    scale = block_ell_spmm(BlockEllMatrix(mat.blocks.abs(), mat.blkcols,
                                          mat.shape), x.abs())
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    del scale, y_p
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    nrb, s_max, bm, bk = mat.blocks.shape
    nbytes = (4 * (mat.blocks.numel() + x.numel() + y_k.numel())
              + 4 * mat.blkcols.numel())
    rec = {"shape": name, "nrb": nrb, "S": s_max, "bm": bm, "bk": bk, "t": t,
           "max_abs_err": err, "err_bound": err_bound,
           **in_turns(lambda: block_ell_spmm_pallas(mat, x),
                      lambda: block_ell_spmm(mat, x), nbytes, reps=10),
           **bound(nbytes, 2 * nrb * s_max * bm * bk * t),
           "library_ms": None if csr is None else library_ms(csr, t, seed)}
    log_kernel(name, f"nrb={nrb} S={s_max} bm={bm} bk={bk} t={t}", rec)
    return rec


def check_bj_apply(inv_f, br, t, seed):
    """B6 against its plain version, and torch.bmm on the unpadded inverses
    (the driver's apply), on the card; returns a record."""
    import numpy as np
    import torch

    from prealps_tpu_torch.direct.device_bj import (
        bj_apply_flat,
        bj_apply_pallas,
        bj_apply_pallas_ref,
        pack_bj_dense,
    )

    nb, mb, _ = inv_f.shape
    b2 = pack_bj_dense(inv_f)
    nrb = nb * mb // br
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (t, br, nrb)).astype(np.float32)).to(inv_f.device)
    w_k = bj_apply_pallas(b2, z, br)
    w_p = bj_apply_pallas_ref(b2, z, br)
    scale = bj_apply_pallas_ref(b2.abs(), z.abs(), br)
    torch.cuda.synchronize()
    err = float((w_k - w_p).abs().max())
    err_bmm = float((w_k - bj_apply_flat(inv_f, z)).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    if not bool(torch.isfinite(w_k).all()):
        fail("bj_apply_pallas: kernel output not finite")
    if max(err, err_bmm) > err_bound:
        fail(f"bj_apply_pallas: max|kernel - plain| = {err:.3e}, "
             f"|kernel - bmm| = {err_bmm:.3e} > {err_bound:.3e}")
    # the bytes and flops the product needs: the unpadded inverses, not the
    # kernel's table padded to mbp rows
    nbytes = 4 * (inv_f.numel() + 2 * z.numel())
    mbp = b2.shape[1]
    rec = {"shape": f"nb={nb} mb={mb} mbp={mbp} t={t}", "t": t,
           "max_abs_err": err, "max_abs_err_vs_bmm": err_bmm, "err_bound": err_bound,
           **in_turns(lambda: bj_apply_pallas(b2, z, br),
                      lambda: bj_apply_pallas_ref(b2, z, br), nbytes),
           **bound(nbytes, 2 * nb * mb * mb * t)}
    # the library yardstick: one torch.bmm of the unpadded inverses (the
    # driver's apply)
    bmm_ms, _ = event_ms(lambda: bj_apply_flat(inv_f, z))
    rec["library_ms"] = bmm_ms
    rec["bmm_GBps"] = nbytes / (bmm_ms * 1e-3) / 1e9
    log_kernel("bj_apply_pallas", rec["shape"] + f" (vs bmm {err_bmm:.3e})", rec)
    return rec


def profile_solve(solver, b, name):
    """One solve under torch.profiler; the table goes to chiprun_out/.
    Returns (device ms, wall ms) of the profiled solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(HERE, "chiprun_out", f"profile_{name}.txt"), "w") as f:
        f.write(table)
    busy_ms = device_busy_ms(prof)
    log(f"[profile] one {name} solve by device time (device {busy_ms:.1f} ms "
        f"of {wall_ms:.1f} ms wall, busy {100 * busy_ms / wall_ms:.0f} %):")
    for line in table.splitlines()[:15]:
        log("[profile] " + line)
    return busy_ms, wall_ms


def timed_solves(solver, b, iters, tag):
    """Three timed solves (host clock around work that ends in a sync)."""
    import torch

    timed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ik = solver.solve(b)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        if int(ik["iters"]) != iters or ik["breakdown"]:
            log(f"[{tag}] note: timed solve ran {ik['iters']} iterations")
    return timed


def checked_solve(solver, a, b, tag, counter=None):
    """One solve with the launch count zeroed just before and read just
    after; fails on a wrong shape, non-finite values, breakdown or host f64
    relres >= SOLVE_TOL. Returns (info dict, launches, seconds)."""
    import numpy as np
    import torch

    if counter is not None:
        counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counter.launches if counter is not None else None
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    if x.shape != (a.shape[0],) or not np.all(np.isfinite(x)):
        fail(f"[{tag}] solution not finite or of the wrong shape")
    if info["breakdown"]:
        fail(f"[{tag}] ECG breakdown")
    if not relres < SOLVE_TOL:
        fail(f"[{tag}] host f64 relres {relres:.3e} >= {SOLVE_TOL}")
    info = dict(info, relres=relres)
    info.pop("history", None)
    return info, launches, secs


def within(iters, anchor, band=ANCHOR_BAND):
    return abs(iters - anchor) <= band * anchor


def lorasc_phase(dev, nel=36):
    """Phases 13-15: the single-GPU LORASC path at full size (nel = 36).
    Returns (B2a checks, B2b checks, path record, B2a launches, B2b
    launches)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.ops.spmm import (
        stencil_bsr_spmm_t_pallas_bs,
        stencil_pallas_bs_ext,
    )
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    t0 = time.perf_counter()
    a = elasticity3d(nel, nel, nel, heterogeneous=True)
    n = a.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    log(f"[lorasc] het elasticity3d({nel}³) n={n} nnz={a.nnz} generated in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = StencilLorascECG.build(
        a, nparts=8, br=3, grid=(nel + 1, nel + 1, nel),
        opts=ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="omin",
                        layout="tbn"),
        max_deflation=256, correction="deflate", pencil="agg", inner_tol=1e-3,
        dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    pc = solver.precond
    plan = pc.plan
    ops = pc.operands
    nev = pc.nev
    if "w_lift" not in ops:
        fail("[lorasc] the deflate build attached no deflation lift")
    lift_k = ops["w_lift"].shape[0]
    log(f"[lorasc] built in {build_s:.2f} s, stages (s): {json.dumps(pc.timings)}; "
        f"ng={plan.ng} bs_i={plan.bs_i} nblk_i={plan.nblk_i} bs_g={plan.bs_g} "
        f"nblk_g={plan.nblk_g} nev={nev} lift width={lift_k} deflated="
        f"{pc.deflated} (record {LORASC_ANCHOR_PAIRS}); peak device memory "
        f"{peak_gb:.2f} GB")
    if not within(pc.deflated, LORASC_ANCHOR_PAIRS, LORASC_BAND):
        fail(f"[lorasc] {pc.deflated} deflated pairs, outside "
             f"{LORASC_ANCHOR_PAIRS} ± {100 * LORASC_BAND:.0f} %")
    log(f"[lorasc] deflated pairs {pc.deflated} within "
        f"{100 * LORASC_BAND:.0f} % of the record's {LORASC_ANCHOR_PAIRS}")

    a_t = ops["a_stencil"]
    csr = stencil_csr(a_t.blocks_t, a_t.offsets)
    b2a = [check_lane(f"lorasc {what} (br3,t{t})", a_t, t, seed=30 + t,
                      csr=csr if t == 12 else None)
           for what, t in (("ECG + apply", 12), ("Lanczos panel", 8),
                           ("refinement finish", 1), ("Rayleigh-Ritz nev", nev),
                           ("deflation lift k", lift_k))]
    b2b = [check_lane("lorasc finish A_lo·x_hi, pre-extended (br3,t1)", a_t, 1,
                      seed=41, ext=True, csr=csr)]
    del csr

    stencil_bsr_spmm_t_pallas_bs.launches = 0
    stencil_pallas_bs_ext.launches = 0
    info, _, warm_s = checked_solve(solver, a, b, "lorasc")
    la, lb = stencil_bsr_spmm_t_pallas_bs.launches, stencil_pallas_bs_ext.launches
    iters = int(info["iters"])
    log(f"[lorasc] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} breakdown="
        f"{info['breakdown']} B2a launches={la} B2b launches={lb} (record "
        f"{LORASC_ANCHOR_ITERS} iterations)")
    if la < 3 * iters:
        fail(f"[lorasc] B2a launched {la} times for {iters} iterations (< 3×)")
    if lb < 1:
        fail("[lorasc] B2b was not launched by the refinement finish")
    if not within(iters, LORASC_ANCHOR_ITERS, LORASC_BAND):
        fail(f"[lorasc] {iters} iterations, outside {LORASC_ANCHOR_ITERS} ± "
             f"{100 * LORASC_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "lorasc")
    solve_s = statistics.median(timed)
    log(f"[lorasc] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration")

    deep = solver.with_tol(1e-8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_d, info_d = deep.solve(b)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    rel_d = float(np.linalg.norm(b - a @ x_d) / np.linalg.norm(b))
    log(f"[lorasc] with_tol(1e-8): {deep_s:.3f} s, iters={info_d['iters']} "
        f"refine_rounds={info_d['refine_rounds']} relres={rel_d:.3e} (record "
        f"{LORASC_DEEP_ANCHOR_ITERS} iterations, relres 7.09e-10)")
    if not (rel_d < 1e-8) or info_d["breakdown"]:
        fail(f"[lorasc] with_tol(1e-8) reached relres {rel_d:.3e}")
    busy_ms, wall_ms = profile_solve(solver, b, "lorasc")
    log(f"[lorasc] device busy {busy_ms:.1f} ms per solve: "
        f"{100 * busy_ms / (1e3 * solve_s):.0f} % of the timed median "
        f"{1e3 * solve_s:.1f} ms (idle {100 - 100 * busy_ms / (1e3 * solve_s):.0f} %)")
    path = {"n": n, "ng": plan.ng, "bs_i": plan.bs_i, "nblk_i": plan.nblk_i,
            "bs_g": plan.bs_g, "nblk_g": plan.nblk_g, "nev": nev, "lift_k": lift_k,
            "deflated": pc.deflated, "build_s": build_s,
            "build_stages_s": pc.timings, "peak_GB": peak_gb, "iters": iters,
            "refine_rounds": info["refine_rounds"], "relres": info["relres"],
            "solve_s": timed, "ms_per_iter": 1e3 * solve_s / iters,
            "b2a_launches": la, "b2b_launches": lb,
            "deep": {"iters": info_d["iters"], "relres": rel_d, "solve_s": deep_s,
                     "refine_rounds": info_d["refine_rounds"]},
            "profile_device_ms": busy_ms, "profile_wall_ms": wall_ms,
            "anchors": {"iters": LORASC_ANCHOR_ITERS, "pairs": LORASC_ANCHOR_PAIRS,
                        "deep_iters": LORASC_DEEP_ANCHOR_ITERS}}
    return b2a, b2b, path, la, lb


def dia_phase(dev, a, b):
    """The fmt="dia" path on lane-major panels at full size: the promoted
    diagonals of elasticity3d(36³) as a br = 1 stencil through B1, device
    block Jacobi from the diagonals, f32 with host-f64 refinement. The
    scaled matrix has 97 promoted diagonals and a remainder (scaling drops
    the stencil's stored zeros); the unscaled operator's table has all 99
    and is the one of the br 1 × D 99 checks. Returns (B1 checks on both
    tables, the B2b check at br 1 × D 99, the B6 check on the path's block
    inverses, path record, B1 launches of the solve)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.formats import StencilBsrTMatrix, csr_to_dia_ell
    from prealps_tpu_torch.ops.spmm import stencil_flat_ext
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="tbn")
    t0 = time.perf_counter()
    solver = DistributedECG.build(a, nshards=1, fmt="dia", precond="bj", grid=None,
                                  opts=opts, dtype=np.float32, device=dev)
    build_s = time.perf_counter() - t0
    ops = solver.operands
    n_diags = len(ops.offsets)
    log(f"[dia] built in {build_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
        + f"; n_pad={solver.layout.n_pad} D={n_diags} diagonals, halo={ops.halo}, "
        f"remainder {'none' if ops.rem_vals is None else tuple(ops.rem_vals.shape)}; "
        f"block Jacobi nb={ops.inv_f.shape[0]} mb={ops.inv_f.shape[1]}")
    if n_diags > 512 or ops.halo > ops.nrb:
        fail(f"[dia] {n_diags} diagonals, halo {ops.halo}: the kernel takes "
             "at most 512 offsets and a halo of at most n")
    csr = stencil_csr(ops.blocks_flat[:, None, None, :], ops.offsets)
    b1 = [check_kernel(f"[dia] path table, B1 (br1,D{n_diags},t12)", ops.blocks_flat,
                       ops.offsets, ops.halo, 1, 12, seed=81, csr=csr),
          check_kernel(f"[dia] path table, B1 (br1,D{n_diags},t1)", ops.blocks_flat,
                       ops.offsets, ops.halo, 1, 1, seed=82)]
    # the unscaled operator's own DIA table: all 99 diagonals promoted (its
    # stored zeros included), no remainder. RAC scaling drops the stencil's
    # stored zeros, which leaves the scaled operator (the path's, and the
    # SpMM sweep's) 97 diagonals and 10,080 remainder entries.
    de = csr_to_dia_ell(a, min_fill=0.05, dtype=np.float32, device=dev)
    if len(de.offsets) != 99 or de.rem is not None:
        fail(f"[dia] the unscaled operator has {len(de.offsets)} diagonals "
             f"(remainder {de.rem is not None}); expected 99 and none")
    halo99 = max(abs(o) for o in de.offsets)
    dia_t = StencilBsrTMatrix(de.diags[:, None, None, :].contiguous(), de.offsets,
                              de.shape)
    b1 += [check_kernel(f"unscaled DIA table, B1 (br1,D99,t{t})", de.diags,
                        de.offsets, halo99, 1, t, seed=84 + t) for t in (12, 1)]
    b2b = [check_lane("unscaled DIA table, B2b pre-extended (br1,D99,t12)", dia_t,
                      12, seed=83, ext=True,
                      csr=stencil_csr(dia_t.blocks_t, de.offsets))]
    del csr, dia_t, de
    b6 = check_bj_apply(ops.inv_f, 1, 12, seed=86)

    info, launches, warm_s = checked_solve(solver, a, b, "dia", stencil_flat_ext)
    iters = int(info["iters"])
    log(f"[dia] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} (host f64) relres={info['relres']:.3e} "
        f"breakdown={info['breakdown']} stencil_flat_ext launches={launches} "
        f"(JAX package on a CPU: {DIA_ANCHOR_ITERS} iterations)")
    if launches < iters:
        fail(f"[dia] B1 launched {launches} times for {iters} iterations")
    if not within(iters, DIA_ANCHOR_ITERS, PATH_BAND):
        fail(f"[dia] {iters} iterations, outside {DIA_ANCHOR_ITERS} ± "
             f"{100 * PATH_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "dia")
    solve_s = statistics.median(timed)
    log(f"[dia] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration")
    busy_ms, wall_ms = profile_solve(solver, b, "dia")
    log(f"[dia] device busy {busy_ms:.1f} ms per solve: "
        f"{100 * busy_ms / (1e3 * solve_s):.0f} % of the timed median "
        f"{1e3 * solve_s:.1f} ms")
    path = {"n_pad": solver.layout.n_pad, "D": n_diags, "halo": ops.halo,
            "iters": iters, "refine_rounds": info["refine_rounds"],
            "relres": info["relres"], "launches": launches, "solve_s": timed,
            "ms_per_iter": 1e3 * solve_s / iters, "build_s": build_s,
            "build_stages_s": solver.timings, "profile_device_ms": busy_ms,
            "profile_wall_ms": wall_ms, "anchor_iters": DIA_ANCHOR_ITERS}
    return b1, b2b, b6, path, launches


def auto_phase(dev):
    """fmt="auto" on the structure-hidden record of BENCH_r05.json
    (bench.py:470-492): elasticity3d(20³) under a random symmetric
    permutation; the cascade must choose Morton block-ELL."""
    import numpy as np
    import scipy.sparse as sp

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a0 = elasticity3d(20, 20, 20, heterogeneous=False)
    n = a0.shape[0]
    rng = np.random.default_rng(5)
    pm = sp.eye(n, format="csr")[rng.permutation(n)]
    a = (pm @ a0 @ pm.T).tocsr()
    b = rng.standard_normal(n)
    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="nt")
    t0 = time.perf_counter()
    solver = DistributedECG.build(a, nshards=1, fmt="auto", precond="bj",
                                  block_size=240, opts=opts, dtype=np.float32,
                                  device=dev)
    build_s = time.perf_counter() - t0
    fi = solver.fmt_info
    log(f"[auto] shuffled elasticity3d(20³) n={n}: chose {fi['chosen']} "
        f"(layout={solver.opts.layout}) in {build_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
        + f"; scores {json.dumps(fi)}")
    if fi["chosen"] != "block_ell_morton" or solver.pre_perm is None:
        fail(f"[auto] chose {fi['chosen']}, not block_ell_morton")
    info, _, warm_s = checked_solve(solver, a, b, "auto")
    iters = int(info["iters"])
    log(f"[auto] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} (record "
        f"{AUTO_ANCHOR_ITERS} iterations)")
    if not within(iters, AUTO_ANCHOR_ITERS, PATH_BAND):
        fail(f"[auto] {iters} iterations, outside {AUTO_ANCHOR_ITERS} ± "
             f"{100 * PATH_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "auto")
    return {"n": n, "chosen": fi["chosen"], "fmt_info": fi, "iters": iters,
            "refine_rounds": info["refine_rounds"], "relres": info["relres"],
            "solve_s": timed, "build_s": build_s,
            "anchor_iters": AUTO_ANCHOR_ITERS}


def spmm_phase(dev, a):
    """The SpMM format sweep (prealps_tpu_torch.examples.bench_spmm) at
    nel = 36 on the card: every format's y held to the ELL product of the
    same panel within KERNEL_TOL · max(|A|·|x|). Returns (records, B3
    launches)."""
    import torch

    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.examples import bench_spmm
    from prealps_tpu_torch.ops.spmm import stencil_bsr_spmm_t_pallas

    a_s = sym_rac_scaling(a)[0]
    abs_csr = scipy_csr(abs(a_s), dev)
    stencil_bsr_spmm_t_pallas.launches = 0
    recs, pending = [], {}
    for rec, x, y in bench_spmm.sweep(nel=36, ts=(1, 4, 8, 12, 16), reps=10,
                                      device=dev, a=a_s):
        log("[spmm] " + json.dumps(rec))
        recs.append(rec)
        pending.setdefault(rec["t"], {})[rec["format"]] = (x, y)
        group = pending[rec["t"]]
        if len(group) < len(bench_spmm.FORMATS):
            continue
        x, y_ell = group["ell"]
        err_bound = KERNEL_TOL * float(torch.sparse.mm(abs_csr, x.abs().float()).max())
        for fmt, (_, y) in group.items():
            err = float((y - y_ell).abs().max())
            if not bool(torch.isfinite(y).all()) or err > err_bound:
                fail(f"[spmm] {fmt} t={rec['t']}: max|y - y_ell| = {err:.3e} "
                     f"> {err_bound:.3e}")
            rec_f = next(r for r in recs if r["t"] == rec["t"] and r["format"] == fmt)
            rec_f["max_abs_err_vs_ell"] = err
        del pending[rec["t"]]
    launches = stencil_bsr_spmm_t_pallas.launches
    log(f"[spmm] {len(recs)} lines, every format within KERNEL_TOL of the ELL "
        f"product; B3 (stencil_t_pallas) launches={launches}")
    if launches < 1:
        fail("[spmm] B3 was not launched by the sweep")
    return recs, launches


def a1_build(a, nel, dev, tag, **kw):
    """One full-size f32 build of the headline operator for the phases of
    the rest of the one-GPU driver (t 12, odir_fused on tbn, tol 1e-5 with
    device double-float refinement), with its build time logged."""
    import numpy as np

    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="tbn")
    args = dict(fmt="stencil", br=3, block_size=240, grid=(nel + 1, nel + 1, nel))
    args.update(kw)
    t0 = time.perf_counter()
    solver = DistributedECG.build(a, nshards=1, opts=opts, dtype=np.float32,
                                  device=dev, **args)
    build_s = time.perf_counter() - t0
    log(f"[{tag}] built in {build_s:.2f} s ({solver.operands.precond_kind}), "
        "stages (s): " + json.dumps({k: round(v, 4) for k, v in
                                     solver.timings.items()}))
    return solver, build_s


def a1_solve(solver, a, b, tag, anchor=None, min_per_iter=1):
    """The path's solve with B1's count zeroed just before and read just
    after (launches >= min_per_iter × iterations), three timed solves, and
    with ``anchor`` the iterations held within PATH_BAND of it."""
    from prealps_tpu_torch.ops.spmm import stencil_flat_ext

    info, launches, warm_s = checked_solve(solver, a, b, tag, stencil_flat_ext)
    iters = int(info["iters"])
    timed = timed_solves(solver, b, iters, tag)
    solve_s = statistics.median(timed)
    log(f"[{tag}] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} "
        f"stencil_flat_ext launches={launches}; timed solves (s): "
        f"{[round(v, 4) for v in timed]}, median {solve_s:.4f} s"
        + ("" if anchor is None else f" (JAX package on a CPU: {anchor} iterations)"))
    if launches < min_per_iter * iters:
        fail(f"[{tag}] B1 launched {launches} times for {iters} iterations "
             f"(< {min_per_iter}×)")
    if anchor is not None and not within(iters, anchor, PATH_BAND):
        fail(f"[{tag}] {iters} iterations, outside {anchor} ± "
             f"{100 * PATH_BAND:.0f} %")
    return {"iters": iters, "refine_rounds": info["refine_rounds"],
            "relres": info["relres"], "launches": launches, "solve_s": timed,
            "ms_per_iter": 1e3 * solve_s / iters, "anchor_iters": anchor}


def a1_phases(dev, a, b, nel, bj_iters):
    """Phases 20-24, the rest of the one-GPU driver at full size:
    Chebyshev, the deduplicated and the bf16 block Jacobi, bj2l without
    grid= and the stacked omin state. Returns {phase: record}."""
    import dataclasses

    import torch

    from prealps_tpu_torch.direct.device_bj import bj_apply_flat, bj_apply_lane_major
    from prealps_tpu_torch.timing import device_ms

    out = {}
    # --- [cheb]: bench.py PREALPS_BENCH_PRECOND=chebyshev (degree 8, κ 30) ---
    solver, build_s = a1_build(a, nel, dev, "cheb", precond="chebyshev",
                               cheb_degree=8, cheb_kappa=30.0, block_size=None,
                               grid=None)
    cheb = solver.operands.cheb
    log(f"[cheb] degree {cheb.degree}, lambda_max {cheb.lam_max:.6f}, "
        f"lambda_min {cheb.lam_min:.6f}: {cheb.degree - 1} B1 products per apply")
    rec = a1_solve(solver, a, b, "cheb", CHEB_ANCHOR_ITERS, min_per_iter=8)
    busy_ms, wall_ms = profile_solve(solver, b, "cheb")
    out["cheb"] = dict(rec, build_s=build_s, degree=cheb.degree,
                       lam_max=cheb.lam_max, lam_min=cheb.lam_min,
                       profile_device_ms=busy_ms, profile_wall_ms=wall_ms)
    del solver, cheb

    # --- [dedup]: PREALPS_BENCH_PRECOND=bj PREALPS_BENCH_BJ_DEDUPE=1 ---
    solver, build_s = a1_build(a, nel, dev, "dedup", precond="bj")
    ops = solver.operands
    if ops.precond_kind != "bj_dedup":
        fail(f"[dedup] built {ops.precond_kind}, not bj_dedup")
    mbn = ops.inv_u.shape[2]
    nb = ops.nrb // mbn
    log(f"[dedup] node blocks of {mbn} (the grid x-line; block_size // br = 80): "
        f"{ops.groups.num_groups} unique inverses for {nb} blocks "
        f"({ops.inv_u.numel() * 4 / 1e6:.1f} MB against "
        f"{nb * (3 * mbn) ** 2 * 4 / 1e6:.1f} MB flat)")
    if mbn != nel + 1:
        fail(f"[dedup] node blocks of {mbn}, not the x-line {nel + 1}")
    rec = a1_solve(solver, a, b, "dedup", DEDUP_ANCHOR_ITERS)
    out["dedup"] = dict(rec, build_s=build_s, mbn=mbn, nb=nb,
                        groups=ops.groups.num_groups)
    del solver, ops

    # --- [bj_lane]: PREALPS_BENCH_PRECOND=bj PREALPS_BENCH_BJ_DTYPE=bf16 ---
    solver, build_s = a1_build(a, nel, dev, "bj_lane", precond="bj",
                               bj_dedupe=False, bj_dtype="bf16")
    ops = solver.operands
    if ops.precond_kind != "bj_lane" or ops.inv5.dtype != torch.bfloat16:
        fail(f"[bj_lane] built {ops.precond_kind}, not bj_lane with bf16 inverses")
    nb, br, mbn = ops.inv5.shape[:3]
    z = torch.randn((12, br, ops.nrb), generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev)
    w = ops.m_apply(z)
    if w.dtype != torch.float32:
        fail(f"[bj_lane] the apply returned {w.dtype}, not float32")
    inv_f = ops.inv5.float().reshape(nb, br * mbn, br * mbn)
    lane_ms, _ = device_ms(lambda: bj_apply_lane_major(ops.inv5, z))
    flat_ms, _ = device_ms(lambda: bj_apply_flat(inv_f, z))
    log(f"[bj_lane] apply at nb {nb} mb {br * mbn} t 12 (device time, "
        f"information): bf16 split-input {lane_ms:.4f} ms, bj_apply_flat on the "
        f"same inverses in f32 {flat_ms:.4f} ms")
    del inv_f, z, w
    rec = a1_solve(solver, a, b, "bj_lane")
    limit = max(int(1.3 * bj_iters), bj_iters + 12)
    if rec["iters"] > limit:
        fail(f"[bj_lane] {rec['iters']} iterations > max(1.3 × {bj_iters}, "
             f"{bj_iters} + 12) = {limit}")
    log(f"[bj_lane] {rec['iters']} iterations within max(1.3×, +12) of [bj]'s "
        f"{bj_iters} (limit {limit})")
    out["bj_lane"] = dict(rec, build_s=build_s, apply_ms=lane_ms,
                          flat_apply_ms=flat_ms, bj_iters=bj_iters, limit=limit)
    del solver, ops

    # --- [bj2l_nogrid]: the headline without grid= (translation modes) ---
    solver, build_s = a1_build(a, nel, dev, "bj2l_nogrid", precond="bj2l",
                               grid=None)
    log(f"[bj2l_nogrid] coarse modes per block: {solver.operands.yq3.shape[1]}")
    rec = a1_solve(solver, a, b, "bj2l_nogrid", BJ2L_NOGRID_ANCHOR_ITERS)
    out["bj2l_nogrid"] = dict(rec, build_s=build_s)
    del solver

    # --- [omin_stacked]: the headline build with omin, stacked and not ---
    solver, build_s = a1_build(a, nel, dev, "omin_stacked", precond="bj2l")
    recs = {}
    for stacked in (True, False):
        s_ = dataclasses.replace(solver, opts=dataclasses.replace(
            solver.opts, variant="omin", stacked=stacked))
        recs[stacked] = a1_solve(s_, a, b, f"omin_stacked stacked={stacked}")
    # the stacked state's stop test reads the residual entering an
    # iteration (RᵀR comes with the first Gram, as in the JAX package), so
    # each inner solve runs one iteration more than the unstacked one
    it_s, it_u = recs[True]["iters"], recs[False]["iters"]
    expect = it_u + recs[True]["refine_rounds"]
    if abs(it_s - expect) > 1:
        fail(f"[omin_stacked] stacked {it_s} iterations against unstacked {it_u} "
             f"+ one per inner solve = {expect} (± 1)")
    log(f"[omin_stacked] stacked {it_s}, unstacked {it_u} iterations: within ±1 "
        f"of unstacked + one per inner solve ({expect})")
    out["omin_stacked"] = {"stacked": recs[True], "unstacked": recs[False],
                           "build_s": build_s}
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "prealps_tpu_torch")):
        fail("prealps_tpu_torch/ not found beside chip_smoke.py: run it from "
             "a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")

    from prealps_tpu_torch import strict_fp32
    from prealps_tpu_torch.core.generators import elasticity3d, poisson3d
    from prealps_tpu_torch.core.layout import permute_and_pad_matrix
    from prealps_tpu_torch.direct.device_bj import bj_apply_pallas
    from prealps_tpu_torch.ops import _kernels
    from prealps_tpu_torch.ops.formats import (
        StencilBsrTMatrix,
        csr_to_block_ell,
        csr_to_stencil_bsr_t,
        stencil_blocks_flat,
    )
    from prealps_tpu_torch.ops.spmm import (
        block_ell_spmm_pallas,
        stencil_flat_ext,
        stencil_spmm_planar,
    )
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    strict_fp32()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # --- 1. the card ---
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # --- 2. build the kernels ---
    t0 = time.perf_counter()
    _kernels.load()
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s")
    for src, binfo in _kernels.build_info.items():
        log(f"[build] {src}: nvcc {binfo['seconds']:.2f} s -> "
            f"{os.path.relpath(binfo['path'], HERE)}")
        for line in binfo["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {line.strip()}")

    # --- 3. main path build at full size ---
    nel = 36
    t0 = time.perf_counter()
    a = elasticity3d(nel, nel, nel, heterogeneous=False)
    n = a.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    gen_s = time.perf_counter() - t0
    log(f"[main] elasticity3d({nel}³) n={n} nnz={a.nnz} generated in {gen_s:.2f} s")
    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="tbn")
    t0 = time.perf_counter()
    solver = DistributedECG.build(
        a, nshards=1, fmt="stencil", br=3, precond="bj2l", block_size=240,
        grid=(nel + 1, nel + 1, nel), opts=opts, dtype=np.float32, device=dev)
    build_s = time.perf_counter() - t0
    ops = solver.operands
    log(f"[main] built in {build_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
        + f"; n_pad={solver.layout.n_pad} nrb={ops.nrb} S={len(ops.offsets)} "
        f"halo={ops.halo} nb={ops.inv_f.shape[0]} mb={ops.inv_f.shape[1]}")

    # --- 4. kernels vs plain versions on the card ---
    s_off = len(ops.offsets)
    head_t = StencilBsrTMatrix(ops.blocks_flat.view(s_off, 3, 3, ops.nrb),
                               ops.offsets, (3 * ops.nrb, 3 * ops.nrb))
    head_csr = stencil_csr(head_t.blocks_t, ops.offsets)
    log(f"[kernel] the headline operator as torch CSR: nnz={head_csr.values().numel()} "
        "(the torch.sparse.mm yardstick)")
    checks = [
        check_kernel("headline solver apply (br3,t12)", ops.blocks_flat,
                     ops.offsets, ops.halo, 3, 12, seed=1, csr=head_csr),
        check_kernel("refinement residual lo half (br3,t1)", ops.blocks_flat,
                     ops.offsets, ops.halo, 3, 1, seed=2),
        check_kernel("generic instantiation (br3,t4)", ops.blocks_flat,
                     ops.offsets, ops.halo, 3, 4, seed=3),
    ]
    pois = csr_to_stencil_bsr_t(poisson3d(40, 40, 40), br=1, dtype=np.float32,
                                device=dev)
    checks.append(check_kernel(
        "poisson3d 40³ (br1,t12)", stencil_blocks_flat(pois.blocks_t).contiguous(),
        pois.offsets, max(abs(o) for o in pois.offsets), 1, 12, seed=4))
    # the double-float residual product (plain PyTorch, once per round)
    x1 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, ops.nrb)).astype(np.float32)).to(dev)
    df_ms, _ = event_ms(lambda: ops.a_apply_df(x1), reps=2, batches=3, warm=1)
    log(f"[plain] stencil_scan_accumulate_df (br3,t1), the refinement "
        f"residual: {df_ms:.3f} ms")
    del pois
    # B3 (the sweep's stencil_t_pallas) and B4 (planar) on the same operator
    b3 = [check_lane(f"headline operator, B3 (br3,t{t})", head_t, t, seed=60 + t,
                     b3=True, csr=head_csr if t == 12 else None)
          for t in (12, 8, 1)]
    stencil_spmm_planar.launches = 0
    b4 = [check_planar("headline operator, B4 planar (br3,t12)", head_t.blocks_t,
                       ops.offsets, 12, seed=71, csr=head_csr)]
    b4_launches = stencil_spmm_planar.launches
    del head_csr, head_t

    # --- 5. the main path, through the user's entry points ---
    info, launches, warm_s = checked_solve(solver, a, b, "main", stencil_flat_ext)
    iters = int(info["iters"])
    log(f"[main] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info.get('refine_rounds')} relres={info['relres']:.3e} breakdown="
        f"{info['breakdown']} stencil_flat_ext launches={launches}")
    if launches < iters:
        fail(f"kernel launched {launches} times for {iters} iterations")
    timed = timed_solves(solver, b, iters, "main")
    solve_s = statistics.median(timed)
    log(f"[main] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration "
        f"(iterations {iters}; the JAX package's record of this solve: "
        f"{TPU_ANCHOR_ITERS} iterations)")
    profile_solve(solver, b, "solve")
    main_path = {
        "n": n, "nnz": int(a.nnz), "iters": iters,
        "refine_rounds": info.get("refine_rounds"), "relres": info["relres"],
        "solve_s": timed, "ms_per_iter": 1e3 * solve_s / iters,
        "build_s": build_s, "build_stages_s": solver.timings,
        "df_residual_ms": df_ms}
    del solver, ops, x1

    # --- 6. a small solve against a scipy direct solve ---
    a_s = elasticity3d(8, 8, 8, heterogeneous=False)
    b_s = np.random.default_rng(7).standard_normal(a_s.shape[0])
    small = DistributedECG.build(
        a_s, fmt="stencil", br=3, precond="bj2l", block_size=24,
        grid=(9, 9, 8), dtype=np.float32, device=dev,
        opts=ECGOptions(t=4, tol=1e-8, maxiter=3000, layout="tbn"))
    x_s, info_s = small.solve(b_s)
    x_ref = spla.spsolve(a_s.tocsc(), b_s)
    err_s = float(np.linalg.norm(x_s - x_ref) / np.linalg.norm(x_ref))
    rel_s = float(np.linalg.norm(b_s - a_s @ x_s) / np.linalg.norm(b_s))
    log(f"[small] elasticity3d(8³) f32+refinement on the card: "
        f"iters={info_s['iters']} relres={rel_s:.3e} "
        f"|x - x_direct|/|x_direct|={err_s:.3e}")
    if not (rel_s < 1e-8 and err_s < 1e-5):
        fail("small solve disagrees with the scipy direct solve")
    del small

    # --- 7. the general path's build at full size ---
    gopts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                       layout="nt")
    t0 = time.perf_counter()
    gsolver = DistributedECG.build(
        a, nshards=1, fmt="block_ell", precond="bj", block_size=240,
        opts=gopts, dtype=np.float32, device=dev)
    gbuild_s = time.perf_counter() - t0
    gops = gsolver.operands
    nrb, s_max, bm, bk = gops.mat.blocks.shape
    fill = int(a.nnz) / gops.mat.blocks.numel()
    log(f"[general] built in {gbuild_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in gsolver.timings.items()})
        + f"; n_pad={gsolver.layout.n_pad} block-ELL nrb={nrb} S={s_max} "
        f"bm={bm} bk={bk} ({gops.mat.blocks.numel() * 4 / 1e9:.3f} GB, fill "
        f"{100 * fill:.1f} %); block Jacobi nb={gops.bj.factors.shape[0]} "
        f"mb={gops.bj.factors.shape[1]} mode={gops.bj.mode}")

    # --- 8. B5 vs its plain version on the card ---
    gen_csr = scipy_csr(permute_and_pad_matrix(gsolver.a_scaled, gsolver.layout), dev)
    b5_checks = [check_block_ell("general solver apply (bk128,t12)", gops.mat,
                                 12, seed=11, csr=gen_csr),
                 check_block_ell("single vector (bk128,t1)", gops.mat, 1,
                                 seed=12)]
    bell8 = csr_to_block_ell(permute_and_pad_matrix(gsolver.a_scaled,
                                                    gsolver.layout),
                             bm=8, bk=8, dtype=np.float32, device=dev)
    b5_checks.append(check_block_ell("bk8 generic (bk8,t12)", bell8, 12,
                                     seed=13))
    del bell8, gen_csr

    # --- 9. the general path, through the user's entry points ---
    ginfo, glaunches, gwarm_s = checked_solve(gsolver, a, b, "general",
                                              block_ell_spmm_pallas)
    giters = int(ginfo["iters"])
    log(f"[general] warm solve {gwarm_s:.3f} s: iters={giters} refine_rounds="
        f"{ginfo['refine_rounds']} relres={ginfo['relres']:.3e} breakdown="
        f"{ginfo['breakdown']} block_ell_spmm_pallas launches={glaunches} "
        f"(JAX package on a CPU, fmt='block_ell_xla': {GENERAL_ANCHOR_ITERS} "
        "iterations)")
    if glaunches < giters:
        fail(f"block-ELL kernel launched {glaunches} times for {giters} iterations")
    if not within(giters, GENERAL_ANCHOR_ITERS):
        fail(f"general path ran {giters} iterations, outside "
             f"{GENERAL_ANCHOR_ITERS} ± {100 * ANCHOR_BAND:.0f} %")
    gtimed = timed_solves(gsolver, b, giters, "general")
    gsolve_s = statistics.median(gtimed)
    log(f"[general] timed solves (s): {[round(v, 4) for v in gtimed]}; median "
        f"{gsolve_s:.4f} s, {1e3 * gsolve_s / giters:.3f} ms/iteration")
    profile_solve(gsolver, b, "general")
    general_path = {
        "fmt": "block_ell", "nrb": nrb, "S": s_max, "bk": bk, "fill": fill,
        "iters": giters, "refine_rounds": ginfo["refine_rounds"],
        "relres": ginfo["relres"], "launches": glaunches, "solve_s": gtimed,
        "ms_per_iter": 1e3 * gsolve_s / giters, "build_s": gbuild_s,
        "build_stages_s": gsolver.timings, "anchor_iters": GENERAL_ANCHOR_ITERS}
    del gsolver, gops

    # --- 10. fmt="ell" through the device double-float rounds ---
    nel_e = 20
    a_e = elasticity3d(nel_e, nel_e, nel_e, heterogeneous=False)
    b_e = np.random.default_rng(0).standard_normal(a_e.shape[0])
    esolver = DistributedECG.build(a_e, nshards=1, fmt="ell", precond="bj",
                                   block_size=240, opts=gopts,
                                   dtype=np.float32, device=dev)
    einfo, _, ewarm_s = checked_solve(esolver, a_e, b_e, "ell")
    log(f"[ell] elasticity3d({nel_e}³) n={a_e.shape[0]} ELL width "
        f"{esolver.operands.mat.vals.shape[1]}: {ewarm_s:.3f} s, iters="
        f"{einfo['iters']} refine_rounds={einfo['refine_rounds']} (device "
        f"double-float rounds {einfo['device_rounds']}) relres="
        f"{einfo['relres']:.3e}")
    if einfo["device_rounds"] < 1:
        fail("[ell] no device double-float refinement round ran")
    ell_path = {"n": a_e.shape[0], "iters": einfo["iters"],
                "refine_rounds": einfo["refine_rounds"],
                "device_rounds": einfo["device_rounds"],
                "relres": einfo["relres"], "solve_s": ewarm_s}
    del esolver

    # --- 11. the stencil path with block Jacobi alone (bj_flat) ---
    t0 = time.perf_counter()
    bsolver = DistributedECG.build(
        a, nshards=1, fmt="stencil", br=3, precond="bj", block_size=240,
        grid=(nel + 1, nel + 1, nel), bj_dedupe=False, opts=opts,
        dtype=np.float32, device=dev)
    bbuild_s = time.perf_counter() - t0
    binfo, blaunches, bwarm_s = checked_solve(bsolver, a, b, "bj", stencil_flat_ext)
    biters = int(binfo["iters"])
    btimed = timed_solves(bsolver, b, biters, "bj")
    log(f"[bj] stencil + bj ({bsolver.operands.precond_kind}): built in "
        f"{bbuild_s:.2f} s; iters={biters} refine_rounds="
        f"{binfo['refine_rounds']} relres={binfo['relres']:.3e} "
        f"stencil_flat_ext launches={blaunches}; timed solves (s): "
        f"{[round(v, 4) for v in btimed]} (the JAX package's TPU record: "
        f"{BJ_ANCHOR_ITERS} iterations)")
    if blaunches < biters:
        fail(f"[bj] stencil kernel launched {blaunches} times for {biters} iterations")
    if not within(biters, BJ_ANCHOR_ITERS):
        fail(f"[bj] ran {biters} iterations, outside {BJ_ANCHOR_ITERS} ± "
             f"{100 * ANCHOR_BAND:.0f} %")
    bj_path = {"iters": biters, "refine_rounds": binfo["refine_rounds"],
               "relres": binfo["relres"], "solve_s": btimed,
               "build_s": bbuild_s, "anchor_iters": BJ_ANCHOR_ITERS}

    # --- 12. B6 vs its plain version and torch.bmm, on the bj inverses ---
    bj_apply_pallas.launches = 0
    b6 = [check_bj_apply(bsolver.operands.inv_f, 3, 12, seed=21)]
    del bsolver

    # --- 13-15. the single-GPU LORASC path, with B2a and B2b ---
    b2a, b2b, lorasc_path, la, lb = lorasc_phase(dev)

    # --- 16-19. fmt="dia", fmt="auto" and the SpMM format sweep ---
    b1_dia, b2b_dia, b6_dia, dia_path, dia_launches = dia_phase(dev, a, b)
    b6.append(b6_dia)
    b6_launches = bj_apply_pallas.launches
    auto_path = auto_phase(dev)
    spmm_recs, b3_launches = spmm_phase(dev, a)

    # --- 20-24. the rest of the one-GPU driver ---
    a1_paths = a1_phases(dev, a, b, nel, biters)

    log("[summary] " + json.dumps({
        "checks": checks, "block_ell_checks": b5_checks, "bj_apply_checks": b6,
        "lane_checks": b2a + b2b, "b3_checks": b3, "b4_checks": b4,
        "dia_checks": b1_dia + b2b_dia, "main_path": main_path,
        "general_path": general_path, "ell_path": ell_path, "bj_path": bj_path,
        "lorasc_path": lorasc_path, "dia_path": dia_path, "auto_path": auto_path,
        "spmm_sweep": spmm_recs, **a1_paths,
        "total_s": time.perf_counter() - t_start}))

    def entry(name, source, replaces, launches_, recs):
        """One kernel's record: times and yardsticks at its first shape
        (the path's) and at every shape checked, the largest error over
        them."""
        head = recs[0]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"prealps_tpu_torch/csrc/{source}",
                "replaces": f"prealps_tpu/{replaces}", "launches": launches_,
                "max_abs_err": max(c["max_abs_err"] for c in recs),
                **{k: head[k] for k in keys},
                "shapes": [{"shape": c["shape"], **{k: c[k] for k in keys}}
                           for c in recs]}

    b1 = entry("stencil_flat_ext", "stencil.cu", "ops/spmm.py:800", launches,
               checks + b1_dia)
    # B1's count on each path's own solve (counts zeroed before each)
    b1["path_launches"] = {"main": launches, "bj": blaunches, "dia": dia_launches,
                           **{k: (v["launches"] if "launches" in v else
                                  v["stacked"]["launches"] + v["unstacked"]["launches"])
                              for k, v in a1_paths.items()}}
    kernels = {"kernels": [
        b1,
        entry("block_ell_spmm_pallas", "block_ell.cu", "ops/spmm.py:97", glaunches,
              b5_checks),
        entry("bj_apply_pallas", "bj_apply.cu", "direct/device_bj.py:165",
              b6_launches, b6),
        entry("stencil_bsr_spmm_t_pallas_bs", "stencil.cu", "ops/spmm.py:511", la,
              b2a),
        entry("stencil_pallas_bs_ext", "stencil.cu", "ops/spmm.py:695", lb,
              b2b + b2b_dia),
        entry("stencil_bsr_spmm_t_pallas", "stencil.cu", "ops/spmm.py:417",
              b3_launches, b3),
        entry("stencil_spmm_planar", "stencil.cu", "ops/spmm.py:619", b4_launches,
              b4),
    ]}
    log(card_line())
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
