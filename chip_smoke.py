#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (prealps_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero before a result is printed):
 1. the card: ``nvidia-smi`` name and power limit, torch's device name;
 2. build the CUDA kernels from prealps_tpu_torch/csrc (nvcc, sm_90a);
 3. the main path's build at full size: elasticity3d 36³ (n = 147,852),
    stencil format, two-level block Jacobi (240-row blocks), ECG t = 12;
 4. every kernel of the path against its plain PyTorch version on the
    card, at the shapes the path gives it (t = 12 for the solver, t = 1 for
    the refinement residual) plus a br = 1 and a generic shape; CUDA-event
    times of both (median of 5 batches of 20 back-to-back calls each, in
    turns plain, kernel, kernel, plain);
 5. the main path: kernel launch counts zeroed, one solve of
    b = default_rng(0).standard_normal(n) to tol 1e-5 (f32 with
    double-float refinement), counts read back; then three timed solves
    and one under torch.profiler (device time by kernel, also written to
    chiprun_out/profile_solve.txt);
 6. a small f32 solve on the card against a scipy direct solve.

The last lines of standard output are a ``[summary]`` JSON line (every
check, the main path's numbers), the card's ``nvidia-smi`` name and power
limit, the kernels' JSON record (``ms``/``plain_ms``/``max_abs_err`` at the
headline shape t = 12, ``launches`` from the main path's solve), and last
``{"ok": true, "device": {...}}``.
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


def check_kernel(name, blocks_flat, offsets, halo, br, t, seed):
    """Kernel vs plain version on the card for one shape; returns a record."""
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
    bound = KERNEL_TOL * float(scale.max())
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {bound:.3e}")
    # in turns: plain, kernel, kernel, plain
    p1, pt1 = event_ms(lambda: stencil_flat_ext_ref(blocks_flat, offsets, x_ext, halo, br))
    k1, kt1 = event_ms(lambda: stencil_flat_ext(blocks_flat, offsets, x_ext, halo, br))
    k2, kt2 = event_ms(lambda: stencil_flat_ext(blocks_flat, offsets, x_ext, halo, br))
    p2, pt2 = event_ms(lambda: stencil_flat_ext_ref(blocks_flat, offsets, x_ext, halo, br))
    ms = statistics.median(kt1 + kt2)
    plain_ms = statistics.median(pt1 + pt2)
    nbytes = 4 * (blocks_flat.numel() + x_ext.numel() + y_k.numel())
    rec = {"shape": name, "br": br, "t": t, "S": len(offsets), "nrb": nrb,
           "halo": halo, "max_abs_err": err, "bound": bound, "ms": ms,
           "plain_ms": plain_ms, "reckoned_MB": nbytes / 1e6,
           "GBps": nbytes / (ms * 1e-3) / 1e9,
           "plain_GBps": nbytes / (plain_ms * 1e-3) / 1e9,
           "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]}}
    log(f"[kernel] {name}: br={br} t={t} S={len(offsets)} nrb={nrb} "
        f"max_abs_err={err:.3e} (bound {bound:.3e}) kernel {ms:.4f} ms "
        f"({rec['GBps']:.0f} GB/s) plain {plain_ms:.4f} ms "
        f"({rec['plain_GBps']:.0f} GB/s)")
    return rec


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
    from prealps_tpu_torch.ops import _kernels
    from prealps_tpu_torch.ops.formats import csr_to_stencil_bsr_t, stencil_blocks_flat
    from prealps_tpu_torch.ops.spmm import stencil_flat_ext
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
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_kernels.build_info['seconds']:.2f} s) -> "
        f"{os.path.relpath(_kernels.build_info['path'], HERE)}")
    for line in _kernels.build_info["log"].splitlines():
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
    checks = [
        check_kernel("headline solver apply (br3,t12)", ops.blocks_flat,
                     ops.offsets, ops.halo, 3, 12, seed=1),
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

    # --- 5. the main path, through the user's entry points ---
    stencil_flat_ext.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = stencil_flat_ext.launches
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    iters = int(info["iters"])
    log(f"[main] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info.get('refine_rounds')} relres={relres:.3e} breakdown="
        f"{info['breakdown']} stencil_flat_ext launches={launches}")
    if not np.all(np.isfinite(x)) or x.shape != (n,):
        fail("solution not finite or of the wrong shape")
    if info["breakdown"]:
        fail("ECG breakdown")
    if not relres < SOLVE_TOL:
        fail(f"host f64 relres {relres:.3e} >= {SOLVE_TOL}")
    if launches < iters:
        fail(f"kernel launched {launches} times for {iters} iterations")
    timed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xk, ik = solver.solve(b)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        if int(ik["iters"]) != iters or ik["breakdown"]:
            log(f"[main] note: timed solve ran {ik['iters']} iterations")
    solve_s = statistics.median(timed)
    log(f"[main] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration "
        f"(iterations {iters}; the JAX package's record of this solve: "
        f"{TPU_ANCHOR_ITERS} iterations)")

    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.solve(b)
        torch.cuda.synchronize()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(HERE, "chiprun_out", "profile_solve.txt"), "w") as f:
        f.write(table)
    log("[profile] one solve by device time:")
    for line in table.splitlines()[:25]:
        log("[profile] " + line)

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

    head = checks[0]
    log("[summary] " + json.dumps({
        "checks": checks,
        "main_path": {
            "n": n, "nnz": int(a.nnz), "iters": iters,
            "refine_rounds": info.get("refine_rounds"), "relres": relres,
            "solve_s": timed, "ms_per_iter": 1e3 * solve_s / iters,
            "build_s": build_s, "build_stages_s": solver.timings,
            "df_residual_ms": df_ms},
        "total_s": time.perf_counter() - t_start}))
    kernels = {"kernels": [{
        "name": "stencil_flat_ext",
        "route": "cuda",
        "source": "prealps_tpu_torch/csrc/stencil_flat.cu",
        "replaces": "prealps_tpu/ops/spmm.py:772",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }]}
    log(card_line())
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
