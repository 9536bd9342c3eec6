"""Time the single-GPU LORASC solve and the host cost of one stencil launch.

The solve is chip_smoke.py's ``[lorasc]`` configuration: heterogeneous
elasticity3d(nel³), 8 box parts, ECG t = 12 omin, nev 256, balancing
("deflate") correction, f32 with double-float refinement to 1e-5, rhs
``default_rng(0)``. The script imports ``prealps_tpu_torch`` from the
caller's path, so one copy of it times any checkout of the port whose
``StencilLorascECG`` takes these arguments; run it once per checkout, in
turns (A, B, B, A), to compare two of them on one card:

    PYTHONPATH=<checkout> python prealps_tpu_torch/examples/lorasc_tts.py

It prints one JSON line: the package it loaded, the card and its power
limit, iterations, the timed solves (host clock up to a synchronize) and
their median, the device time of one profiled solve, and the host
microseconds of one B2a launch (``stencil_bsr_spmm_t_pallas_bs``) at a tiny
shape, where the call is bound by its host path: 2,000 calls back to back
between two synchronizes.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def launch_us(dev, calls: int = 2000) -> float:
    """Host microseconds per B2a call at br 3, 27 offsets, nrb 1024, t 1."""
    from prealps_tpu_torch.ops.formats import StencilBsrTMatrix
    from prealps_tpu_torch.ops.spmm import stencil_bsr_spmm_t_pallas_bs

    nrb = 1024
    offsets = tuple(range(-13, 14))
    rng = np.random.default_rng(1)
    a_t = StencilBsrTMatrix(torch.from_numpy(rng.standard_normal(
        (len(offsets), 3, 3, nrb)).astype(np.float32)).to(dev), offsets,
        (3 * nrb, 3 * nrb))
    x = torch.from_numpy(rng.standard_normal((1, 3, nrb)).astype(np.float32)).to(dev)
    for _ in range(20):
        stencil_bsr_spmm_t_pallas_bs(a_t, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        stencil_bsr_spmm_t_pallas_bs(a_t, x)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def device_ms(solver, b) -> float:
    """Device time of one solve under torch.profiler (the device events'
    self time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.solve(b)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nel", type=int, default=36)
    ap.add_argument("--solves", type=int, default=7)
    args = ap.parse_args(argv)

    import prealps_tpu_torch
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    if not torch.cuda.is_available():
        raise SystemExit("lorasc_tts: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    us = launch_us(dev)

    nel = args.nel
    a = elasticity3d(nel, nel, nel, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    t0 = time.perf_counter()
    solver = StencilLorascECG.build(
        a, nparts=8, br=3, grid=(nel + 1, nel + 1, nel),
        opts=ECGOptions(t=12, tol=1e-5, maxiter=3000, variant="omin",
                        layout="tbn"),
        max_deflation=256, correction="deflate", pencil="agg", inner_tol=1e-3,
        dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x, info = solver.solve(b)                       # warm
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    timed = []
    for _ in range(args.solves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
    print(json.dumps({
        "package": prealps_tpu_torch.__file__, "card": card, "nel": nel,
        "deflated": solver.precond.deflated, "iters": int(info["iters"]),
        "refine_rounds": info["refine_rounds"], "relres": relres,
        "build_s": build_s, "solve_s": timed,
        "median_s": statistics.median(timed), "device_ms": device_ms(solver, b),
        "b2a_launch_us": us}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
