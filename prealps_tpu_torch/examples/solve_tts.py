"""Time the solves of chip_smoke.py's paths and the host cost of one
stencil launch.

The paths, at chip_smoke.py's configurations (elasticity3d(nel³), f32,
tol 1e-5, rhs ``default_rng(0)``):

* ``headline``: stencil format (br 3), two-level block Jacobi with 240-row
  blocks, ECG t = 12 odir_fused on lane-major panels, double-float
  refinement on the device;
* ``dia``: ``fmt="dia"`` on lane-major panels, block Jacobi (1024-row
  blocks), ECG t = 12 odir_fused, host-f64 refinement;
* ``lorasc``: heterogeneous operator, 8 box parts, ECG t = 12 omin, nev
  256, balancing ("deflate") correction, double-float refinement;
* ``presc``: ``lorasc`` with the SSLOC pencil (``pencil="sloc"``) and bf16
  banded factors, the JAX package's PRESC record configuration;
  ``presc_f32`` the same with f32 factors (the card's default);
* ``lorasc_bf16``: ``lorasc`` with ``a_store="bf16"`` (the sweeps through
  B2a's bf16-block instance) and bf16 banded factors.

The script imports ``prealps_tpu_torch`` from the caller's path, so one copy
of it times any checkout of the port whose entry points take these
arguments; run it once per checkout, in turns (A, B, B, A), to compare two
of them on one card:

    PYTHONPATH=<checkout> python prealps_tpu_torch/examples/solve_tts.py \\
        --paths headline,dia

It prints one JSON line per path: the package it loaded, the card and its
power limit, iterations, the timed solves (host clock up to a synchronize)
and their median, and the device time of one solve under torch.profiler;
then one line with the host microseconds of one B2a launch
(``stencil_bsr_spmm_t_pallas_bs``) at a tiny shape, where the call is bound
by its host path (2,000 calls back to back between two synchronizes), and
the device microseconds of the same call.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import runpy
import statistics
import time

import numpy as np
import torch

PATHS = ("headline", "dia", "lorasc", "presc", "presc_f32", "lorasc_bf16")
LORASC_OPTIONS = {"lorasc": {}, "presc": dict(pencil="sloc", factor_store="bf16"),
                  "presc_f32": dict(pencil="sloc", factor_store="f32"),
                  "lorasc_bf16": dict(a_store="bf16", factor_store="bf16")}


def this_timing() -> dict:
    """This checkout's ``timing.py``, loaded by its path and not through
    prealps_tpu_torch, so every checkout on PYTHONPATH is timed alike."""
    return runpy.run_path(str(pathlib.Path(__file__).resolve().parents[1]
                              / "timing.py"))


def launch_us(dev, calls: int = 2000) -> tuple:
    """Host and device microseconds per B2a call at br 3, 27 offsets, nrb
    1024, t 1: the host's by the clock around ``calls`` calls between two
    synchronizes, the device's by this checkout's ``timing.device_ms``."""
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
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    dev_ms, _ = this_timing()["device_ms"](
        lambda: stencil_bsr_spmm_t_pallas_bs(a_t, x), reps=200)
    return host_us, 1e3 * dev_ms


def build(path: str, a, nel: int, dev):
    """The path's solver, as chip_smoke.py builds it."""
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    grid = (nel + 1, nel + 1, nel)
    if path in LORASC_OPTIONS:
        from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG

        return StencilLorascECG.build(
            a, nparts=8, br=3, grid=grid,
            opts=ECGOptions(t=12, tol=1e-5, maxiter=3000, variant="omin",
                            layout="tbn"),
            max_deflation=256, correction="deflate", inner_tol=1e-3,
            dtype=np.float32, device=dev, **LORASC_OPTIONS[path])
    opts = ECGOptions(t=12, tol=1e-5, maxiter=3000, variant="odir_fused",
                      layout="tbn")
    if path == "headline":
        return DistributedECG.build(a, nshards=1, fmt="stencil", br=3,
                                    precond="bj2l", block_size=240, grid=grid,
                                    opts=opts, dtype=np.float32, device=dev)
    return DistributedECG.build(a, nshards=1, fmt="dia", precond="bj", grid=None,
                                opts=opts, dtype=np.float32, device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nel", type=int, default=36)
    ap.add_argument("--solves", type=int, default=7)
    ap.add_argument("--paths", default="lorasc",
                    help=f"comma-separated, of {', '.join(PATHS)}")
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    if not paths or any(p not in PATHS for p in paths):
        ap.error(f"--paths takes {', '.join(PATHS)}; got {args.paths!r}")

    import prealps_tpu_torch
    from prealps_tpu_torch.core.generators import elasticity3d

    if not torch.cuda.is_available():
        raise SystemExit("solve_tts: needs a CUDA card")
    dev = torch.device("cuda", 0)
    timing = this_timing()
    card = timing["card_line"]()

    nel = args.nel
    for path in paths:
        a = elasticity3d(nel, nel, nel, heterogeneous=path in LORASC_OPTIONS)
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        t0 = time.perf_counter()
        solver = build(path, a, nel, dev)
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
        rec = {"path": path, "package": prealps_tpu_torch.__file__, "card": card,
               "nel": nel, "iters": int(info["iters"]),
               "refine_rounds": info["refine_rounds"], "relres": relres,
               "build_s": build_s, "solve_s": timed,
               "median_s": statistics.median(timed),
               "device_ms": timing["profiled_device_ms"](lambda: solver.solve(b))}
        if path in LORASC_OPTIONS:
            rec["deflated"] = solver.precond.deflated
        print(json.dumps(rec), flush=True)
        del solver
    host_us, dev_us = launch_us(dev)
    print(json.dumps({"package": prealps_tpu_torch.__file__, "card": card,
                      "b2a_launch_us": host_us, "b2a_device_us": dev_us}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
