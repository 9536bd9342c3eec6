"""f64 deflation study: the port of ``examples/deflation_study_f64.py``.

Separates LORASC's algorithm from f32 precision: the single-device
``StencilLorascECG`` build and solve in float64 on heterogeneous
elasticity3d(nel³) (n = 147,852 at the default nel 36), sweeping
max_deflation. The configuration is the JAX script's: 8 box parts
(grid (nel + 1, nel + 1, nel)), ECG t 12 odir_fused on lane-major panels to
tol 1e-5, maxiter 3000, the build's defaults otherwise (agg pencil, σ
correction, deflation_tol 1e-2), b = default_rng(0).standard_normal(n).
In f64 there is no refinement: one ECG solve, as in JAX. On the card every
operator product is the f64 instance of the lane-major stencil kernel
(B2a).

It prints the card's name and power limit, then one JSON row a
max_deflation: requested, kept (the deflated pairs), iterations, the host
f64 relres ‖b − A x‖/‖b‖, build and solve seconds (host clock up to a
synchronize) and, on the card, the device time of a second solve under
torch.profiler (``device_ms``; null on the CPU); and last one JSON line
with every row.

    python -m prealps_tpu_torch.examples.deflation_study_f64
    python -m prealps_tpu_torch.examples.deflation_study_f64 --nel 6 --deflations 8,16 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

NEL = 36
DEFLATIONS = (64, 128, 256, 512)
OPTS = dict(t=12, tol=1e-5, maxiter=3000, variant="odir_fused", layout="tbn")


def problem(nel: int):
    """Heterogeneous elasticity3d(nel³) and b = default_rng(0) (the JAX
    script's; the port's generator is bitwise JAX's)."""
    from prealps_tpu_torch.core.generators import elasticity3d

    a = elasticity3d(nel, nel, nel, heterogeneous=True)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def build_kwargs(nel: int, max_deflation: int) -> dict:
    """``StencilLorascECG.build`` keywords of a row (either package's),
    without ``opts`` (``OPTS``) and the device."""
    return dict(nparts=8, br=3, grid=(nel + 1, nel + 1, nel), dtype=np.float64,
                max_deflation=max_deflation)


def study(nel: int = NEL, deflations=DEFLATIONS, device="cuda"):
    """Yield one row a max_deflation (see the module docstring)."""
    import torch

    from prealps_tpu_torch.config import resolve_device
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions
    from prealps_tpu_torch.timing import profiled_device_ms
    from prealps_tpu_torch.utils.timing import sync

    dev = resolve_device(device)
    a, b = problem(nel)
    for defl in deflations:
        t0 = time.perf_counter()
        s = StencilLorascECG.build(a, opts=ECGOptions(**OPTS), device=dev,
                                   **build_kwargs(nel, defl))
        sync(dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, info = s.solve(b)
        sync(dev)
        solve_s = time.perf_counter() - t0
        yield {"defl_requested": defl, "defl_kept": int(info["deflated"]),
               "iters": int(info["iters"]), "breakdown": bool(info["breakdown"]),
               "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
               "build_s": build_s, "solve_s": solve_s,
               "device_ms": (profiled_device_ms(lambda: s.solve(b))
                             if dev.type == "cuda" else None)}
        del s
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nel", type=int, default=NEL)
    ap.add_argument("--deflations", default=",".join(map(str, DEFLATIONS)))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from prealps_tpu_torch.config import resolve_device
    from prealps_tpu_torch.timing import card_line

    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(json.dumps({"card": card, "nel": args.nel, "dtype": "float64"}), flush=True)
    rows = []
    for row in study(args.nel, [int(v) for v in args.deflations.split(",")], dev):
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"metric": "deflation_study_f64", "card": card, "nel": args.nel,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
