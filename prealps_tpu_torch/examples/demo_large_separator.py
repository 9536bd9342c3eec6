"""Large-separator distributed LORASC demo: ``[dlorasc_large]``'s
configuration as a user script.

The counterpart of the JAX package's ``examples/demo_large_separator.py``:
``DistributedLorascECG`` (parallel/lorasc_driver.py) over ``nshards``
spawned ranks on heterogeneous elasticity3d(nel³), f64, ECG t 4
odir_fused to 1e-5, the build's defaults otherwise (RAC scaling, Lanczos
deflation, σ correction, the banded separator factorization that keeps
memory at n·band instead of a dense ng² inverse). At nel 32 and 8 ranks
the separator has 18,152 padded rows. Rank 0 prints the build's shape and
the solve's iterations and true relative residual, which must be < 1e-4.

    python -m prealps_tpu_torch.examples.demo_large_separator [nel] [nshards]
        [--device cuda|cuda:0|cpu]

On a host with fewer cards than ranks the ranks share ``cuda:0`` through
gloo (host round trips, not scaling).
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np


def _rank(rank, group, nel, device):
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a = elasticity3d(nel, nel, nel)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    t0 = time.perf_counter()
    s = DistributedLorascECG.build(
        a, nshards=mesh.size_of(group), dtype=np.float64,
        device=mesh.shard_device(device, rank), group=group,
        opts=ECGOptions(t=4, tol=1e-5, maxiter=2000, variant="odir_fused"))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    solve_s = time.perf_counter() - t0
    return {"n": a.shape[0], "ngroups": s.ngroups, "ng_max": s.ng_max,
            "deflated": s.deflated, "build_s": build_s, "iters": int(info["iters"]),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "solve_s": solve_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nel", nargs="?", type=int, default=32)
    ap.add_argument("nshards", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)

    from prealps_tpu_torch.parallel import mesh

    device, shared = mesh.rank_device(args.device, args.nshards)
    store = tempfile.mkdtemp(prefix="prealps_demo_")
    try:
        r = mesh.spawn(_rank, args.nshards, args=(args.nel, device),
                       init_method=f"file://{store}/store", backend="gloo",
                       timeout=args.timeout, threads=1)[0]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    print(f"built: n={r['n']} ngroups={r['ngroups']} ng_max={r['ng_max']} "
          f"(separator {r['ng_max'] * r['ngroups']} padded rows, banded — no ng^2 "
          f"dense) deflated={r['deflated']} build={r['build_s']:.1f}s", flush=True)
    print(f"solved: iters={r['iters']} relres={r['relres']:.3e} "
          f"solve={r['solve_s']:.1f}s" + (f" ({mesh.SHARED_NOTE})" if shared else ""),
          flush=True)
    if not r["relres"] < 1e-4:
        raise SystemExit(f"relres {r['relres']:.3e} >= 1e-4")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
