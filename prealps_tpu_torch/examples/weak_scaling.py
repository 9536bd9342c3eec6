"""Weak-scaling sweep of the distributed ECG solve, with a comm/compute split.

The counterpart of the JAX package's ``examples/weak_scaling.py``. For each
shard count of ``--shards`` it spawns that many ranks
(``parallel/mesh.py::spawn``, a gloo group), grows elasticity3d's z extent
with the count (constant rows a shard) and solves with the stencil format
(B1 on the card) and Chebyshev (degree ``--cheb-degree``), ECG t ``--t``
odir_fused on lane-major panels, no refinement, tol 1e-30 and a fixed
``--maxiter``. Rank 0 prints one JSON row a shard count:

- ``iter_ms``: the warm solve's wall time over its iterations;
- ``iter_nocoll_ms``: the same solve with ``PREALPS_TIMING_NO_COLLECTIVES``
  set inside every rank (``parallel/mesh.py::timing_no_collectives``: the
  ECG all-reduces and the ring halo become local no-ops; the results are
  WRONG by construction), over its own iterations, since a rank whose
  local algebra breaks down stops early;
- ``comm_frac``: 1 − iter_nocoll_ms / iter_ms.

On a host with fewer cards than ranks the ranks share ``cuda:0`` through
gloo, which stages every collective through the host: the rows then time
host round trips between processes that time-slice one card, not scaling
(``shared_card`` true in the row). The JAX script's scan-differential
chains are not ported.

    python -m prealps_tpu_torch.examples.weak_scaling --shards 1,2,4
    python -m prealps_tpu_torch.examples.weak_scaling --device cpu --base-nel 4
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

KNOB = "PREALPS_TIMING_NO_COLLECTIVES"


def _timed_solve(solver, b, device):
    from prealps_tpu_torch.utils.timing import sync

    sync(device)
    t0 = time.perf_counter()
    _, info = solver.solve(b)
    sync(device)
    return time.perf_counter() - t0, int(info["iters"])


def _rank(rank, group, args, device):
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    nshards = mesh.size_of(group)
    dev = mesh.shard_device(device, rank)
    a = elasticity3d(args.base_nel, args.base_nel, args.base_nel * nshards)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    dtype = np.float64 if dev.type == "cpu" else np.float32
    solver = DistributedECG.build(
        a, nshards=nshards, fmt="stencil", br=3, precond="chebyshev",
        cheb_degree=args.cheb_degree, dtype=dtype, refine=False, device=dev,
        group=group,
        opts=ECGOptions(t=args.t, tol=1e-30, maxiter=args.maxiter,
                        variant="odir_fused", layout="tbn", record_history=False))
    solver.solve(b)                       # warm
    secs, iters = _timed_solve(solver, b, dev)
    iter_ms = 1e3 * secs / max(iters, 1)
    iter_nc_ms, iters_nc = iter_ms, iters
    if nshards > 1:
        os.environ[KNOB] = "1"
        try:
            _timed_solve(solver, b, dev)  # warm
            secs_nc, iters_nc = _timed_solve(solver, b, dev)
        finally:
            os.environ.pop(KNOB, None)
        iter_nc_ms = 1e3 * secs_nc / max(iters_nc, 1)
    return {"nshards": nshards, "n": a.shape[0], "nnz": int(a.nnz), "iters": iters,
            "iters_nocoll": iters_nc, "wall_s": secs, "iter_ms": iter_ms,
            "iter_nocoll_ms": iter_nc_ms,
            "comm_frac": max(0.0, 1.0 - iter_nc_ms / iter_ms),
            "gnnz_per_s": a.nnz * iters / secs / 1e9, "device": str(dev),
            "dtype": np.dtype(dtype).name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base-nel", type=int, default=8)
    ap.add_argument("--shards", default="1,2,4")
    ap.add_argument("--t", type=int, default=8)
    ap.add_argument("--cheb-degree", type=int, default=8)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    from prealps_tpu_torch.parallel import mesh

    for nshards in (int(v) for v in args.shards.split(",")):
        device, shared = mesh.rank_device(args.device, nshards)
        store = tempfile.mkdtemp(prefix="prealps_weak_")
        try:
            row = mesh.spawn(_rank, nshards, args=(args, device),
                             init_method=f"file://{store}/store", backend="gloo",
                             timeout=args.timeout)[0]
        finally:
            shutil.rmtree(store, ignore_errors=True)
        row["shared_card"] = shared
        if shared:
            row["note"] = mesh.SHARED_NOTE
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
