"""Multi-rank dry run: the counterpart of ``__graft_entry__.dryrun_multichip``.

Six paths over ``n_ranks`` ranks on heterogeneous elasticity3d(8³)
(n = 1,944, RAC-scaled, b = default_rng(0)), ECG t = 2 to tol 1e-6, each
solved to convergence and checked by its true residual ‖b − A x‖/‖b‖ <
100·tol (reference: examples/test_lorasc.c:501-514):

1. ``dry_stencil_cheb``: the stencil on lane-major panels (B1 on the card)
   with its ring halo, Chebyshev;
2. ``dry_ell_bj``: ELL with the halo plan's all-to-all, block Jacobi;
3. ``dry_lorasc``: the distributed LORASC, one group a rank (the exact
   Schur complement chosen automatically at this separator size);
4. ``dry_stencil_bj2l``: the stencil with two-level block Jacobi
   (24-row blocks, rigid-body coarse space);
5. ``dry_lorasc_2level``: LORASC on a (n_ranks / 2, 2) mesh,
   max_deflation 16;
6. ``dry_lorasc_deflation``: LORASC with the Lanczos deflation
   (exact_schur=False, correction="deflate", max_deflation 64, omin).

As in the JAX dry run, LORASC must take the fewest iterations. The rank
functions (``ecg_paths``, ``lorasc_paths``) are also what chip_smoke's
``[sharded_dryrun]`` and ``[dlorasc_dryrun]`` run inside their own spawns.

    python -m prealps_tpu_torch.dryrun --ranks 8 --device cuda:0
"""

from __future__ import annotations

import argparse
import hashlib
import shutil
import tempfile
import time

import numpy as np

TOL = 1e-6
MAXITER = 6000
ECG_PATHS = {   # name -> (DistributedECG.build keywords, layout)
    "dry_stencil_cheb": (dict(fmt="stencil", br=3, precond="chebyshev"), "tbn"),
    "dry_ell_bj": (dict(fmt="ell", precond="block_jacobi"), "nt"),
    "dry_stencil_bj2l": (dict(fmt="stencil", br=3, precond="bj2l", block_size=24,
                              grid=(9, 9, 8)), "tbn"),
}
LORASC_PATHS = ("dry_lorasc", "dry_lorasc_2level", "dry_lorasc_deflation")


def problem(dtype, nel: int = 8):
    """``__graft_entry__._problem(nel)``: het elasticity3d(nel³), RAC-scaled,
    b = default_rng(0).standard_normal, both in ``dtype``."""
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.core.scaling import sym_rac_scaling

    a, _ = sym_rac_scaling(elasticity3d(nel, nel, nel))
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(dtype)
    return a.astype(dtype), b


def lorasc_build_args(name: str, world: int):
    """(DistributedLorascECG.build keywords, ECG variant) of a LORASC path."""
    if name == "dry_lorasc":
        return dict(nshards=world), "odir_fused"
    if name == "dry_lorasc_2level":
        return dict(mesh_shape=(world // 2, 2), max_deflation=16), "odir_fused"
    return dict(nshards=world, exact_schur=False, correction="deflate",
                max_deflation=64), "omin"


def _record(a, b, x, info, secs):
    return {"iters": int(info["iters"]), "refine_rounds": info.get("refine_rounds"),
            "breakdown": bool(info["breakdown"]),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "finite": bool(np.all(np.isfinite(x))), "secs": secs,
            "x_sha": hashlib.sha256(x.tobytes()).hexdigest()}


def ecg_paths(group, runs, device):
    """One rank's ``DistributedECG`` dry-run paths: each (name, "f32" or
    "f64") of ``runs`` built over the group on ``device`` (scale=False: the
    problem is scaled already) and solved, B1's launch count zeroed just
    before the solve and read just after. Returns name_dtype -> record."""
    from prealps_tpu_torch.ops.spmm import stencil_flat_ext
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions
    from prealps_tpu_torch.utils.timing import sync

    out = {}
    for path, dt in runs:
        dtype = np.float32 if dt == "f32" else np.float64
        a, b = problem(dtype)
        kw, layout = ECG_PATHS[path]
        solver = DistributedECG.build(
            a, nshards=mesh.size_of(group), scale=False, dtype=dtype,
            device=device, group=group,
            opts=ECGOptions(t=2, tol=TOL, maxiter=MAXITER, variant="odir_fused",
                            layout=layout), **kw)
        stencil_flat_ext.launches = 0
        sync(device)
        t0 = time.perf_counter()
        x, info = solver.solve(b)
        sync(device)
        rec = _record(a, b, x, info, time.perf_counter() - t0)
        rec.update(path=path, dtype=dt, launches=stencil_flat_ext.launches,
                   n_pad=solver.layout.n_pad,
                   nodes_a_shard=getattr(solver.operands, "nrb", None),
                   halo=getattr(solver.operands, "halo", None))
        out[f"{path}_{dt}"] = rec
    return out


def lorasc_paths(group, device, names=LORASC_PATHS, dtype=np.float32):
    """One rank's ``DistributedLorascECG`` dry-run paths in ``dtype`` over
    the group on ``device``. Returns name -> record (with the deflated
    pairs and the mesh)."""
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a, b = problem(dtype)
    out = {}
    for name in names:
        kw, variant = lorasc_build_args(name, mesh.size_of(group))
        t0 = time.perf_counter()
        s = DistributedLorascECG.build(
            a, dtype=dtype, device=device, group=group, **kw,
            opts=ECGOptions(t=2, tol=TOL, maxiter=MAXITER, variant=variant))
        x, info = s.solve(b)
        rec = _record(a, b, x, info, time.perf_counter() - t0)
        rec.update(deflated=int(info["deflated"]), mesh=[s.ngroups, s.nlocal],
                   ng_max=s.ng_max)
        out[name] = rec
    return out


def _dryrun_rank(rank, group, device, dtype):
    from prealps_tpu_torch.parallel import mesh

    dev = mesh.shard_device(device, rank)
    dt = "f32" if np.dtype(dtype) == np.float32 else "f64"
    out = ecg_paths(group, [(p, dt) for p in ("dry_stencil_cheb", "dry_ell_bj")],
                    dev)
    out.update(lorasc_paths(group, dev, ("dry_lorasc",), dtype))
    out.update(ecg_paths(group, [("dry_stencil_bj2l", dt)], dev))
    out.update(lorasc_paths(group, dev, ("dry_lorasc_2level", "dry_lorasc_deflation"),
                            dtype))
    return out


NAMES = {"dry_stencil_cheb": "stencil+cheb", "dry_ell_bj": "ell+bj",
         "dry_lorasc": "lorasc", "dry_stencil_bj2l": "stencil+bj2l",
         "dry_lorasc_2level": "lorasc 2-level mesh",
         "dry_lorasc_deflation": "lorasc deflation"}


def dryrun_multichip(n_ranks: int, device="cuda", backend: str = "gloo",
                     dtype=np.float32, timeout: float = 900.0) -> dict:
    """Build and solve the six paths over ``n_ranks`` spawned ranks (a
    ``backend`` group through a FileStore; ``device="cuda"`` is
    ``cuda:{rank}``, ``"cuda:0"`` one card the ranks share through gloo,
    ``"cpu"`` the host; every path in ``dtype``). Every rank must return
    the same x, each path converge (relres < 100·tol, finite x), the
    deflation path deflate at least one pair, and LORASC need the fewest
    iterations. Prints one line a path and returns name -> rank 0's
    record."""
    from prealps_tpu_torch.config import resolve_device
    from prealps_tpu_torch.parallel import mesh

    if n_ranks < 4 or n_ranks % 2:
        raise ValueError(f"the dry run needs an even number of ranks >= 4 (the "
                         f"(n/2, 2) LORASC mesh), got {n_ranks}")
    resolve_device(device)
    store = tempfile.mkdtemp(prefix="prealps_dryrun_")
    try:
        ranks = mesh.spawn(_dryrun_rank, n_ranks, args=(device, dtype),
                           init_method=f"file://{store}/store", backend=backend,
                           timeout=timeout)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    out = {}
    for key, rec in ranks[0].items():
        name = key[:-4] if key.endswith(("_f32", "_f64")) else key
        if any(r[key]["x_sha"] != rec["x_sha"] for r in ranks):
            raise AssertionError(f"{name}: the ranks returned different x")
        if not rec["finite"]:
            raise AssertionError(f"non-finite result from {NAMES[name]}")
        if not rec["relres"] < 100 * TOL:
            raise AssertionError(f"{NAMES[name]} did not converge: relres="
                                 f"{rec['relres']:.3e}")
        print(f"dryrun_multichip({n_ranks}) {NAMES[name]}: iters={rec['iters']} "
              f"relres={rec['relres']:.3e}", flush=True)
        out[name] = rec
    if out["dry_lorasc_deflation"]["deflated"] < 1:
        raise AssertionError("the deflation eigensolve yielded no pairs: the "
                             "path under test did not run")
    iters = {NAMES[k]: v["iters"] for k, v in out.items()}
    for name in ("lorasc", "lorasc 2-level mesh", "lorasc deflation"):
        if not iters[name] < iters["ell+bj"]:
            raise AssertionError(f"{name} needs more iterations than ell+bj: {iters}")
    if iters["lorasc"] != min(iters.values()):
        raise AssertionError(f"lorasc is not the fewest iterations: {iters}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device, args.backend,
                     np.float32 if args.dtype == "f32" else np.float64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
