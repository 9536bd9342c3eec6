"""General (irregular, non-stencil) matrix SpMM: the port of
``examples/bench_spmm_general.py``.

The reference's mkl_dcsrmm runs any CSR matrix at memory speed
(utils/cplm_light/cplm_kernels.c:620-671). The matrix is the JAX script's
random geometric graph (``random_geometric_spd``: kNN, k 25, in the unit
cube from seed 0; n = ``--npts``, default 420,000), applied to an
(n, t) panel by the port driver's two general routes:

* DIA+ELL after RCM (``csr_to_dia_ell_auto``): ``DiaLaneOperands`` of a
  ``DistributedECG`` build with ``fmt="dia"`` on lane-major panels, B1 at
  br 1 on the promoted diagonals plus the plain remainder gather;
* 8×8 block-ELL under the Morton order of the points' coordinates: the
  driver's ``BlockEllOperands`` with B5 (``block_ell_spmm_pallas``) on the
  blocks' packed nonzero entries.

Each product must be within 1e-4 (relative) of scipy's in the build's
ordering, as in JAX (1e-10 in f64). Beside them the headline stencil operator
(elasticity3d ``--stencil-nel``³, homogeneous; B1 on lane-major panels) is
timed in the same run, so JAX's target, the general path within 3× of the
stencil path's Gnnz/s, is read on one card. On the card (the default) the
run is f32 and every time is device time (``timing.py::device_ms``); on the
CPU f64 and the host clock. It prints the card's name and power limit and
one JSON line a product (``gnnz_per_s`` = nnz / ms / 1e6), then one line
with the ratios.

    python -m prealps_tpu_torch.examples.bench_spmm_general
    python -m prealps_tpu_torch.examples.bench_spmm_general --npts 3000 --stencil-nel 4 --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import scipy.sparse as sp

TARGET_RATIO = 3.0


def random_geometric_spd(npts: int, k: int = 25, seed: int = 0):
    """SPD matrix on a random geometric graph (kNN in the unit cube): the
    JAX script's generator."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = rng.random((npts, 3))
    tree = cKDTree(pts)
    _, idx = tree.query(pts, k=k + 1)           # self + k neighbors
    rows = np.repeat(np.arange(npts), k)
    cols = idx[:, 1:].ravel()
    vals = -np.exp(-rng.random(rows.size))      # negative off-diagonals
    a = sp.coo_matrix((vals, (rows, cols)), shape=(npts, npts))
    a = a.minimum(a.T) + a.minimum(a.T).T - a.minimum(a.T).multiply(0)
    a = 0.5 * (a + a.T).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    d = -np.asarray(a.sum(axis=1)).ravel() + 1e-3
    a = a + sp.diags(d)                         # diagonally dominant -> SPD
    return a.tocsr()


def morton_order(npts: int, seed: int = 0) -> np.ndarray:
    """The Morton (z-order) permutation of the generator's points, 10 bits
    a coordinate (the JAX script's)."""
    pts = np.random.default_rng(seed).random((npts, 3))
    q = np.minimum((pts * 1024).astype(np.int64), 1023)

    def spread(v):
        v = v.astype(np.int64)
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def run(npts: int = 420_000, t: int = 12, stencil_nel: int = 36, reps: int = 20,
        seed: int = 0, device="cuda"):
    """Yield one record a product (see the module docstring)."""
    from prealps_tpu_torch.config import resolve_device, strict_fp32
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.measure import driver_operator, product_ms
    from prealps_tpu_torch.ops.formats import csr_to_dia_ell_auto, dia_coverage

    device = resolve_device(device)
    strict_fp32()
    dtype = np.float32 if device.type == "cuda" else np.float64
    platform = "gpu" if device.type == "cuda" else "cpu"
    a = random_geometric_spd(npts, seed=seed)
    n, nnz = a.shape[0], a.nnz
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, t)).astype(dtype)

    de, perm = csr_to_dia_ell_auto(a, min_fill=0.05)
    ap = a if perm is None else sp.csr_matrix(a[perm][:, perm])
    xp = x if perm is None else x[perm]
    ms, err = product_ms("dia", *driver_operator(ap, "dia", dtype, device), ap, xp,
                         reps, device)
    ndiag = len(de.offsets)
    rem_nnz = int((de.rem.vals != 0).sum()) if de.rem is not None else 0
    yield {"metric": "spmm_general_geometric_dia_ell", "ms": ms,
           "gnnz_per_s": nnz / ms / 1e6, "relerr": err, "platform": platform,
           "n": n, "nnz": nnz, "t": t, "ndiag": ndiag,
           "dia_coverage": dia_coverage(ap, 0.05),
           "remainder_frac": rem_nnz / nnz, "rcm": perm is not None}

    pm = morton_order(npts, seed)
    am = sp.csr_matrix(a[pm][:, pm])
    xb = rng.standard_normal((-(-n // 8) * 8, t)).astype(dtype)[:n]
    ms, err = product_ms("block_ell_morton",
                         *driver_operator(am, "block_ell_morton", dtype, device), am,
                         xb, reps, device)
    yield {"metric": "spmm_general_geometric_blockell_morton", "ms": ms,
           "gnnz_per_s": nnz / ms / 1e6, "relerr": err, "platform": platform,
           "n": n, "nnz": nnz, "t": t}

    s = elasticity3d(stencil_nel, stencil_nel, stencil_nel, heterogeneous=False)
    xs = rng.standard_normal((s.shape[0], t)).astype(dtype)
    ms, err = product_ms("stencil", *driver_operator(s, "stencil", dtype, device), s,
                         xs, reps, device)
    yield {"metric": "spmm_stencil_headline", "ms": ms,
           "gnnz_per_s": s.nnz / ms / 1e6, "relerr": err, "platform": platform,
           "n": s.shape[0], "nnz": s.nnz, "t": t, "nel": stencil_nel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npts", type=int, default=420_000)
    ap.add_argument("--t", type=int, default=12)
    ap.add_argument("--stencil-nel", type=int, default=36)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from prealps_tpu_torch.config import resolve_device
    from prealps_tpu_torch.timing import card_line

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(json.dumps({"card": card, "npts": args.npts, "t": args.t}), flush=True)
    recs = {}
    for rec in run(args.npts, args.t, args.stencil_nel, args.reps, device=device):
        recs[rec["metric"]] = rec
        print(json.dumps(rec), flush=True)
    stencil = recs.pop("spmm_stencil_headline")["gnnz_per_s"]
    ratios = {k: stencil / r["gnnz_per_s"] for k, r in recs.items()}
    print(json.dumps({"metric": "spmm_general_vs_stencil", "card": card,
                      "stencil_over_general": ratios,
                      "within_target": {k: v <= TARGET_RATIO for k, v in ratios.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
