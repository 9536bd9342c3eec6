"""fmt=auto validation: the port of ``examples/bench_fmt_auto.py``.

On each matrix class the format ``detect_format`` picks (the JAX rule,
``ops/formats.py``) must be the measured-best of the manual formats, or
within 10 % of it. Classes, from the JAX script's generators and seed
(``make_matrices``; at ``--scale 1``): grid stencil (elasticity3d 18³),
banded (n 120,000), shuffled kNN graph (n 120,000) and uniform random
(n 40,000).

Each format is timed by the route the port's driver takes on a card: the
operands of a ``DistributedECG`` build with that format, ``precond="none"``
and ``scale=False`` (so the product is the matrix's own), applied by their
``a_apply`` to a t-wide panel:

* ``stencil``: lane-major panels, B1 (``stencil_flat_ext``) on the flat
  block table;
* ``dia``: ``DiaLaneOperands`` on lane-major panels, B1 at br 1 on the
  promoted diagonals plus the plain remainder gather, under the order
  ``csr_to_dia_ell_auto`` takes (the driver's ``dia_rcm`` where it
  reorders); timed only where the diagonals carry half the nonzeros, as in
  JAX;
* ``block_ell_morton``: 8×8 block-ELL under the Morton order of BFS
  pseudo-coordinates, the driver's ``BlockEllOperands`` with B5
  (``block_ell_spmm_pallas``) on the blocks' packed nonzero entries (built
  directly: ``DistributedECG.build(fmt="block_ell")`` takes bk 128);
* ``ell``: ``EllOperands``, the plain gather (on the card too).

Every product is checked against scipy's ``a @ x`` in the build's
ordering (relative error under 1e-4 in f32, 1e-10 in f64). On the card
(``--device cuda``, the default) the run is f32 and each product's time is
its device time (``timing.py::device_ms``); on the CPU f64 and the host
clock, where the kernels' wrappers run their plain versions. It prints the
card's name and power limit, one JSON line a class (per-format ms and
relative error, the choice, ``auto_vs_best``) and last the worst ratio with
JAX's pass line (≤ 1.1); it exits 1 on a fail, as JAX's does.

    python -m prealps_tpu_torch.examples.bench_fmt_auto
    python -m prealps_tpu_torch.examples.bench_fmt_auto --scale 0.05 --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import scipy.sparse as sp

PASS_RATIO = 1.1
# detect_format's choice -> the measured format that runs it
CHOICE_FORMAT = {"stencil": "stencil", "dia": "dia", "dia_rcm": "dia",
                 "block_ell_morton": "block_ell_morton",
                 "block_ell_natural": "block_ell_morton", "ell": "ell"}


def make_matrices(scale: float, rng):
    """The JAX script's four classes, drawn from ``rng`` in its order."""
    from scipy.spatial import cKDTree

    from prealps_tpu_torch.core.generators import elasticity3d

    out = {}
    # 1. grid stencil
    nel = max(int(18 * scale), 6)
    out["grid_stencil"] = sp.csr_matrix(elasticity3d(nel, nel, nel))

    # 2. banded: fixed sparse diagonals (a rotor/1-D-FEM-like profile)
    n = max(int(120_000 * scale), 2000)
    offs = [0, 1, 2, 3, 5, 8, 13, 21, 34]
    mats = [sp.diags(rng.random(n - o) + 0.1, o, shape=(n, n)) for o in offs]
    band = sum(mats[1:], mats[0])
    band = (band + band.T).tocsr()
    band = band + sp.diags(np.asarray(abs(band).sum(axis=1)).ravel())
    out["banded"] = sp.csr_matrix(band)

    # 3. geometric kNN graph, shuffled (locality must be re-derived)
    npts = max(int(120_000 * scale), 2000)
    pts = rng.random((npts, 3))
    _, idx = cKDTree(pts).query(pts, k=26)
    rows = np.repeat(np.arange(npts), 25)
    a = sp.coo_matrix((np.ones(rows.size), (rows, idx[:, 1:].ravel())),
                      shape=(npts, npts))
    a = ((a + a.T) > 0).astype(np.float64)
    lap = sp.diags(np.asarray(a.sum(axis=1)).ravel() + 1.0) - a
    pm = rng.permutation(npts)
    out["geometric_shuffled"] = sp.csr_matrix(lap.tocsr()[pm][:, pm])

    # 4. uniform random pattern (no structure to extract)
    n = max(int(40_000 * scale), 1000)
    k = 24
    cols = rng.integers(0, n, size=(n, k))
    r = sp.coo_matrix(
        (rng.random(n * k), (np.repeat(np.arange(n), k), cols.ravel())),
        shape=(n, n))
    r = (r + r.T).tocsr()
    out["random"] = sp.csr_matrix(
        r + sp.diags(np.asarray(abs(r).sum(axis=1)).ravel() + 1.0))
    return out


def run(scale: float = 1.0, t: int = 12, reps: int = 20, device="cuda"):
    """Yield one record a class (see the module docstring)."""
    from prealps_tpu_torch.config import resolve_device, strict_fp32
    from prealps_tpu_torch.core.partition import morton_perm, pseudo_coords
    from prealps_tpu_torch.measure import driver_operator, product_ms
    from prealps_tpu_torch.ops.formats import (
        csr_to_dia_ell_auto,
        detect_format,
        dia_coverage,
        stencil_blocks_host,
    )

    device = resolve_device(device)
    strict_fp32()
    dtype = np.float32 if device.type == "cuda" else np.float64
    rng = np.random.default_rng(0)
    for name, a in make_matrices(scale, rng).items():
        n, nnz = a.shape[0], a.nnz
        x = rng.standard_normal((n, t)).astype(dtype)
        cases = {}
        if n % 3 == 0 and stencil_blocks_host(a, br=3) is not None:
            cases["stencil"] = (a, x)
        _, perm_d = csr_to_dia_ell_auto(a, min_fill=0.05)
        a_d = a if perm_d is None else sp.csr_matrix(a[perm_d][:, perm_d])
        if dia_coverage(a_d, 0.05) >= 0.5:   # DIA only where diagonals carry mass
            cases["dia"] = (a_d, x if perm_d is None else x[perm_d])
        pm = morton_perm(pseudo_coords(a))
        cases["block_ell_morton"] = (sp.csr_matrix(a[pm][:, pm]), x[pm])
        cases["ell"] = (a, x)
        ms, errs = {}, {}
        for fmt, (a_f, x_f) in cases.items():
            ms[fmt], errs[fmt] = product_ms(f"{name} {fmt}",
                                            *driver_operator(a_f, fmt, dtype, device),
                                            a_f, x_f, reps, device)
        chosen, _ = detect_format(a, br=3)
        auto_ms = ms.get(CHOICE_FORMAT[chosen])
        best_ms = min(ms.values())
        yield {"metric": f"fmt_auto_{name}", "chosen": chosen, "auto_ms": auto_ms,
               "best_ms": best_ms,
               "auto_vs_best": auto_ms / best_ms if auto_ms else float("inf"),
               "per_format_ms": ms, "per_format_relerr": errs, "n": n, "nnz": nnz,
               "t": t, "dtype": np.dtype(dtype).name,
               "platform": "gpu" if device.type == "cuda" else "cpu",
               "gnnz_per_s_auto": nnz / auto_ms / 1e6 if auto_ms else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=12)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="problem-size multiplier")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from prealps_tpu_torch.config import resolve_device
    from prealps_tpu_torch.timing import card_line

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(json.dumps({"card": card, "scale": args.scale, "t": args.t}), flush=True)
    worst = 1.0
    for rec in run(args.scale, args.t, args.reps, device):
        worst = max(worst, rec["auto_vs_best"])
        print(json.dumps(rec), flush=True)
    ok = worst <= PASS_RATIO
    print(json.dumps({"metric": "fmt_auto_worst_ratio", "value": worst, "pass": ok,
                      "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
