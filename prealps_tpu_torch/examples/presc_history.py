"""Residual histories of the small PRESC / bf16-store LORASC solves.

Builds ``StencilLorascECG`` on het elasticity3d (f32, device double-float
refinement to ``--tol``) with the SSLOC pencil and with ``a_store="bf16"``,
both on bf16 factors by default, and prints one JSON line per solve: the
deflated count, each refinement round's ECG iterations, breakdown flag and
‖R‖_F history (relative to the round's ‖b‖), and the final host f64
relres. Run it on the CPU and on the card with the same arguments to
compare the two histories::

    python -m prealps_tpu_torch.examples.presc_history --device cpu
    python -m prealps_tpu_torch.examples.presc_history --device cuda \\
        --nparts 4 --t 4 --max-deflation 24
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from prealps_tpu_torch.core.generators import elasticity3d
from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

CASES = {"sloc": dict(pencil="sloc"), "saloc": dict(pencil="saloc"),
         "a_store_bf16": dict(a_store="bf16"), "agg": {}}


def run_case(name, a, b, args):
    grid = tuple(args.grid or (args.nel + 1, args.nel + 1, args.nel))
    kw = dict(nparts=args.nparts, br=3, grid=grid,
              max_deflation=args.max_deflation, restarts=args.restarts,
              correction="deflate",
              dtype=np.float32, factor_store=args.factor_store,
              opts=ECGOptions(t=args.t, tol=args.tol, maxiter=1000,
                              variant="omin", layout="tbn"))
    s = StencilLorascECG.build(a, device=args.device, **kw, **CASES[name])
    rounds = []
    ecg = s._ecg

    def _ecg(b_lane):
        res = ecg(b_lane)
        hist = res.history[: int(res.iters) + 1].double().cpu().numpy()
        rounds.append({"iters": int(res.iters), "breakdown": bool(res.breakdown),
                       "relres_history": [float(h) / float(res.normb) for h in hist
                                          if h >= 0]})
        return res

    s._ecg = _ecg
    x, info = s.solve(b)
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    return {"case": name, "device": str(args.device), "nel": args.nel,
            "nparts": args.nparts,
            "t": args.t, "factor_store": args.factor_store,
            "max_deflation": args.max_deflation, "restarts": args.restarts,
            "lanczos_s": s.precond.timings.get("lanczos"),
            "deflated": int(info["deflated"]), "iters": int(info["iters"]),
            "breakdown": bool(info["breakdown"]), "relres": relres,
            "rounds": rounds}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--nel", type=int, default=8)
    p.add_argument("--nparts", type=int, default=4)
    p.add_argument("--grid", type=int, nargs=3, default=None,
                   help="node grid of the box partition (nel+1, nel+1, nel)")
    p.add_argument("--t", type=int, default=4)
    p.add_argument("--max-deflation", type=int, default=24)
    p.add_argument("--restarts", type=int, default=5,
                   help="thick restarts of the deflation Lanczos")
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--factor-store", default="bf16")
    p.add_argument("--cases", default="sloc,a_store_bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeat", type=int, default=1,
                   help="build and solve each case this many times")
    args = p.parse_args(argv)
    a = elasticity3d(args.nel, args.nel, args.nel, heterogeneous=True)
    b = np.random.default_rng(args.seed).standard_normal(a.shape[0])
    for name in args.cases.split(","):
        for _ in range(args.repeat):
            print(json.dumps(run_case(name, a, b, args)), flush=True)


if __name__ == "__main__":
    main()
