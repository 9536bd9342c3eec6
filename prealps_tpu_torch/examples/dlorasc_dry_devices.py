"""Which device decides the f32 counts of the dry-run LORASC paths.

The three distributed LORASC builds of chip_smoke's ``[dlorasc_dryrun]``
(het elasticity3d 8³, RAC-scaled, f32, ECG t 2 to 1e-6 with host-f64
refinement rounds, 8 gloo ranks sharing one card): "dry_lorasc" (exact
Schur over 8 ranks), "dry_lorasc_2level" (mesh (4, 2), max_deflation 16)
and "dry_lorasc_deflation" (omin, correction="deflate", max_deflation
64). Each is built on the card and on the host, and each build is solved
on both (its operands moved to the other device), so a count that moves
with the device can be traced to the build or to the solve. It prints,
per path and (build, solve) pair, the iterations, the deflated pairs,
each refinement round's (iterations, final ‖r‖ / ‖rhs‖) and the host f64
relres, and writes them to ``--out`` as JSON. On a card::

    python -m prealps_tpu_torch.examples.dlorasc_dry_devices

``--devices cpu`` runs the host pair alone (no card needed). ``--variant``
replaces every path's ECG variant: ``--paths dry_lorasc_deflation --variant
odir_fused`` is the JAX dry run's path 6 as it first ran (ROADMAP A4: JAX
took 4,417 iterations with odir_fused and 88 with omin, f32 with x64 off).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile

import numpy as np

from prealps_tpu_torch.dryrun import LORASC_PATHS, lorasc_build_args

# the dry run's LORASC builds over 8 ranks: keywords and ECG variant
PATHS = {name: lorasc_build_args(name, 8) for name in LORASC_PATHS}


def moved(obj, device):
    """``obj`` with every tensor in it (dicts and dataclasses walked) on
    ``device``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: moved(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _rank(rank, group, paths, devices, variant=None):
    import torch

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a, _ = sym_rac_scaling(elasticity3d(8, 8, 8))
    a = a.astype(np.float32)
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(np.float32)
    out = {}
    for path in paths:
        kw, path_variant = PATHS[path]
        opts = ECGOptions(t=2, tol=1e-6, maxiter=6000, variant=variant or path_variant)
        for build_dev in devices:
            s = DistributedLorascECG.build(a, dtype=np.float32, device=build_dev,
                                           group=group, opts=opts, **kw)
            for solve_dev in devices:
                dev = torch.device(solve_dev)
                t = s if solve_dev == build_dev else dataclasses.replace(
                    s, ops=moved(s.ops, dev), device=dev)
                rounds = []
                ecg = t._ecg

                def recorded(b_loc, ecg=ecg, rounds=rounds):
                    res = ecg(b_loc)
                    rounds.append([int(res.iters), float(res.res) / float(res.normb)])
                    return res

                t._ecg = recorded
                x, info = t.solve(b)
                out.setdefault(path, []).append({
                    "build": build_dev, "solve": solve_dev, "variant": opts.variant,
                    "iters": int(info["iters"]),
                    "deflated": int(info["deflated"]), "rounds": rounds,
                    "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--devices", default="cuda:0,cpu")
    ap.add_argument("--variant", default=None,
                    help="ECG variant of every path (default: each path's own)")
    ap.add_argument("--out", default="chiprun_out/dlorasc_dry_devices.json")
    args = ap.parse_args(argv)
    import os

    import torch

    from prealps_tpu_torch.parallel import mesh

    devices = args.devices.split(",")
    if any(d.startswith("cuda") for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("--devices names a card but torch.cuda.is_available() is "
                           "False (pass --devices cpu)")
    paths = args.paths.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        out = mesh.spawn(_rank, 8, args=(paths, devices, args.variant),
                         init_method=f"file://{tmp}/store",
                         timeout=900, threads=1)[0]
    for path, recs in out.items():
        for r in recs:
            print(f"{path} ({r['variant']}) build {r['build']} solve {r['solve']}: "
                  f"{r['iters']} "
                  f"iterations, {r['deflated']} pairs, rounds (iters, |r|/|rhs|) "
                  f"{[(i, round(v, 8)) for i, v in r['rounds']]}, relres "
                  f"{r['relres']:.3e}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
