"""The PRESC pencils in chip_smoke.py's configuration, the port against the
JAX package on the CPU, and the readings between the small tests and 36³.

chip_smoke.py's ``[presc]`` and ``[saloc]`` phases build the het LORASC
record's configuration (8 box parts on the (nel+1, nel+1, nel) node grid,
nev 256, the balancing ("deflate") correction, f32 with double-float
refinement to 1e-5, ECG t = 12 omin, bf16 factors) at nel 36, where the
JAX package cannot be run beside the card. The same function of both
packages runs here at a small nel; at a larger one, print both readings
with

    JAX_PLATFORMS=cpu python -m tests.test_torch_presc_scale --nel 18 --pencils saloc

(one JSON line a package and pencil: deflated pairs, iterations, relres;
``--nparts``, ``--t``, ``--max-deflation`` and ``--factor-store`` give
other configurations, such as the card test's 4 parts at t 4).
The test holds the port's deflated pairs equal to JAX's and its
iterations within ±1 at nel 8.
"""

import argparse
import json
import time

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel import lorasc_stencil as jstl
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel import lorasc_stencil as tstl
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


def chip_config(nel: int, pencil: str, nparts: int = 8, max_deflation: int = 256,
                factor_store: str = "bf16") -> dict:
    """StencilLorascECG.build keywords of chip_smoke.py's lorasc_build with
    the pencil and bf16 factors (``[presc]`` / ``[saloc]``); the other
    arguments give the card test's smaller configurations."""
    return dict(nparts=nparts, br=3, grid=(nel + 1, nel + 1, nel),
                max_deflation=max_deflation, correction="deflate", inner_tol=1e-3,
                dtype=np.float32, pencil=pencil, factor_store=factor_store)


def reading(pkg: str, pencil: str, nel: int, t: int = 12, **config) -> dict:
    """Build and solve het elasticity3d(nel³) with one package (ECG t omin
    to 1e-5; ``config`` goes to ``chip_config``)."""
    a = elasticity3d(nel, nel, nel, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    mod, opts_cls, extra = ((jstl, JaxOptions, {}) if pkg == "jax"
                            else (tstl, ECGOptions, dict(device="cpu")))
    t0 = time.perf_counter()
    s = mod.StencilLorascECG.build(
        a, opts=opts_cls(t=t, tol=1e-5, maxiter=3000, variant="omin", layout="tbn"),
        **chip_config(nel, pencil, **config), **extra)
    build_s = time.perf_counter() - t0
    x, info = s.solve(b)
    return {"pkg": pkg, "pencil": pencil, "nel": nel, "n": a.shape[0], "t": t, **config,
            "deflated": int(s.precond.deflated), "iters": int(info["iters"]),
            "breakdown": bool(info["breakdown"]),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "build_s": build_s}


@pytest.mark.parametrize("pencil", ["saloc", "sloc"])
def test_chip_config_pairs_match_jax(pencil):
    ref = reading("jax", pencil, 8)
    got = reading("torch", pencil, 8)
    for r in (ref, got):
        assert not r["breakdown"] and r["relres"] < 1e-5, r
    assert got["deflated"] == ref["deflated"] > 0, (got, ref)
    assert abs(got["iters"] - ref["iters"]) <= 1, (got, ref)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(
        description="PRESC pencils of both packages in chip_smoke's configuration")
    ap.add_argument("--nel", type=int, default=14)
    ap.add_argument("--pencils", default="saloc,sloc")
    ap.add_argument("--nparts", type=int, default=8)
    ap.add_argument("--t", type=int, default=12)
    ap.add_argument("--max-deflation", type=int, default=256)
    ap.add_argument("--factor-store", default="bf16")
    args = ap.parse_args()
    for pencil in args.pencils.split(","):
        for pkg in ("jax", "torch"):
            print(json.dumps(reading(pkg, pencil, args.nel, t=args.t, nparts=args.nparts,
                                     max_deflation=args.max_deflation,
                                     factor_store=args.factor_store)), flush=True)
