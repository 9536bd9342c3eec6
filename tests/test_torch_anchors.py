"""Iteration anchors of chip_smoke.py's paths, from the JAX package on the
CPU, and the port held to them at a small size.

chip_smoke.py's ``[dia]`` phase has no JAX record to hold its iteration
count to; its anchor is the JAX driver's count at the same configuration
(``DIA_CONFIG``), computed once on a CPU with

    JAX_PLATFORMS=cpu python -m tests.test_torch_anchors --nel 36

and written into chip_smoke.py (DIA_ANCHOR_ITERS) with its origin. The
test below runs the same function at nel = 6 and holds the port's CPU
solve to it within the band chip_smoke.py uses (10 %).
"""

import argparse
import json
import time

import numpy as np
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

# chip_smoke.py [dia]: the promoted-diagonal operator on lane-major panels
DIA_CONFIG = dict(fmt="dia", precond="bj", grid=None, dtype=np.float32)
DIA_OPTS = dict(t=12, tol=1e-5, maxiter=3000, variant="odir_fused", layout="tbn")
BAND = 0.10


def _problem(nel):
    a = elasticity3d(nel, nel, nel, heterogeneous=False)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def jax_dia_anchor(nel: int) -> dict:
    """The JAX driver's DIA solve at chip_smoke's configuration."""
    a, b = _problem(nel)
    t0 = time.perf_counter()
    s = JaxECG.build(a, nshards=1, opts=JaxOptions(**DIA_OPTS), **DIA_CONFIG)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    return {"nel": nel, "n": a.shape[0], "iters": int(info["iters"]),
            "refine_rounds": int(info["refine_rounds"]),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "breakdown": bool(info["breakdown"]), "build_s": build_s,
            "solve_s": time.perf_counter() - t0}


def test_port_dia_solve_within_band_of_jax_anchor():
    anchor = jax_dia_anchor(6)
    a, b = _problem(6)
    s = DistributedECG.build(a, nshards=1, opts=ECGOptions(**DIA_OPTS),
                             device="cpu", **DIA_CONFIG)
    assert len(s.operands.offsets) == 99 and s.operands.precond_kind == "bj_flat"
    x, info = s.solve(b)
    assert np.linalg.norm(b - a @ x) < 1e-5 * np.linalg.norm(b)
    assert anchor["relres"] < 1e-5 and not anchor["breakdown"]
    assert abs(info["iters"] - anchor["iters"]) <= BAND * anchor["iters"]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ap = argparse.ArgumentParser(description="JAX CPU anchor of chip_smoke's [dia]")
    ap.add_argument("--nel", type=int, default=36)
    print(json.dumps(jax_dia_anchor(ap.parse_args().nel)))
