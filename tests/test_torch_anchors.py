"""Iteration anchors of chip_smoke.py's paths, from the JAX package on the
CPU, and the port held to them at a small size.

Several chip_smoke.py phases have no JAX record to hold their iteration
counts to: ``[dia]``, ``[cheb]``, ``[dedup]`` and ``[bj2l_nogrid]``. Their
anchors are the JAX driver's counts at the same configuration (``PATHS``),
computed once on a CPU with

    JAX_PLATFORMS=cpu python -m tests.test_torch_anchors --path dia --nel 36

(``--path`` one of dia, cheb, dedup, bj2l_nogrid) and written into
chip_smoke.py (``*_ANCHOR_ITERS``) with their origin. The tests below run
the same function at a small nel and hold the port's CPU solve to it
within the band chip_smoke.py uses (10 %).
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


def path_config(path: str, nel: int, block_size: int = 240) -> dict:
    """DistributedECG.build keywords of a chip_smoke phase (bench.py's
    configuration of the same record: PREALPS_BENCH_PRECOND=chebyshev,
    PREALPS_BENCH_PRECOND=bj PREALPS_BENCH_BJ_DEDUPE=1, and the headline
    bj2l with grid=None)."""
    grid = (nel + 1, nel + 1, nel)
    if path == "dia":
        return dict(DIA_CONFIG)
    if path == "cheb":
        return dict(fmt="stencil", br=3, precond="chebyshev", cheb_degree=8,
                    dtype=np.float32)
    if path == "dedup":
        return dict(fmt="stencil", br=3, precond="bj", block_size=block_size,
                    grid=grid, bj_dedupe=True, dtype=np.float32)
    if path == "bj2l_nogrid":
        return dict(fmt="stencil", br=3, precond="bj2l", block_size=block_size,
                    grid=None, dtype=np.float32)
    raise ValueError(f"unknown path {path!r}")


PATHS = ("dia", "cheb", "dedup", "bj2l_nogrid")


def _problem(nel):
    a = elasticity3d(nel, nel, nel, heterogeneous=False)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def jax_anchor(path: str, nel: int, block_size: int = 240) -> dict:
    """The JAX driver's solve at a chip_smoke phase's configuration."""
    a, b = _problem(nel)
    t0 = time.perf_counter()
    s = JaxECG.build(a, nshards=1, opts=JaxOptions(**DIA_OPTS),
                     **path_config(path, nel, block_size))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    return {"path": path, "nel": nel, "n": a.shape[0], "iters": int(info["iters"]),
            "refine_rounds": int(info["refine_rounds"]),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "breakdown": bool(info["breakdown"]), "build_s": build_s,
            "solve_s": time.perf_counter() - t0}


def jax_dia_anchor(nel: int) -> dict:
    """The JAX driver's DIA solve at chip_smoke's configuration."""
    return jax_anchor("dia", nel)


def _port_solve(path, nel, block_size=240):
    a, b = _problem(nel)
    s = DistributedECG.build(a, nshards=1, opts=ECGOptions(**DIA_OPTS),
                             device="cpu", **path_config(path, nel, block_size))
    x, info = s.solve(b)
    assert np.linalg.norm(b - a @ x) < 1e-5 * np.linalg.norm(b)
    return s, info


def _within(info, anchor):
    assert anchor["relres"] < 1e-5 and not anchor["breakdown"]
    assert abs(info["iters"] - anchor["iters"]) <= BAND * anchor["iters"]


def test_port_dia_solve_within_band_of_jax_anchor():
    anchor = jax_dia_anchor(6)
    s, info = _port_solve("dia", 6)
    assert len(s.operands.offsets) == 99 and s.operands.precond_kind == "bj_flat"
    _within(info, anchor)


def test_port_cheb_solve_within_band_of_jax_anchor():
    anchor = jax_anchor("cheb", 5)
    s, info = _port_solve("cheb", 5)
    assert s.operands.precond_kind == "chebyshev"
    _within(info, anchor)


def test_port_dedup_solve_within_band_of_jax_anchor():
    # block_size 24 -> the x-line (11 nodes) is nearest 8 nodes: x-line blocks
    anchor = jax_anchor("dedup", 10, block_size=24)
    s, info = _port_solve("dedup", 10, block_size=24)
    assert s.operands.precond_kind == "bj_dedup"
    _within(info, anchor)


def test_port_bj2l_nogrid_solve_within_band_of_jax_anchor():
    anchor = jax_anchor("bj2l_nogrid", 6, block_size=24)
    s, info = _port_solve("bj2l_nogrid", 6, block_size=24)
    assert s.operands.precond_kind == "bj2l"
    _within(info, anchor)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ap = argparse.ArgumentParser(
        description="JAX CPU anchor of a chip_smoke phase")
    ap.add_argument("--path", choices=PATHS, default="dia")
    ap.add_argument("--nel", type=int, default=36)
    ap.add_argument("--block-size", type=int, default=240)
    args = ap.parse_args()
    print(json.dumps(jax_anchor(args.path, args.nel, args.block_size)))
