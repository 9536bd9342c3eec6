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

The sharded phases take theirs from the JAX driver over ``--nshards`` CPU
devices:

    JAX_PLATFORMS=cpu python -m tests.test_torch_anchors --path sharded4 --nel 36 --nshards 4
    JAX_PLATFORMS=cpu python -m tests.test_torch_anchors --path dry_ell_bj --nshards 4 [--dtype f64]

``sharded4`` is the headline's configuration (``[sharded4]``); the
``dry_*`` paths are ``__graft_entry__.dryrun_multichip``'s three
DistributedECG solves (nel 8, heterogeneous, RAC-scaled before the build,
t 2, tol 1e-6, f32 here as on the card; ``[sharded_dryrun]``). The k-way
partition of ``dry_ell_bj`` runs the JAX package's Python algorithm
(``PREALPS_TPU_NO_NATIVE=1``), the one the port copies.
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


# __graft_entry__.dryrun_multichip's DistributedECG paths: build keywords
# and layout (t 2, tol 1e-6, maxiter 6000, odir_fused, scale=False)
DRYRUN = {
    "dry_stencil_cheb": (dict(fmt="stencil", br=3, precond="chebyshev"), "tbn"),
    "dry_ell_bj": (dict(fmt="ell", precond="block_jacobi"), "nt"),
    "dry_stencil_bj2l": (dict(fmt="stencil", br=3, precond="bj2l", block_size=24,
                              grid=(9, 9, 8)), "tbn"),
}
DRYRUN_NEL = 8
PATHS = ("dia", "cheb", "dedup", "bj2l_nogrid", "sharded4", *DRYRUN)


def dryrun_problem(elasticity3d, sym_rac_scaling, nel=DRYRUN_NEL, dtype=np.float32):
    """``__graft_entry__._problem``: heterogeneous elasticity3d(nel³), RAC
    scaled, and b = default_rng(0), both in ``dtype`` (either package's
    generator and scaling, which are bitwise equal)."""
    a, _ = sym_rac_scaling(elasticity3d(nel, nel, nel))
    b = np.random.default_rng(0).standard_normal(a.shape[0]).astype(dtype)
    return a.astype(dtype), b


def dryrun_build(path: str, dtype=np.float32):
    """(build keywords, ECGOptions fields) of a dryrun path."""
    kw, layout = DRYRUN[path]
    return (dict(kw, scale=False, dtype=dtype),
            dict(t=2, tol=1e-6, maxiter=6000, variant="odir_fused", layout=layout))


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


def jax_sharded_anchor(path: str, nel: int, nshards: int, dtype=np.float32) -> dict:
    """The JAX driver's solve of a sharded chip_smoke phase over
    ``nshards`` CPU devices: the headline's configuration (``sharded4``) or
    a dryrun path."""
    import os

    from prealps_tpu.core.scaling import sym_rac_scaling

    os.environ["PREALPS_TPU_NO_NATIVE"] = "1"
    if path == "sharded4":
        a, b = _problem(nel)
        kw = dict(fmt="stencil", br=3, precond="bj2l", block_size=240,
                  grid=(nel + 1, nel + 1, nel), dtype=np.float32)
        opts = DIA_OPTS
    else:
        a, b = dryrun_problem(elasticity3d, sym_rac_scaling, dtype=dtype)
        kw, opts = dryrun_build(path, dtype)
    t0 = time.perf_counter()
    s = JaxECG.build(a, nshards=nshards, opts=JaxOptions(**opts), **kw)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    return {"path": path, "nel": nel if path == "sharded4" else DRYRUN_NEL,
            "nshards": nshards, "dtype": np.dtype(kw["dtype"]).name,
            "n": a.shape[0], "n_pad": s.layout.n_pad,
            "iters": int(info["iters"]),
            "refine_rounds": int(info.get("refine_rounds", 0)),
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


def test_dryrun_problem_is_the_graft_entry_problem():
    """chip_smoke's [sharded_dryrun] problem, built from the port's
    generator and scaling, is ``__graft_entry__._problem(nel=8)``'s."""
    from __graft_entry__ import _problem as graft_problem
    from prealps_tpu_torch.core.generators import elasticity3d as t_elasticity3d
    from prealps_tpu_torch.core.scaling import sym_rac_scaling

    a_t, b_t = dryrun_problem(t_elasticity3d, sym_rac_scaling)
    a_j, b_j = graft_problem(nel=DRYRUN_NEL, dtype=np.float32)
    assert (a_t != a_j).nnz == 0 and a_t.dtype == a_j.dtype == np.float32
    np.testing.assert_array_equal(b_t, b_j)


if __name__ == "__main__":
    import jax

    ap = argparse.ArgumentParser(
        description="JAX CPU anchor of a chip_smoke phase")
    ap.add_argument("--path", choices=PATHS, default="dia")
    ap.add_argument("--nel", type=int, default=36)
    ap.add_argument("--block-size", type=int, default=240)
    ap.add_argument("--nshards", type=int, default=1,
                    help="CPU devices of the sharded paths (sharded4, dry_*)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32",
                    help="the dry_* paths' type (the card runs f32 on the stencil)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", max(8, args.nshards))
    jax.config.update("jax_enable_x64", True)
    if args.path == "sharded4" or args.path in DRYRUN:
        dtype = np.float32 if args.dtype == "f32" else np.float64
        print(json.dumps(jax_sharded_anchor(args.path, args.nel, args.nshards, dtype)))
    else:
        print(json.dumps(jax_anchor(args.path, args.nel, args.block_size)))
