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

``sharded4`` is the headline's configuration (``[sharded4]``),
``sharded_general4`` the general path's (``[general]``: block-ELL, host
block Jacobi with 240-row blocks, t 12 on ``nt``, f32; the JAX side runs
``fmt="block_ell_xla"``) and ``sharded_dia4`` DIA's (``[dia]``); the
``dry_*`` paths are ``__graft_entry__.dryrun_multichip``'s three
DistributedECG solves (nel 8, heterogeneous, RAC-scaled before the build,
t 2, tol 1e-6, f32 here as on the card; ``[sharded_dryrun]``). The k-way
and block-arrow partitions run the JAX package's Python algorithm
(``PREALPS_TPU_NO_NATIVE=1``) unless ``--native`` asks for its native
library, both packages' default, whose counts chip_smoke.py holds.

``--path sharded_formats`` runs the four small f64 paths of
chip_smoke.py's ``[sharded_formats]`` (``chip_smoke.SHARDED_FORMATS``:
the stencil on ``nt``, block-ELL, ``fmt="auto"`` on the shuffled band and
DIA on ``nt``, each at its own nshards) and prints one JSON line each.

The distributed LORASC phases (``[dlorasc_large]``, ``[dlorasc_dryrun]``)
take theirs from the JAX ``DistributedLorascECG`` over ``--nshards`` groups
or a ``--mesh G,L``:

    JAX_PLATFORMS=cpu python -m tests.test_torch_anchors --path dlorasc_large --nshards 8 --native
    JAX_PLATFORMS=cpu python -m tests.test_torch_anchors --path dry_lorasc_2level --mesh 4,2 --native

``dlorasc_large`` is ``examples/demo_large_separator.py``'s configuration
(heterogeneous elasticity3d 32³, f64, t 4 odir_fused, tol 1e-5); the
``dry_lorasc*`` paths are dryrun_multichip's three LORASC builds.

The single-device API phases (``[api_bj]``, ``[api_lorasc]``,
``[api_presc]``, ``[api_presc_banded]``: ``chip_smoke.API_CASES``) take
theirs from the JAX ``ECGSolver`` with its default (native) partition:

    JAX_PLATFORMS=cpu python -m tests.test_torch_anchors --path api_lorasc --dtype f64
"""

import argparse
import json
import os
import time

import numpy as np
import pytest
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
# dryrun_multichip's DistributedLorascECG builds (t 2, tol 1e-6, maxiter
# 6000, dtype the problem's; "lorasc_2level" on a (G, 2) mesh)
DRYRUN_LORASC = {
    "dry_lorasc": (dict(), "odir_fused"),
    "dry_lorasc_2level": (dict(max_deflation=16), "odir_fused"),
    "dry_lorasc_deflation": (dict(exact_schur=False, correction="deflate",
                                  max_deflation=64), "omin"),
}
LARGE_NEL = 32
SHARDED = ("sharded4", "sharded_general4", "sharded_dia4")
API = ("api_bj", "api_lorasc", "api_presc", "api_presc_banded")
PATHS = ("dia", "cheb", "dedup", "bj2l_nogrid", *SHARDED, "sharded_formats", *DRYRUN,
         "dlorasc_large", *DRYRUN_LORASC, *API, "lorasc_f64")


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


def sharded_config(path: str, nel: int):
    """(build keywords, ECGOptions fields) of a full-size sharded phase:
    the headline (``sharded4``), the general path with the JAX driver's
    plain block-ELL (``sharded_general4``) or DIA on ``tbn``
    (``sharded_dia4``)."""
    if path == "sharded4":
        return (dict(fmt="stencil", br=3, precond="bj2l", block_size=240,
                     grid=(nel + 1, nel + 1, nel), dtype=np.float32), DIA_OPTS)
    if path == "sharded_general4":
        return (dict(fmt="block_ell_xla", precond="bj", block_size=240,
                     dtype=np.float32), dict(DIA_OPTS, layout="nt"))
    if path == "sharded_dia4":
        return dict(DIA_CONFIG), DIA_OPTS
    raise ValueError(f"unknown path {path!r}")


def set_partitioner(native: bool) -> str:
    """The JAX package's k-way and block-arrow partitioner for an anchor:
    its native library (its default, and the port's) or its Python
    algorithm (``PREALPS_TPU_NO_NATIVE=1``). Returns its name."""
    if native:
        os.environ.pop("PREALPS_TPU_NO_NATIVE", None)
        return "native"
    os.environ["PREALPS_TPU_NO_NATIVE"] = "1"
    return "python"


def jax_sharded_anchor(path: str, nel: int, nshards: int, dtype=np.float32,
                       native: bool = False) -> dict:
    """The JAX driver's solve of a sharded chip_smoke phase over
    ``nshards`` CPU devices: a full-size one (``sharded_config``) or a
    dryrun path."""
    from prealps_tpu.core.scaling import sym_rac_scaling

    partitioner = set_partitioner(native)
    if path in SHARDED:
        a, b = _problem(nel)
        kw, opts = sharded_config(path, nel)
    else:
        a, b = dryrun_problem(elasticity3d, sym_rac_scaling, dtype=dtype)
        kw, opts = dryrun_build(path, dtype)
    t0 = time.perf_counter()
    s = JaxECG.build(a, nshards=nshards, opts=JaxOptions(**opts), **kw)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    return {"path": path, "nel": nel if path in SHARDED else DRYRUN_NEL,
            "nshards": nshards, "dtype": np.dtype(kw["dtype"]).name,
            "partitioner": partitioner,
            "n": a.shape[0], "n_pad": s.layout.n_pad,
            "iters": int(info["iters"]),
            "refine_rounds": int(info.get("refine_rounds", 0)),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "breakdown": bool(info["breakdown"]), "build_s": build_s,
            "solve_s": time.perf_counter() - t0}


def jax_formats_anchors(native: bool = False) -> list:
    """The JAX driver's solve of each [sharded_formats] path at its own
    nshards (``chip_smoke.SHARDED_FORMATS``)."""
    import chip_smoke

    partitioner = set_partitioner(native)
    out = []
    for name, (nshards, problem, kw, opts) in chip_smoke.SHARDED_FORMATS.items():
        a, b = chip_smoke.sharded_formats_problem(problem, elasticity3d)
        s = JaxECG.build(a, nshards=nshards, opts=JaxOptions(**opts),
                         dtype=np.float64, **kw)
        x, info = s.solve(b)
        out.append({"path": name, "nshards": nshards, "partitioner": partitioner,
                    "n": a.shape[0],
                    "n_pad": s.layout.n_pad, "iters": int(info["iters"]),
                    "chosen": (s.fmt_info or {}).get("chosen"),
                    "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
                    "breakdown": bool(info["breakdown"])})
    return out


def lorasc_case(path: str, mesh: tuple, dtype=np.float32):
    """(problem (a, b), build keywords with ``opts`` a dict of ECGOptions
    fields) of a distributed LORASC path over ``mesh`` = (G, L): L == 1 is
    ``nshards=G``, else ``mesh_shape=(G, L)``."""
    from prealps_tpu.core.scaling import sym_rac_scaling

    g_n, l_n = mesh
    where = dict(nshards=g_n) if l_n == 1 else dict(mesh_shape=(g_n, l_n))
    if path == "dlorasc_large":
        a = elasticity3d(LARGE_NEL, LARGE_NEL, LARGE_NEL)
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        return (a, b), dict(where, dtype=np.float64, opts=dict(
            t=4, tol=1e-5, maxiter=2000, variant="odir_fused"))
    kw, variant = DRYRUN_LORASC[path]
    a, b = dryrun_problem(elasticity3d, sym_rac_scaling, dtype=dtype)
    return (a, b), dict(kw, **where, dtype=dtype, opts=dict(
        t=2, tol=1e-6, maxiter=6000, variant=variant))


def jax_lorasc_anchor(path: str, mesh: tuple, dtype=np.float32,
                      native: bool = False) -> dict:
    """The JAX DistributedLorascECG's build and solve of a distributed
    LORASC path over ``mesh`` CPU devices."""
    from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG as JaxLorasc

    partitioner = set_partitioner(native)
    (a, b), kw = lorasc_case(path, mesh, dtype)
    opts = JaxOptions(**kw.pop("opts"))
    t0 = time.perf_counter()
    s = JaxLorasc.build(a, opts=opts, **kw)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    return {"path": path, "mesh": list(mesh), "dtype": np.dtype(kw["dtype"]).name,
            "partitioner": partitioner,
            "n": a.shape[0], "ng_max": int(s.ng_max),
            "sep_padded_rows": int(s.ng_max * s.ngroups),
            "deflated": int(s.deflated), "iters": int(info["iters"]),
            "refine_rounds": int(info.get("refine_rounds", 0)),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "breakdown": bool(info["breakdown"]), "build_s": build_s,
            "solve_s": time.perf_counter() - t0}


def jax_api_anchor(path: str, dtype=np.float32) -> dict:
    """The JAX ``ECGSolver``'s build and solve of a chip_smoke [api_*]
    phase (``chip_smoke.API_CASES``; the native partitioner, the JAX
    default), with the pairs its LORASC / PRESC build deflates."""
    import chip_smoke
    from prealps_tpu.api import ECGSolver as JaxSolver
    from prealps_tpu.core.scaling import sym_rac_scaling

    set_partitioner(True)
    problem, precond, kw, opts = chip_smoke.API_CASES[path]
    a, b = chip_smoke.api_problem(path, elasticity3d)
    t0 = time.perf_counter()
    s = JaxSolver.build(a, opts=JaxOptions(**opts), precond=precond, dtype=dtype, **kw)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    out = {"path": path, "problem": problem, "dtype": np.dtype(dtype).name,
           "n": a.shape[0], "iters": int(info["iters"]),
           "refine_rounds": int(info.get("refine_rounds", 0)),
           "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
           "breakdown": bool(info["breakdown"]), "build_s": build_s,
           "solve_s": time.perf_counter() - t0}
    if precond in ("lorasc", "presc"):
        from prealps_tpu.precond.lorasc import build_lorasc
        from prealps_tpu.precond.presc import build_presc

        build = build_lorasc if precond == "lorasc" else build_presc
        m, _ = build(sym_rac_scaling(a)[0], dtype=dtype, **kw)
        out["deflated"] = int(np.count_nonzero(np.asarray(m.sigma)))
    return out


def jax_lorasc_f64_anchor(nel: int, max_deflation: int) -> dict:
    """The JAX ``StencilLorascECG``'s f64 build and solve at the f64
    deflation study's configuration (``prealps_tpu_torch/examples/
    deflation_study_f64.py``: het elasticity3d(nel³), 8 box parts, t 12
    odir_fused to 1e-5): chip_smoke's ``[lorasc_f64]`` at max_deflation
    256."""
    from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG as JaxStencilLorasc
    from prealps_tpu_torch.examples import deflation_study_f64 as study

    a, b = study.problem(nel)
    t0 = time.perf_counter()
    s = JaxStencilLorasc.build(a, opts=JaxOptions(**study.OPTS),
                               **study.build_kwargs(nel, max_deflation))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = s.solve(b)
    return {"path": "lorasc_f64", "nel": nel, "n": a.shape[0],
            "max_deflation": max_deflation, "deflated": int(info["deflated"]),
            "iters": int(info["iters"]),
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


@pytest.mark.parametrize("path", ["sharded_general4", "sharded_dia4"])
def test_sharded_anchor_cases_are_chip_smokes(path):
    """chip_smoke's full-width sharded phases build what their anchors
    build: [general]'s and [dia]'s configurations (t 12 odir_fused to 1e-5,
    f32), block-ELL as the JAX driver's plain ``block_ell_xla``."""
    import chip_smoke

    kw, layout, _ = chip_smoke.SHARDED_FULL[path]
    jkw, opts = sharded_config(path, 36)
    assert opts == dict(t=12, tol=chip_smoke.SOLVE_TOL, maxiter=3000,
                        variant="odir_fused", layout=layout)
    fmt = "block_ell_xla" if kw["fmt"] == "block_ell" else kw["fmt"]
    assert dict(kw, fmt=fmt, dtype=np.float32) == jkw


def test_sharded_formats_problems_are_the_jax_tests():
    """[sharded_formats]' problems are the JAX tests' (the band of
    tests/test_spmm.py:541-560 under the rng fixture's permutation) and the
    port's generator gives them bitwise."""
    import chip_smoke
    from prealps_tpu_torch.core.generators import elasticity3d as t_elasticity3d

    for name in ("ela", "ela_b5", "band"):
        a_j, b_j = chip_smoke.sharded_formats_problem(name, elasticity3d)
        a_t, b_t = chip_smoke.sharded_formats_problem(name, t_elasticity3d)
        assert (a_j != a_t).nnz == 0
        np.testing.assert_array_equal(b_j, b_t)
    a, b = chip_smoke.sharded_formats_problem("band", elasticity3d)
    rng = np.random.default_rng(42)
    pm = rng.permutation(2400)
    assert a.shape == (2400, 2400) and a.nnz == 5 * 2400 - 8
    assert a[np.argsort(pm)][:, np.argsort(pm)].diagonal(3).sum() == 2397
    np.testing.assert_array_equal(b, rng.standard_normal(2400))


@pytest.mark.parametrize("path,mesh", [("dry_lorasc", (8, 1)),
                                       ("dry_lorasc_2level", (4, 2)),
                                       ("dry_lorasc_deflation", (8, 1))])
def test_lorasc_anchor_cases_are_the_dryrun_builds(path, mesh):
    """The distributed LORASC anchors' cases: ``__graft_entry__``'s nel-8
    problem in f32, t 2 to 1e-6, omin on the deflation path, the mesh as
    ``nshards`` or ``mesh_shape``, and the port's dry-run builds
    (``prealps_tpu_torch/dryrun.py``, which chip_smoke's [dlorasc_dryrun]
    runs) the same, on the same problem."""
    from __graft_entry__ import _problem as graft_problem
    from prealps_tpu_torch import dryrun

    (a, b), kw = lorasc_case(path, mesh)
    a_j, b_j = graft_problem(nel=DRYRUN_NEL, dtype=np.float32)
    assert (a != a_j).nnz == 0
    np.testing.assert_array_equal(b, b_j)
    opts = kw.pop("opts")
    assert opts == dict(t=2, tol=1e-6, maxiter=6000,
                        variant="omin" if path == "dry_lorasc_deflation" else "odir_fused")
    assert kw.pop("dtype") == np.float32
    smoke_kw, variant = dryrun.lorasc_build_args(path, mesh[0] * mesh[1])
    assert kw == smoke_kw and variant == opts["variant"]
    a_t, b_t = dryrun.problem(np.float32)
    assert (a_t != a_j).nnz == 0
    np.testing.assert_array_equal(b_t, b_j)


if __name__ == "__main__":
    import jax

    ap = argparse.ArgumentParser(
        description="JAX CPU anchor of a chip_smoke phase")
    ap.add_argument("--path", choices=PATHS, default="dia")
    ap.add_argument("--nel", type=int, default=36)
    ap.add_argument("--block-size", type=int, default=240)
    ap.add_argument("--nshards", type=int, default=1,
                    help="CPU devices of the sharded paths (sharded*, dry_*)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32",
                    help="the dry_* paths' type (the card runs f32 on the stencil)")
    ap.add_argument("--mesh", default=None,
                    help="G,L: the distributed LORASC paths' (groups, local) mesh")
    ap.add_argument("--max-deflation", type=int, default=256,
                    help="the lorasc_f64 path's max_deflation")
    ap.add_argument("--native", action="store_true",
                    help="partition with the JAX package's native library (its "
                         "default and the port's) instead of its Python algorithm")
    args = ap.parse_args()
    mesh = (tuple(int(v) for v in args.mesh.split(",")) if args.mesh
            else (args.nshards, 1))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", max(8, mesh[0] * mesh[1]))
    jax.config.update("jax_enable_x64", True)
    dtype = np.float32 if args.dtype == "f32" else np.float64
    if args.path == "dlorasc_large" or args.path in DRYRUN_LORASC:
        print(json.dumps(jax_lorasc_anchor(args.path, mesh, dtype, args.native)))
    elif args.path == "sharded_formats":
        for rec in jax_formats_anchors(args.native):
            print(json.dumps(rec))
    elif args.path in SHARDED or args.path in DRYRUN:
        print(json.dumps(jax_sharded_anchor(args.path, args.nel, args.nshards, dtype,
                                            args.native)))
    elif args.path in API:
        print(json.dumps(jax_api_anchor(args.path, dtype)))
    elif args.path == "lorasc_f64":
        print(json.dumps(jax_lorasc_f64_anchor(args.nel, args.max_deflation)))
    else:
        print(json.dumps(jax_anchor(args.path, args.nel, args.block_size)))


def test_api_cases_are_the_cli_defaults():
    """chip_smoke's [api_lorasc] / [api_presc] cases are the reference's
    elasticity3d_12x10x10 at the CLI's defaults, in both packages' CLIs."""
    import chip_smoke
    from prealps_tpu import cli as jcli
    from prealps_tpu_torch import cli as tcli

    for cli in (jcli, tcli):
        args = cli._common_parser("").parse_args([])
        assert args.size == "12x10x10" and args.generate == "ela"
        assert dict(t=args.t, tol=args.tol, maxiter=args.maxiter,
                    variant=args.ortho_alg) == chip_smoke.API_CLI_OPTS
    assert set(API) == set(chip_smoke.API_CASES) == set(chip_smoke.API_ANCHORS)
    for path in ("api_lorasc", "api_presc", "api_presc_banded"):
        problem, precond, kw, opts = chip_smoke.API_CASES[path]
        assert problem == dict(nx=12, ny=10, nz=10) and opts is chip_smoke.API_CLI_OPTS
        assert kw["nparts"] == 8 and kw["deflation_tol"] == 1e-2
    # [api_bj] runs [general]'s matrix, the homogeneous 36³ operator
    a, b = chip_smoke.api_problem("api_bj", elasticity3d)
    a_g = elasticity3d(36, 36, 36, heterogeneous=False)
    assert (a != a_g).nnz == 0
    np.testing.assert_array_equal(b, np.random.default_rng(0).standard_normal(a.shape[0]))
