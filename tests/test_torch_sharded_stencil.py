"""The sharded stencil path (lane-major panels) at 2 gloo ranks on the CPU
against the JAX driver's ``build(nshards=2)`` on the conftest's CPU
devices, in f64: elasticity3d(8,8,8), ECG t = 4 odir_fused to 1e-8, with
bj2l (grid= rigid-body modes, 24-row blocks), ``precond="bj"`` (flat
blocks: the dedup is one-shard only, in both packages), Chebyshev and
none. Iterations ±1, x within 1e-8 relative, the same preconditioner kind
and padded size, every rank the same x. One spawn runs every case.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from sharded_cases import assert_parity, jax_solve, same_on_every_rank, spawn_jobs

torch.set_num_threads(1)

TOL = 1e-8
OPTS = dict(t=4, tol=TOL, maxiter=3000, variant="odir_fused", layout="tbn")
BASE = dict(fmt="stencil", br=3, dtype=np.float64, opts=OPTS)
CASES = {
    "bj2l": dict(BASE, precond="bj2l", block_size=24, grid=(9, 9, 8)),
    "bj": dict(BASE, precond="bj", block_size=24, grid=(9, 9, 8)),
    "chebyshev": dict(BASE, precond="chebyshev"),
    "none": dict(BASE, precond="none"),
}
KINDS = {"bj2l": "bj2l", "bj": "bj_flat", "chebyshev": "chebyshev", "none": None}


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(8, 8, 8, heterogeneous=False)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


@pytest.fixture(scope="module")
def port(problem, tmp_path_factory):
    a, b = problem
    return spawn_jobs(2, [("solves", (a, b, CASES))], tmp_path_factory)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_stencil_matches_jax(problem, port, name):
    a, b = problem
    x, info, kind, n_pad, (halo, nrb_loc) = same_on_every_rank(port, name)
    sj, x_j, info_j = jax_solve(a, b, 2, CASES[name])
    assert kind == KINDS[name]
    assert n_pad == sj.layout.n_pad and nrb_loc == n_pad // 3 // 2
    assert halo <= nrb_loc           # the ring exchange, not the gather
    assert_parity(a, b, (x, info), (sj, x_j, info_j), TOL)
