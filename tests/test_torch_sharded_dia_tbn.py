"""The sharded DIA format on lane-major panels at 4 gloo ranks on the CPU
against the JAX driver's ``build(nshards=4)`` on the conftest's CPU
devices, in f64, at tests/test_distributed.py:795-806's configuration:
het elasticity3d(8,7,7) on the k-way layout, t 4 odir_fused to 1e-8, the
shard's promoted diagonals as a br = 1 table through B1's plain version on
the ring-extended panel (or the periodic window of the gathered panel
where a shard is thinner than the halo), the remainder through its halo
plan's all-to-all, and the device block Jacobi (120-row blocks) from the
shard's diagonals; also Chebyshev and none.

Iterations ±1, x within 1e-8 relative, the same promoted diagonals and
preconditioner kind, every rank the same x. The k-way layouts partition
with the JAX package's Python algorithm (``PREALPS_TPU_NO_NATIVE=1``).
One spawn runs every case.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from sharded_cases import assert_parity, jax_solve, same_on_every_rank, spawn_jobs

torch.set_num_threads(1)

WORLD = 4
TOL = 1e-8
OPTS = dict(t=4, tol=TOL, maxiter=4000, variant="odir_fused", layout="tbn")
BASE = dict(fmt="dia", dtype=np.float64, opts=OPTS)
CASES = {
    "bj": dict(BASE, precond="block_jacobi", block_size=120),
    "chebyshev": dict(BASE, precond="chebyshev"),
    "none": dict(BASE, precond="none"),
}
KINDS = {"bj": "bj_flat", "chebyshev": "chebyshev", "none": None}


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(8, 7, 7, heterogeneous=True)
    return a, np.random.default_rng(5).standard_normal(a.shape[0])


@pytest.fixture(scope="module", autouse=True)
def python_partitioner():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        yield


@pytest.fixture(scope="module")
def port(problem, tmp_path_factory):
    a, b = problem
    return spawn_jobs(WORLD, [("format_solves", (a, b, CASES))], tmp_path_factory)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_dia_tbn_matches_jax(problem, port, name):
    a, b = problem
    x, info, facts = same_on_every_rank(port, name)
    sj, x_j, info_j = jax_solve(a, b, WORLD, CASES[name])
    assert facts["operands"] == "DiaLaneOperands" and facts["layout"] == "tbn"
    assert facts["kind"] == KINDS[name]
    assert facts["n_pad"] == sj.layout.n_pad
    diags, rem_vals = sj._operands[0][:2]       # (D, 1, 1, n_pad), (n_pad, L)
    assert len(facts["offsets"]) == diags.shape[0]
    assert facts["rem_width"] == rem_vals.shape[1]
    # relres within 10 × tol: the solve stops on the split residual's norm
    assert_parity(a, b, (x, info), (sj, x_j, info_j), 10 * TOL)
