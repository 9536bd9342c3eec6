"""The sharded DIA format and the stencil on row-major panels at 8 gloo
ranks on the CPU against the JAX driver's ``build(nshards=8)`` on the
conftest's CPU devices, in f64, at the JAX tests' configurations:

* DIA on ``nt`` (tests/test_distributed.py:440-480): het elasticity3d
  (6,5,5) with host block Jacobi, t 4 to 1e-8, where the diagonals' halo
  exceeds a shard's rows (the periodic window of the gathered panel);
  and a band (offsets ±1, ±16) plus symmetric noise, unscaled, t 2 to
  1e-10 without a preconditioner (the ring halo). The remainder moves
  through its halo plan's all-to-all.
* the stencil on ``nt`` for Poisson 8³ at br 1, unscaled, t 2 to 1e-6
  (tests/test_distributed.py:116-124).

Iterations ±1, x within 1e-8 relative, every rank the same x. The k-way
layouts partition with the JAX package's Python algorithm
(``PREALPS_TPU_NO_NATIVE=1``). One spawn runs every case.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from prealps_tpu.core.generators import elasticity3d, poisson3d
from sharded_cases import assert_parity, jax_solve, same_on_every_rank, spawn_jobs

torch.set_num_threads(1)

WORLD = 8
DIA_ELA = dict(fmt="dia", precond="block_jacobi", dtype=np.float64,
               opts=dict(t=4, tol=1e-8, maxiter=2000))
DIA_NOISE = dict(fmt="dia", precond="none", dtype=np.float64, scale=False,
                 opts=dict(t=2, tol=1e-10, maxiter=3000))
POISSON = dict(fmt="stencil", br=1, scale=False, dtype=np.float64,
               opts=dict(t=2, tol=1e-6, maxiter=500))


def banded_plus_noise(n=1024):
    """tests/test_distributed.py:458-480's matrix and rhs."""
    diags = [np.full(n - abs(k), v) for k, v in
             ((-16, -1.0), (-1, -2.0), (0, 8.0), (1, -2.0), (16, -1.0))]
    a = sp.diags(diags, offsets=[-16, -1, 0, 1, 16], format="csr")
    noise = sp.random(n, n, density=0.001, random_state=3)
    a = sp.csr_matrix(a + 0.05 * (noise + noise.T) + 2 * sp.eye(n))
    return a, np.random.default_rng(42).standard_normal(n)


@pytest.fixture(scope="module")
def problems():
    a = elasticity3d(6, 5, 5)
    p = poisson3d(8, 8, 8)
    return {"dia_ela": (a, np.random.default_rng(5).standard_normal(a.shape[0])),
            "dia_noise": banded_plus_noise(),
            "poisson": (p, np.random.default_rng(42).standard_normal(p.shape[0]))}


CASES = {"dia_ela": DIA_ELA, "dia_noise": DIA_NOISE, "poisson": POISSON}


@pytest.fixture(scope="module", autouse=True)
def python_partitioner():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        yield


@pytest.fixture(scope="module")
def port(problems, tmp_path_factory):
    jobs = [("format_solves", (*problems[name], {name: CASES[name]}))
            for name in CASES]
    ranks = spawn_jobs(WORLD, jobs, tmp_path_factory, timeout=180)
    return [[{k: v for job in r for k, v in job.items()}] for r in ranks]


@pytest.mark.parametrize("name,window", [("dia_ela", "gather"),
                                         ("dia_noise", "ring")])
def test_sharded_dia_nt_matches_jax(problems, port, name, window):
    a, b = problems[name]
    x, info, facts = same_on_every_rank(port, name)
    sj, x_j, info_j = jax_solve(a, b, WORLD, CASES[name])
    mpl = sj.layout.rows_per_shard
    halo = max(abs(o) for o in facts["offsets"])
    assert facts["operands"] == "DiaOperands" and facts["layout"] == "nt"
    assert facts["n_pad"] == sj.layout.n_pad
    assert (halo > mpl) == (window == "gather")
    assert facts["rem_ext_cols"] == mpl + WORLD * sj._halo_plan.h
    # relres within 10 × tol: the solve stops on the split residual's norm
    assert_parity(a, b, (x, info), (sj, x_j, info_j), 10 * CASES[name]["opts"]["tol"])


def test_sharded_stencil_nt_poisson_br1_matches_jax(problems, port):
    a, b = problems["poisson"]
    x, info, facts = same_on_every_rank(port, "poisson")
    sj, x_j, info_j = jax_solve(a, b, WORLD, POISSON)
    assert facts["operands"] == "StencilNtOperands" and facts["n_pad"] == sj.layout.n_pad
    assert_parity(a, b, (x, info), (sj, x_j, info_j), 2e-5)
