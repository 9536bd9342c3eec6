"""The sharded row-major formats at 4 gloo ranks on the CPU against the
JAX driver's ``build(nshards=4)`` on the conftest's CPU devices, in f64, at
the JAX tests' configurations (tests/test_distributed.py:79-83, :98-108,
:541-560 and tests/test_spmm.py:541-560):

* block-ELL through its block halo plan (``fmt="block_ell_xla"``, bk 128)
  on het elasticity3d(6,5,5), t 4 to 1e-8, host block Jacobi or none;
* the stencil format on row-major panels (contiguous rows, an all-gather
  of x a product), t 4 to 1e-6, against JAX's stencil and JAX's ELL on the
  same layout;
* ``fmt="auto"`` on a shuffled band (n 2,400), which chooses DIA under
  RCM ("dia_rcm": b permuted in, x out), t 2 to 1e-10.

Iterations ±1, x within 1e-8 relative, every rank the same x. The k-way
layouts partition with the JAX package's Python algorithm
(``PREALPS_TPU_NO_NATIVE=1``), the one the port copies. One spawn runs
every case.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from prealps_tpu.core.generators import elasticity3d
from sharded_cases import assert_parity, jax_solve, relres, same_on_every_rank, spawn_jobs

torch.set_num_threads(1)

WORLD = 4
ELA_OPTS = dict(t=4, tol=1e-8, maxiter=2000, variant="odir_fused", layout="nt")
BELL = dict(fmt="block_ell_xla", precond="bj", dtype=np.float64, opts=ELA_OPTS)
STENCIL_OPTS = dict(t=4, tol=1e-6, maxiter=2000, variant="odir_fused", layout="nt")
ELA_CASES = {
    "block_ell_bj": BELL,
    "block_ell_none": dict(BELL, precond="none"),
    "stencil_nt": dict(fmt="stencil", br=3, precond="bj", dtype=np.float64,
                       opts=STENCIL_OPTS),
}
AUTO = dict(fmt="auto", precond="bj", dtype=np.float64,
            opts=dict(t=2, tol=1e-10, maxiter=400))


def shuffled_band(n=2400, seed=42):
    """tests/test_spmm.py:541-560's matrix: a 5-diagonal band under a
    random symmetric permutation, and its rhs."""
    rng = np.random.default_rng(seed)
    band = sp.diags([np.ones(n - 3), np.ones(n - 1), 5.0 * np.ones(n),
                     np.ones(n - 1), np.ones(n - 3)], [-3, -1, 0, 1, 3]).tocsr()
    pm = rng.permutation(n)
    return sp.csr_matrix(band[pm][:, pm]), rng.standard_normal(n)


@pytest.fixture(scope="module")
def problems():
    a = elasticity3d(6, 5, 5)
    return {"ela": (a, np.random.default_rng(42).standard_normal(a.shape[0])),
            "band": shuffled_band()}


@pytest.fixture(scope="module", autouse=True)
def python_partitioner():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        yield


@pytest.fixture(scope="module")
def port(problems, tmp_path_factory):
    a, b = problems["ela"]
    a_band, b_band = problems["band"]
    ranks = spawn_jobs(WORLD, [("format_solves", (a, b, ELA_CASES)),
                               ("format_solves", (a_band, b_band, {"auto": AUTO}))],
                       tmp_path_factory)
    return [[{**jobs[0], **jobs[1]}] for jobs in ranks]


@pytest.mark.parametrize("name", ["block_ell_bj", "block_ell_none"])
def test_sharded_block_ell_matches_jax(problems, port, name):
    a, b = problems["ela"]
    x, info, facts = same_on_every_rank(port, name)
    sj, x_j, info_j = jax_solve(a, b, WORLD, ELA_CASES[name])
    plan = sj._halo_plan
    mpl = sj.layout.rows_per_shard
    assert facts["operands"] == "BlockEllOperands" and facts["bk"] == 128
    assert facts["n_pad"] == sj.layout.n_pad and mpl % 128 == 0
    assert facts["ext_cols"] == mpl + WORLD * plan.hb * 128
    # relres within 10 × tol: the solve stops on the split residual's norm
    assert_parity(a, b, (x, info), (sj, x_j, info_j), 1e-7)


def test_sharded_stencil_nt_matches_jax_and_ell_on_its_layout(problems, port):
    """tests/test_distributed.py:98-108: the stencil on nt over 4 shards
    takes the iterations of ELL on the same contiguous layout."""
    a, b = problems["ela"]
    x, info, facts = same_on_every_rank(port, "stencil_nt")
    case = ELA_CASES["stencil_nt"]
    sj, x_j, info_j = jax_solve(a, b, WORLD, case)
    _, x_e, info_e = jax_solve(a, b, WORLD, dict(case, fmt="ell"), layout=sj.layout)
    assert facts["operands"] == "StencilNtOperands" and facts["layout"] == "nt"
    assert facts["n_pad"] == sj.layout.n_pad
    # this shard's rows against the gathered global panel
    assert facts["mat_shape"] == (sj.layout.rows_per_shard, sj.layout.n_pad)
    assert info_j["iters"] == info_e["iters"]
    assert abs(info["iters"] - info_e["iters"]) <= 1
    assert np.linalg.norm(x - x_e) <= 1e-8 * np.linalg.norm(x_e)
    assert_parity(a, b, (x, info), (sj, x_j, info_j), 2e-5)


def test_sharded_auto_chooses_dia_rcm_as_jax(problems, port):
    a, b = problems["band"]
    x, info, facts = same_on_every_rank(port, "auto")
    sj, x_j, info_j = jax_solve(a, b, WORLD, AUTO)
    assert facts["chosen"] == sj.fmt_info["chosen"] == "dia_rcm"
    assert facts["operands"] == "DiaOperands" and facts["layout"] == "nt"
    assert facts["rem_ext_cols"] == sj.layout.rows_per_shard + WORLD * sj._halo_plan.h
    assert facts["mat_shape"] == (sj.layout.rows_per_shard,) * 2
    assert_parity(a, b, (x, info), (sj, x_j, info_j), 1e-8)
    assert relres(a, x, b) < 1e-8
