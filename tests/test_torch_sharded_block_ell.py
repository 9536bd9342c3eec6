"""The sharded block-ELL path: the block halo plan on the host, and
``fmt="block_ell"`` at 2 gloo ranks on the CPU, where the wrapper of the
block-ELL kernel (B5) runs its plain version on the shard's
[own ∥ halo] block space.

* ``build_block_halo_plan`` bitwise JAX's
  (``prealps_tpu/core/layout.py:267-347``) on the k-way layout of het
  elasticity3d(6,5,5) at 2 and 4 shards (``PREALPS_TPU_NO_NATIVE=1``: the
  JAX package's Python partition, the one the port copies), and its
  refusal of a shard that is not whole 128-row blocks.
* ``fmt="block_ell"`` over 2 ranks, f64, t 4 odir_fused to 1e-8, host
  block Jacobi or Chebyshev, against JAX's ``block_ell_xla`` at
  ``nshards=2``: JAX's Pallas block-ELL sums in f32 whatever its input
  type (ROADMAP.md queue C, note 1). Iterations ±1, x within 1e-8
  relative, every rank the same x.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import build_block_halo_plan as jax_plan
from prealps_tpu.core.layout import build_row_layout as jax_layout
from prealps_tpu.core.layout import permute_and_pad_matrix as jax_pad
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops.formats import csr_to_block_ell as jax_block_ell
from prealps_tpu_torch.core.layout import (
    build_block_halo_plan,
    build_row_layout,
    contiguous_row_layout,
    permute_and_pad_matrix,
)
from prealps_tpu_torch.ops.formats import csr_to_block_ell
from sharded_cases import assert_parity, jax_solve, same_on_every_rank, spawn_jobs

torch.set_num_threads(1)

WORLD = 2
OPTS = dict(t=4, tol=1e-8, maxiter=2000, variant="odir_fused", layout="nt")
CASES = {
    "bj": dict(fmt="block_ell", precond="bj", dtype=np.float64, opts=OPTS),
    "chebyshev": dict(fmt="block_ell", precond="chebyshev", dtype=np.float64,
                      opts=OPTS),
}


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(6, 5, 5)
    return a, np.random.default_rng(42).standard_normal(a.shape[0])


@pytest.fixture(scope="module", autouse=True)
def python_partitioner():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        yield


@pytest.mark.parametrize("nshards", [2, 4])
def test_block_halo_plan_bitwise_jax(problem, nshards):
    a, _ = sym_rac_scaling(problem[0])
    lay = build_row_layout(a, nshards, row_multiple=128)
    lay_j = jax_layout(a, nshards, row_multiple=128)
    np.testing.assert_array_equal(lay.perm, lay_j.perm)
    bell = csr_to_block_ell(permute_and_pad_matrix(a, lay), bm=8, bk=128)
    bell_j = jax_block_ell(jax_pad(a, lay_j), bm=8, bk=128)
    plan = build_block_halo_plan(lay, bell.blkcols.numpy(), bell.blocks.numpy(), 128)
    plan_j = jax_plan(lay_j, np.asarray(bell_j.blkcols), np.asarray(bell_j.blocks), 128)
    assert (plan.hb, plan.comm_blocks) == (plan_j.hb, plan_j.comm_blocks)
    assert plan.comm_blocks > 0
    for name in ("send_idx", "blkcols_local"):
        got, want = getattr(plan, name), np.asarray(getattr(plan_j, name))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_block_halo_plan_refuses_split_blocks(problem):
    a = problem[0]
    lay = contiguous_row_layout(a.shape[0], 2, row_multiple=8)
    assert lay.rows_per_shard % 128
    bell = csr_to_block_ell(permute_and_pad_matrix(a, lay), bm=8, bk=8)
    with pytest.raises(ValueError, match="not a multiple of bk=128"):
        build_block_halo_plan(lay, bell.blkcols.numpy(), bell.blocks.numpy(), 128)


@pytest.fixture(scope="module")
def port(problem, tmp_path_factory):
    a, b = problem
    return spawn_jobs(WORLD, [("format_solves", (a, b, CASES))], tmp_path_factory)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_block_ell_kernel_route_matches_jax_xla(problem, port, name):
    a, b = problem
    x, info, facts = same_on_every_rank(port, name)
    sj, x_j, info_j = jax_solve(a, b, WORLD, dict(CASES[name], fmt="block_ell_xla"))
    mpl = sj.layout.rows_per_shard
    assert facts["operands"] == "BlockEllOperands" and facts["kind"] == name
    assert facts["ext_cols"] == mpl + WORLD * sj._halo_plan.hb * 128
    # relres within 10 × tol: the solve stops on the split residual's norm
    assert_parity(a, b, (x, info), (sj, x_j, info_j), 1e-7)
