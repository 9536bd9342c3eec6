"""``solver_from_reference`` over several shards: the port's ranks on the
operands of a JAX ``DistributedECG.build(nshards=2)`` (global numpy arrays,
each rank keeping its own shard) give the JAX solve's x, for each format
family of the sharded driver: the stencil on lane-major panels with bj2l,
and ELL with its halo plan and host block Jacobi. f64, elasticity3d(8,8,8),
t = 4 to 1e-8: the same iteration count and x within 1e-8 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops.formats import csr_to_stencil_bsr
from sharded_cases import X_RTOL, jax_solve, relres, spawn_jobs

torch.set_num_threads(1)

TOL = 1e-8
STENCIL = dict(fmt="stencil", br=3, precond="bj2l", block_size=24,
               grid=(9, 9, 8), dtype=np.float64,
               opts=dict(t=4, tol=TOL, maxiter=3000, layout="tbn"))
ELL = dict(fmt="ell", precond="bj", block_size=30, dtype=np.float64,
           opts=dict(t=4, tol=TOL, maxiter=3000, layout="nt"))


def _common(sj):
    lay = sj.layout
    arrays = dict(scale_d=sj.scale_d, perm=lay.perm, inv_perm=lay.inv_perm,
                  layout_offsets=lay.offsets, a_scaled=sj.a_scaled)
    meta = dict(n=lay.n, n_pad=lay.n_pad, rows_per_shard=lay.rows_per_shard,
                nshards=lay.nshards, opts=dataclasses.asdict(sj.opts),
                target_tol=sj.target_tol)
    return arrays, meta


def _stencil_reference(a, sj):
    arrays, meta = _common(sj)
    (blocks_t,), (inv_f, yq3, ac_inv) = sj._operands
    offsets = csr_to_stencil_bsr(
        permute_and_pad_matrix(sym_rac_scaling(a)[0], sj.layout), br=3).offsets
    arrays.update(blocks=np.asarray(blocks_t), inv_f=np.asarray(inv_f),
                  yq3=np.asarray(yq3), ac_inv=np.asarray(ac_inv))
    meta.update(fmt="stencil", stencil_offsets=offsets, br=3)
    return arrays, meta


def _ell_reference(sj):
    arrays, meta = _common(sj)
    (vals, cols_local, send_idx), (factors, gather_idx, inv_perm) = sj._operands
    arrays.update(ell_vals=np.asarray(vals), ell_cols=np.asarray(cols_local),
                  ell_send_idx=np.asarray(send_idx), bj_factors=np.asarray(factors),
                  bj_gather_idx=np.asarray(gather_idx), bj_inv_perm=np.asarray(inv_perm))
    meta.update(fmt="ell", bj_mode="cholesky")
    return arrays, meta


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    a = elasticity3d(8, 8, 8, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        jax_res = {"stencil": jax_solve(a, b, 2, STENCIL),
                   "ell": jax_solve(a, b, 2, ELL)}
    refs = {"stencil": _stencil_reference(a, jax_res["stencil"][0]),
            "ell": _ell_reference(jax_res["ell"][0])}
    port = spawn_jobs(2, [("reference_solves", (b, refs))], tmp_path_factory)
    return a, b, jax_res, port


@pytest.mark.parametrize("family", ["stencil", "ell"])
def test_reference_operands_give_jax_x(both, family):
    a, b, jax_res, port = both
    _, x_j, info_j = jax_res[family]
    x, iters, _ = port[0][0][family]
    for r in port[1:]:
        np.testing.assert_array_equal(r[0][family][0], x)
    assert iters == info_j["iters"]
    assert np.linalg.norm(x - x_j) <= X_RTOL * np.linalg.norm(x_j)
    assert relres(a, x, b) < TOL
