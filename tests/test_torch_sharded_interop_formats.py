"""``solver_from_reference`` over several shards for the formats of the
sharded driver's later slice: the port's 2 ranks on the operands of a JAX
``DistributedECG.build(nshards=2)`` (global numpy arrays, each rank keeping
its own shard) for block-ELL through its block halo plan
(``block_ell_xla``), DIA on row-major panels and DIA on lane-major panels
(the remainder's halo plan; host block Jacobi, or on ``tbn`` the device
block inverses). f64, het elasticity3d(6,5,5): the preconditioned product
M·A·v of both packages on the same operands within 1e-12 relative, then
the solve: the same iteration count and x within 1e-8 relative, every
rank the same x.
"""

import dataclasses

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops.formats import csr_to_dia_ell
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from sharded_cases import X_RTOL, jax_driver_applies, jax_solve, spawn_jobs

torch.set_num_threads(1)

WORLD = 2
TOL = 1e-8
NT = dict(t=4, tol=TOL, maxiter=3000, layout="nt")
CASES = {
    "block_ell_xla": dict(fmt="block_ell_xla", precond="bj", dtype=np.float64, opts=NT),
    "dia_nt": dict(fmt="dia", precond="bj", dtype=np.float64, opts=NT),
    "dia_tbn": dict(fmt="dia", precond="bj", block_size=120, dtype=np.float64,
                    opts=dict(NT, layout="tbn")),
}


def _reference(a, name, sj):
    """The JAX build's operands and sizes as ``solver_from_reference`` takes
    them."""
    lay = sj.layout
    arrays = dict(scale_d=sj.scale_d, perm=lay.perm, inv_perm=lay.inv_perm,
                  layout_offsets=lay.offsets, a_scaled=sj.a_scaled)
    meta = dict(n=lay.n, n_pad=lay.n_pad, rows_per_shard=lay.rows_per_shard,
                nshards=lay.nshards, opts=dataclasses.asdict(sj.opts),
                target_tol=sj.target_tol, fmt=CASES[name]["fmt"])
    mat_ops, bj_ops = (tuple(np.asarray(v) for v in ops) for ops in sj._operands)
    if name == "block_ell_xla":
        arrays.update(bell_blocks=mat_ops[0], bell_blkcols=mat_ops[1],
                      bell_send_idx=mat_ops[2])
    else:
        offsets = csr_to_dia_ell(permute_and_pad_matrix(sym_rac_scaling(a)[0], lay),
                                 min_fill=0.05).offsets
        arrays.update(dia_diags=mat_ops[0], dia_rem_vals=mat_ops[1],
                      dia_rem_cols=mat_ops[2], dia_send_idx=mat_ops[3])
        meta.update(dia_offsets=offsets, layout=sj.opts.layout)
    if name == "dia_tbn":
        arrays.update(inv_f=bj_ops[0])
    else:
        arrays.update(bj_factors=bj_ops[0], bj_gather_idx=bj_ops[1],
                      bj_inv_perm=bj_ops[2])
        meta.update(bj_mode="cholesky")
    return arrays, meta


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    a = elasticity3d(6, 5, 5)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])
    vectors = [rng.standard_normal(a.shape[0]) for _ in range(2)]
    jax_res, refs, jax_ys = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        for name, case in CASES.items():
            jax_res[name] = jax_solve(a, b, WORLD, case)
            refs[name] = _reference(a, name, jax_res[name][0])
            # a second build: the first one's solve is traced already
            fresh = JaxECG.build(a, nshards=WORLD, opts=jax_res[name][0].opts,
                                 **{k: v for k, v in case.items() if k != "opts"})
            jax_ys[name] = jax_driver_applies(fresh, vectors)
    port = spawn_jobs(WORLD, [("reference_applies", (refs, b, vectors))],
                      tmp_path_factory)
    return a, b, jax_res, jax_ys, port


@pytest.mark.parametrize("family", sorted(CASES))
def test_reference_operands_give_jax_product_and_x(both, family):
    a, b, jax_res, jax_ys, port = both
    ys, x, iters = port[0][0][family]
    for r in port[1:]:
        np.testing.assert_array_equal(r[0][family][1], x)
    for y, y_j in zip(ys, jax_ys[family]):
        assert np.linalg.norm(y - y_j) <= 1e-12 * np.linalg.norm(y_j)
    _, x_j, info_j = jax_res[family]
    assert iters == info_j["iters"]
    assert np.linalg.norm(x - x_j) <= X_RTOL * np.linalg.norm(x_j)
