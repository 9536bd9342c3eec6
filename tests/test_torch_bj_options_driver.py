"""The driver's device block-Jacobi options against the JAX driver:

* ``bj_dedupe`` (the default) with ``grid=``: the z-slab blocks of a
  constant-coefficient operator dedupe ("bj_dedup") in both packages, with
  the same groups, equal iteration counts (±1) and x within 1e-8 relative
  in f64; and the solve agrees with the non-deduplicated build (±2
  iterations: its blocks are 48 nodes, not the 49 of a slab);
* a heterogeneous operator, whose slabs do not repeat, falls back to flat
  blocks ("bj_flat") in both, with the same inverses to 1e-12, again to ±1
  and 1e-8. This case solves to 1e-6: at 1e-8 the late residual norms of
  the contrast-1e3 operator depend on the summation order (ROADMAP.md
  queue C, item 3; measured 144 against 147 iterations with x agreeing
  to 2e-10).

``bj_dtype="bf16"`` is in test_torch_bj_lane.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.direct.device_bj import csr_slab_groups
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


def _opts(cls, tol=1e-8):
    return cls(t=4, tol=tol, maxiter=3000, variant="odir_fused", layout="tbn")


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def _both(a, b, tol, **kw):
    kw = dict(dict(fmt="stencil", br=3, dtype=np.float64), **kw)
    sj = JaxECG.build(a, nshards=1, opts=_opts(JaxOptions, tol), **kw)
    s = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions, tol), device="cpu",
                             **kw)
    return sj, sj.solve(b), s, s.solve(b)


@pytest.mark.parametrize("het", [False, True])
def test_dedup_or_fallback_matches_jax(het):
    """Constant coefficients dedupe; the heterogeneous operator falls back
    to flat blocks (the JAX test_irregular_matrix_falls_back)."""
    a = elasticity3d(6, 6, 8, heterogeneous=het)
    b = np.random.default_rng(3 + het).standard_normal(a.shape[0])
    tol = 1e-6 if het else 1e-8
    sj, (x_j, info_j), s, (x, info) = _both(a, b, tol, precond="block_jacobi",
                                              grid=(7, 7, 8))
    ops = s.operands
    assert ops.precond_kind == ("bj_flat" if het else "bj_dedup")
    (bj_j,) = sj._operands[1]
    if het:
        assert ops.inv_f.shape == bj_j.shape == (8, 147, 147)
        np.testing.assert_allclose(ops.inv_f.numpy(), np.asarray(bj_j), rtol=1e-12,
                                   atol=1e-12 * float(jnp.abs(bj_j).max()))
    else:
        # the z-slab (49 nodes) is nearest block_size // br = 341 nodes
        groups = csr_slab_groups(sj.a_scaled if sj.a_scaled is not None else
                                 _padded_scaled(a, sj.layout), 147)[1]
        assert ops.groups.num_groups == len(groups) == bj_j.shape[0] < 8
        order = ops.groups.order.numpy()
        assert [tuple(order[s_:e]) for s_, e in ops.groups.bounds] == list(groups)
        np.testing.assert_allclose(ops.inv_u.numpy(), np.asarray(bj_j), rtol=1e-12,
                                   atol=1e-12 * float(jnp.abs(bj_j).max()))
    assert s.layout.n_pad == sj.layout.n_pad
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    assert _relres(a, x, b) < 10 * tol


def _padded_scaled(a, layout):
    from prealps_tpu.core.layout import permute_and_pad_matrix
    from prealps_tpu.core.scaling import sym_rac_scaling

    return permute_and_pad_matrix(sym_rac_scaling(a)[0], layout)


def test_dedup_solve_matches_non_deduped():
    """tests/test_distributed.py::TestBJDedupe::test_solve_matches_non_deduped
    on the port."""
    a = elasticity3d(6, 6, 8, heterogeneous=False)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    common = dict(nshards=1, opts=_opts(ECGOptions), fmt="stencil", br=3,
                  precond="block_jacobi", dtype=np.float64, device="cpu")
    s_plain = DistributedECG.build(a, block_size=49 * 3, bj_dedupe=False, **common)
    s_dedup = DistributedECG.build(a, grid=(7, 7, 8), **common)
    assert s_plain.operands.precond_kind == "bj_flat"
    assert s_dedup.operands.precond_kind == "bj_dedup"
    x0, i0 = s_plain.solve(b)
    x1, i1 = s_dedup.solve(b)
    assert _relres(a, x1, b) < 1e-7
    assert abs(i0["iters"] - i1["iters"]) <= 2
