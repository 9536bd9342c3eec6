"""fmt="dia" in both packages on the CPU: the carried-over operands and the
f32 refinement (the f64 solves are in tests/test_torch_dia_driver.py).

* ``solver_from_reference`` on the JAX build's own DIA operands (nt:
  diagonals, remainder and host block Jacobi; tbn: the (D, 1, 1, n)
  table, remainder and device block inverses) reproduces the JAX f64
  residual history to 1e-8 relative, on homogeneous elasticity3d(6³) with
  96-row blocks. (On the heterogeneous elasticity3d(8, 7, 7) the two
  histories part by f64 rounding, amplified ~300× every 10 iterations:
  1e-15 at iteration 20, 1e-8 at 50, percent level beyond 70 of 151 —
  while x still agrees to 2.5e-11.)
* f32 to 1e-6 on the heterogeneous operator, tbn: DIA has no double-float
  product, so the rounds take host f64 residuals (no device round), as in
  the JAX driver; both reach the tolerance on the scaled system (the
  driver's stopping test; the 1e3 contrast puts the unscaled relres a few
  times above it) and the round counts agree within ±1.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import pad_to_padded, permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops.formats import csr_to_dia_ell
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.interop import solver_from_reference
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

BUILD = dict(nshards=1, fmt="dia", precond="block_jacobi", block_size=120)


def _opts(cls, tol, layout):
    return cls(t=4, tol=tol, maxiter=4000, variant="odir_fused", layout=layout)


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def _reference(sj, a, layout):
    """The JAX build's DIA operands and metadata for solver_from_reference."""
    lay = sj.layout
    (diags, rem_vals, rem_cols), bj_ops = sj._operands
    offsets = csr_to_dia_ell(permute_and_pad_matrix(sym_rac_scaling(a)[0], lay),
                             min_fill=0.05).offsets
    arrays = dict(scale_d=sj.scale_d, perm=lay.perm, inv_perm=lay.inv_perm,
                  layout_offsets=lay.offsets, a_scaled=sj.a_scaled,
                  dia_diags=np.asarray(diags), dia_rem_vals=np.asarray(rem_vals),
                  dia_rem_cols=np.asarray(rem_cols))
    meta = dict(fmt="dia", layout=layout, dia_offsets=offsets, n=lay.n,
                n_pad=lay.n_pad, rows_per_shard=lay.rows_per_shard,
                opts=dataclasses.asdict(sj.opts), target_tol=sj.target_tol,
                bj_mode="cholesky")
    if layout == "tbn":
        arrays["inv_f"] = np.asarray(bj_ops[0])
    else:
        arrays.update(zip(("bj_factors", "bj_gather_idx", "bj_inv_perm"),
                          (np.asarray(o) for o in bj_ops)))
    return arrays, meta


@pytest.mark.parametrize("layout", ["nt", "tbn"])
def test_solver_from_reference_reproduces_jax_history(layout):
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    sj = JaxECG.build(a, opts=_opts(JaxOptions, 1e-8, layout), dtype=np.float64,
                      **dict(BUILD, block_size=96))
    x_j, info_j = sj.solve(b)
    s = solver_from_reference(*_reference(sj, a, layout), device="cpu")
    x, info = s.solve(b)
    n = info_j["iters"]
    assert info["iters"] == n
    b_pad = pad_to_padded(sj.layout, sj.scale_d * b)
    if layout == "tbn":
        b_pad = b_pad[None]
    res_j = sj._solve_fn(jnp.asarray(b_pad), *sj._operands)
    hist_j = np.asarray(res_j.history)
    assert hist_j.dtype == np.float64 and int(res_j.iters) == n
    np.testing.assert_allclose(info["history"][:n], hist_j[:n], rtol=1e-8,
                               atol=1e-14 * hist_j[0])
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def test_f32_refines_on_the_host():
    a = elasticity3d(8, 7, 7, heterogeneous=True)
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    tol = 1e-6
    sj = JaxECG.build(a, opts=_opts(JaxOptions, tol, "tbn"), dtype=np.float32,
                      **BUILD)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, opts=_opts(ECGOptions, tol, "tbn"),
                             dtype=np.float32, device="cpu", **BUILD)
    assert not s.operands.df_ok and s.operands.blocks_flat.dtype == torch.float32
    x, info = s.solve(b)
    assert info["relres_scaled"] <= tol and info_j["relres_scaled"] <= tol
    assert _relres(a, x, b) < 10 * tol and _relres(a, x_j, b) < 10 * tol
    assert not info["breakdown"]
    assert info["device_rounds"] == 0 and info["refine_rounds"] >= 2
    assert abs(info["refine_rounds"] - info_j["refine_rounds"]) <= 1
