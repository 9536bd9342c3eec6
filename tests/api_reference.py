"""The JAX package's single-device builds as numpy fields, for the port's
``interop.ecg_solver_from_reference`` (shared by the test_torch_api*.py
files).

``jax_build`` repeats what the JAX ``ECGSolver.build`` does (RAC scaling,
the preconditioner, the block-arrow permutation, the ELL operator, the f32
refinement options) and keeps the preconditioner object, which the JAX
``ECGSolver`` holds only inside its compiled solve.
"""

from dataclasses import asdict, replace

import numpy as np

from prealps_tpu.core.partition import permute
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops.formats import csr_to_ell
from prealps_tpu.precond.block_jacobi import build_block_jacobi
from prealps_tpu.precond.lorasc import build_lorasc
from prealps_tpu.precond.presc import build_presc


def jax_build(a, opts, precond, dtype=np.float64, **kw):
    """(fields, meta, m_obj) of the JAX build of ``a`` with ``precond``."""
    a_s, d = sym_rac_scaling(a)
    dtype = np.dtype(dtype)
    target_tol = opts.tol
    refine = dtype == np.float32 and opts.tol < 1e-3
    if refine:
        opts = replace(opts, tol=1e-3, stall_window=opts.stall_window or 250)
    perm, m_obj, a_solver = None, None, a_s
    fields, meta = {}, {"precond": precond, "dtype": dtype.name,
                        "target_tol": target_tol, "n": a.shape[0]}
    if precond == "block_jacobi":
        m_obj = build_block_jacobi(a_s, dtype=dtype, **kw)
        fields.update(bj_factors=np.asarray(m_obj.factors),
                      bj_gather_idx=np.asarray(m_obj.gather_idx),
                      bj_inv_perm=np.asarray(m_obj.inv_perm))
        meta["bj_mode"] = m_obj.mode
    elif precond in ("lorasc", "presc"):
        build = build_lorasc if precond == "lorasc" else build_presc
        m_obj, arrow = build(a_s, dtype=dtype, **kw)
        perm = arrow.perm
        a_solver = permute(a_s, perm)
        fields.update(
            aii_factors=np.asarray(m_obj.aii_solver.factors),
            aii_gather_idx=np.asarray(m_obj.aii_solver.gather_idx),
            aii_inv_perm=np.asarray(m_obj.aii_solver.inv_perm),
            agg_factor=np.asarray(m_obj.agg_solver.factor),
            aig_vals=np.asarray(m_obj.aig.vals), aig_cols=np.asarray(m_obj.aig.cols),
            agi_vals=np.asarray(m_obj.agi.vals), agi_cols=np.asarray(m_obj.agi.cols),
            e_mat=np.asarray(m_obj.e_mat), sigma=np.asarray(m_obj.sigma))
        meta.update(ni=m_obj.ni, ng=m_obj.ng)
    ell = csr_to_ell(a_solver, dtype=dtype)
    fields.update(ell_vals=np.asarray(ell.vals), ell_cols=np.asarray(ell.cols),
                  perm=perm, scale_d=d, a_solver=a_solver if refine else None)
    meta["opts"] = asdict(opts)
    return fields, meta, m_obj


def rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())
