"""Small dense block operations shared by the solvers (t×t factors).

Counterparts of ``prealps_tpu/ops/blockops.py``. On the card they run on
cuSOLVER/cuBLAS through PyTorch; f32 products are true f32 once
``config.strict_fp32`` has switched TF32 off.
"""

from __future__ import annotations

import torch


def psum(x):
    """Cross-device sum of a local partial result. The identity on one
    device; the multi-GPU driver will make it an all-reduce."""
    return x


def chol_masked(c: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor of C restricted to the active prefix ``mask``.

    Inactive rows/cols are replaced by the identity so the factorization is
    defined and masked columns stay zero through the triangular solves. The
    input is symmetrized first. A failed factorization returns a matrix of
    NaNs (the JAX convention the solver's breakdown test relies on) instead
    of raising: ``cholesky_ex`` reports failure in ``info`` without a host
    synchronisation.
    """
    m2 = mask[:, None] * mask[None, :]
    c_act = c * m2 + torch.diag(1.0 - mask).to(c.dtype)
    c_act = 0.5 * (c_act + c_act.mT)
    low, info = torch.linalg.cholesky_ex(c_act)
    low = torch.where(info == 0, low, torch.full_like(low, float("nan")))
    return low.mT


def tri_inv(u: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a small upper-triangular factor (t×t), so panel
    triangular solves become GEMMs."""
    eye = torch.eye(u.shape[0], dtype=u.dtype, device=u.device)
    return torch.linalg.solve_triangular(u, eye, upper=True)
