"""A-CholQR and CholQR block orthonormalisation.

Counterpart of ``prealps_tpu/ops/cholqr.py`` (reference: utils/cholqr.c —
CPLM_MatDenseACholQR / CPLM_MatDenseANormalize / CPLM_MatDenseCholQR). One
fused step: a tall-skinny Gram, its cross-shard sum (``group``: a
``torch.distributed`` group, None for one shard), a small Cholesky and
triangular solves. Panels follow ``solvers/panels.py``'s layouts, ``nt``
(m, t) or ``tbn`` (t, *space).

JAX's ``cholesky(c, symmetrize_input=True)`` factors (C + Cᵀ)/2: the
Cholesky here symmetrises C the same way before ``torch.linalg.cholesky``.
"""

from __future__ import annotations

import torch

from prealps_tpu_torch.ops.blockops import psum
from prealps_tpu_torch.solvers.panels import LAYOUTS


def _upper_cholesky(c: torch.Tensor) -> torch.Tensor:
    """Upper factor U of the symmetrised C = UᵀU."""
    return torch.linalg.cholesky(0.5 * (c + c.mT)).mT


def a_cholqr(p: torch.Tensor, ap: torch.Tensor, group=None, layout: str = "nt"):
    """A-orthonormalise P (and keep AP consistent): returns (P̃, ÃP, U) with
    P̃ᵀAP̃ = I and U the upper Cholesky factor of PᵀAP."""
    ops = LAYOUTS[layout]
    u = _upper_cholesky(psum(ops.gram(ap, p), group))
    return ops.right_solve(u, p), ops.right_solve(u, ap), u


def cholqr(p: torch.Tensor, group=None, layout: str = "nt"):
    """Plain CholQR: returns (Q, R) with QᵀQ = I (one pass)."""
    ops = LAYOUTS[layout]
    r = _upper_cholesky(psum(ops.gram(p, p), group))
    return ops.right_solve(r, p), r


def cholqr2(p: torch.Tensor, group=None, layout: str = "nt"):
    """CholQR2 (two passes): numerically robust to κ(P) ≈ 1/sqrt(eps)."""
    q1, r1 = cholqr(p, group, layout)
    q2, r2 = cholqr(q1, group, layout)
    return q2, r2 @ r1


def a_normalize(p: torch.Tensor, ap: torch.Tensor, group=None, layout: str = "nt"):
    """Scale each direction to unit A-norm (reference: cholqr.c:35
    CPLM_MatDenseANormalize)."""
    ops = LAYOUTS[layout]
    diag = torch.diagonal(psum(ops.gram(ap, p), group))
    scale = 1.0 / torch.sqrt(torch.clamp(diag, min=torch.finfo(p.dtype).tiny))
    return ops.scale_dirs(p, scale), ops.scale_dirs(ap, scale)
