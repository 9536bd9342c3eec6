"""Chebyshev (polynomial) preconditioner.

Counterpart of ``prealps_tpu/precond/chebyshev.py``: M⁻¹ ≈ p_d(D⁻¹A) D⁻¹,
with p_d the degree-d Chebyshev polynomial that minimises the residual on
[λ_min, λ_max] of the Jacobi-scaled operator (three-term recurrence).
λ_max comes from a power iteration (``power_lam_max_host`` on the host
matrix, as the driver does, or ``estimate_lam_max`` through the operator),
λ_min = λ_max / κ. An apply costs d − 1 operator products and no stored
factors; the products are the operator's own ``a_apply``, so on the
stencil path every one of them is a B1 launch on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch


def cheby_recurrence(op, b: torch.Tensor, degree: int, lam_min: float,
                     lam_max: float) -> torch.Tensor:
    """x ≈ op⁻¹ b by ``degree`` steps of the Chebyshev iteration on the
    spectrum [lam_min, lam_max] of ``op``: degree − 1 operator applications
    after the first step. Layout-blind: any panel shape op and b agree on."""
    theta = (lam_max + lam_min) / 2.0
    delta = (lam_max - lam_min) / 2.0
    sigma1 = theta / delta
    dvec = b / theta
    x = dvec
    if degree <= 1:
        return x
    res = b - op(x)
    rho_prev = 1.0 / sigma1
    for _ in range(degree - 2):
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        dvec = rho * rho_prev * dvec + (2.0 * rho / delta) * res
        x = x + dvec
        res = res - op(dvec)
        rho_prev = rho
    # the last step needs no residual update
    rho = 1.0 / (2.0 * sigma1 - rho_prev)
    dvec = rho * rho_prev * dvec + (2.0 * rho / delta) * res
    return x + dvec


def power_lam_max_host(a, iters: int = 30) -> float:
    """λ_max(D⁻¹A) by a host power iteration (scipy, build time)."""
    a = sp.csr_matrix(a)
    d_inv = 1.0 / a.diagonal()
    v = np.ones(a.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = d_inv * (a @ v)
        lam = np.linalg.norm(w)
        v = w / lam
    return float(lam)


@dataclass
class Chebyshev:
    """The preconditioner over an operator callback.

    inv_diag is D⁻¹ in the operator's vector space: (m,) for row-major
    (m, t) panels, or (br, nrb) for lane-major (t, br, nrb) panels
    (``lane_major``)."""

    inv_diag: torch.Tensor
    lam_min: float
    lam_max: float
    degree: int
    a_apply: Callable
    lane_major: bool = False

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """Approximate A⁻¹ r: the Chebyshev iteration on D⁻¹A (``degree``
        steps, degree − 1 operator products)."""
        d_inv = self.inv_diag[None] if self.lane_major else self.inv_diag[:, None]
        op = lambda v: d_inv * self.a_apply(v)
        return cheby_recurrence(op, d_inv * r, self.degree, self.lam_min,
                                self.lam_max)


def estimate_lam_max(a_apply, inv_diag: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """λ_max(D⁻¹A) by a power iteration through the operator on an (m, 1)
    row-major panel, from the normalised ones vector; returns a 0-d tensor."""
    v = torch.ones((inv_diag.shape[0], 1), dtype=inv_diag.dtype,
                   device=inv_diag.device)
    v = v / torch.linalg.norm(v)
    lam = torch.ones((), dtype=inv_diag.dtype, device=inv_diag.device)
    for _ in range(iters):
        w = inv_diag[:, None] * a_apply(v)
        lam = torch.linalg.norm(w)
        v = w / lam
    return lam


def build_chebyshev(a_apply, diag, degree: int = 8, kappa_bound: float = 30.0,
                    lam_max=None, lane_major: bool = False) -> Chebyshev:
    """diag: D in the operator's vector space (a tensor; see ``Chebyshev``).
    λ_max is ``lam_max`` (or ``estimate_lam_max``, row-major only) times
    1.05, and λ_min = λ_max / kappa_bound."""
    inv_diag = 1.0 / diag
    if lam_max is None:
        if lane_major:
            raise ValueError("estimate_lam_max runs on row-major panels: pass "
                             "lam_max (power_lam_max_host) for lane-major ones")
        lam_max = estimate_lam_max(a_apply, inv_diag)
    lam_max = float(lam_max) * 1.05
    return Chebyshev(inv_diag=inv_diag, lam_min=lam_max / kappa_bound,
                     lam_max=lam_max, degree=degree, a_apply=a_apply,
                     lane_major=lane_major)
