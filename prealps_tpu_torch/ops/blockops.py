"""Small dense block operations shared by the solvers (t×t factors and
triangular panel solves).

Counterparts of ``prealps_tpu/ops/blockops.py``. On the card they run on
cuSOLVER/cuBLAS through PyTorch; f32 products are true f32 once
``config.strict_fp32`` has switched TF32 off.
"""

from __future__ import annotations

import torch

from prealps_tpu_torch.parallel.mesh import all_reduce, timing_no_collectives


def psum(x, group=None):
    """Cross-shard sum of a local partial result: an all-reduce over the
    process group (``parallel/mesh.py::all_reduce``, on a contiguous copy),
    and the identity without one (one shard), as JAX's ``psum(x, None)``.
    Also the identity under the timing ablation
    (``mesh.timing_no_collectives``: wrong results by construction)."""
    if group is None or timing_no_collectives():
        return x
    return all_reduce(x, group)


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


def right_tri_solve(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """X U⁻¹ with U upper triangular (columns transform)."""
    return torch.linalg.solve_triangular(u, x, upper=True, left=False)


def left_trit_solve(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """U⁻ᵀ B with U upper triangular."""
    return torch.linalg.solve_triangular(u.mT, b, upper=False)


def pivoted_cholesky(c: torch.Tensor, tol: float, steps: int | None = None):
    """Rank-revealing upper Cholesky with diagonal pivoting (dpstrf analog).

    Returns (U, piv, rank): C[piv][:, piv] ≈ UᵀU with U upper triangular and
    rank = the number of pivots whose residual diagonal exceeded tol (tol < 0
    uses the LAPACK default t·eps·max diag). Step for step the JAX version's
    loop, so it picks the same pivots: the largest remaining diagonal, the
    first one on ties (``argmax``). t steps of small device operations, no
    host synchronisation; rank is a 0-d tensor.

    ``steps`` (default t) stops the loop early: a step never moves an
    earlier pivot, so ``piv[:steps]`` is then exactly the full loop's, and
    U and rank cover those steps only. Column selection
    (``ops/tournament.py::qrcp_select``) needs only its k pivots of a
    candidate Gram that may be thousands wide.
    """
    t = c.shape[0]
    dev = c.device
    idx = torch.arange(t, device=dev)
    tol_t = torch.as_tensor(tol, dtype=c.dtype, device=dev)
    eps = torch.finfo(c.dtype).eps
    tol_t = torch.where(tol_t < 0, t * eps * torch.max(torch.diagonal(c)), tol_t)
    a = c.clone()
    piv = idx.clone()
    rank = torch.zeros((), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=c.dtype, device=dev)
    zero = torch.zeros((), dtype=c.dtype, device=dev)
    for k in range(t if steps is None else min(steps, t)):
        d = torch.diagonal(a)
        j = torch.argmax(torch.where(idx >= k, d, neg_inf))
        # swap rows/cols k <-> j (perm[k] = j, then perm[j] = k)
        perm = torch.where(idx == k, j, idx)
        perm = torch.where(idx == j, k, perm)
        a = a[perm][:, perm]
        piv = piv[perm]
        pivot = a[k, k]
        ok = pivot > tol_t
        rank = rank + ok.to(torch.int32)
        lkk = torch.sqrt(torch.where(ok, pivot, torch.ones_like(pivot)))
        row = torch.where(idx > k, a[k] / lkk, zero)
        a[k] = torch.where(idx == k, torch.where(ok, lkk, zero),
                           torch.where(ok, row, zero))
        sel = (idx[:, None] > k) & (idx[None, :] > k)
        a = a - torch.where(sel & ok, torch.outer(row, row), zero)
    return torch.triu(a), piv, rank
