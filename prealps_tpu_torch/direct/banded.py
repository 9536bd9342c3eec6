"""Batched block-banded Cholesky: the subdomain direct solver of LORASC.

The PyTorch counterpart of ``prealps_tpu/direct/banded.py:152-295``. After a
bandwidth-reducing ordering each subdomain matrix is block-tridiagonal with
bs×bs blocks (D_i diagonal, E_i subdiagonal), factored batched over the P
subdomains, block by block:

    M_i = E_i L_{i-1}⁻ᵀ ;  S_i = D_i − M_i M_iᵀ ;  L_i = chol(S_i)

with L_i⁻¹ stored explicitly so that the solves are GEMMs only:

    forward:   y_i = L_i⁻¹ (v_i − M_i y_{i-1})
    backward:  w_i = L_i⁻ᵀ (y_i − M_{i+1}ᵀ w_{i+1})

The ``lax.scan`` recurrences become Python loops over the nblk blocks of
batched ``torch.matmul`` (the JAX package leaves these einsums to XLA).
``cholesky(symmetrize_input=True)`` becomes a symmetrisation and
``torch.linalg.cholesky_ex``; a failed factor (or a non-finite inverse) in
any subdomain zeroes that block's inverses and sets ``failed``, as the JAX
version's NaN mapping does. The two-level (row-sharded) solve and the Schur
routines are not ported (ROADMAP.md queue A, items 5-6).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class BlockBandedCholesky:
    """Factored batched block-banded SPD matrix (see module docstring)."""

    l_inv: torch.Tensor   # (P, nblk, bs, bs) inverted diagonal Cholesky factors
    m_off: torch.Tensor   # (P, nblk, bs, bs) subdiagonal factors, M[0] = 0
    failed: torch.Tensor  # () bool: some block failed to factor

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        """v: (P, nblk, bs, t) -> (P, nblk, bs, t)."""
        return block_banded_solve(self, v)


def block_banded_cholesky(d: torch.Tensor, e: torch.Tensor,
                          shift: float = 0.0) -> BlockBandedCholesky:
    """Factor the batched block-banded matrix given by (D, E).

    ``shift`` adds shift·diag(D_i) before factoring (the f32 builds retry
    with growing shifts when a factor fails)."""
    P, nblk, bs, _ = d.shape
    dtype, dev = d.dtype, d.device
    if shift:
        d = d + shift * torch.diag_embed(torch.diagonal(d, dim1=-2, dim2=-1))
    eye = torch.eye(bs, dtype=dtype, device=dev).expand(P, bs, bs)
    l_inv = torch.empty_like(d)
    m_off = torch.empty_like(d)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    l_prev = torch.zeros((P, bs, bs), dtype=dtype, device=dev)
    for i in range(nblk):
        m_i = e[:, i] @ l_prev.mT
        s_i = d[:, i] - m_i @ m_i.mT
        l_i, info = torch.linalg.cholesky_ex(0.5 * (s_i + s_i.mT))
        ok = info == 0
        l_i = torch.where(ok[:, None, None], l_i, eye)
        inv = torch.linalg.solve_triangular(l_i, eye, upper=False)
        bad = ~ok.all() | ~torch.isfinite(inv).all()
        l_prev = torch.where(bad, torch.zeros((), dtype=dtype, device=dev), inv)
        l_inv[:, i] = l_prev
        m_off[:, i] = m_i
        failed = failed | bad
    return BlockBandedCholesky(l_inv=l_inv, m_off=m_off, failed=failed)


def block_banded_solve(fac: BlockBandedCholesky, v: torch.Tensor) -> torch.Tensor:
    """Solve A w = v for the factored block-banded A; v: (P, nblk, bs, t)."""
    nblk = v.shape[1]
    y = [None] * nblk
    for i in range(nblk):
        rhs = v[:, i] if i == 0 else v[:, i] - fac.m_off[:, i] @ y[i - 1]
        y[i] = fac.l_inv[:, i] @ rhs
    w = [None] * nblk
    for i in reversed(range(nblk)):
        rhs = y[i] if i == nblk - 1 else y[i] - fac.m_off[:, i + 1].mT @ w[i + 1]
        w[i] = fac.l_inv[:, i].mT @ rhs
    return torch.stack(w, dim=1)


def block_banded_solve_t(fac: BlockBandedCholesky, v3: torch.Tensor) -> torch.Tensor:
    """t-major variant of block_banded_solve: v3 (nblk, P, t, bs), the layout
    of the LORASC sweeps. Same factors, same math."""
    nblk = v3.shape[0]
    y = [None] * nblk
    for i in range(nblk):
        rhs = v3[i] if i == 0 else v3[i] - y[i - 1] @ fac.m_off[:, i].mT
        y[i] = rhs @ fac.l_inv[:, i].mT
    w = [None] * nblk
    for i in reversed(range(nblk)):
        rhs = y[i] if i == nblk - 1 else y[i] - w[i + 1] @ fac.m_off[:, i + 1]
        w[i] = rhs @ fac.l_inv[:, i]
    return torch.stack(w, dim=0)


def block_banded_matvec(d: torch.Tensor, e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A v for the block-banded (D, E) operator; v: (P, nblk, bs, t)."""
    y = d @ v
    y[:, 1:] += e[:, 1:] @ v[:, :-1]
    y[:, :-1] += e[:, 1:].mT @ v[:, 1:]
    return y
