"""TSQR: communication-avoiding tall-skinny QR by a binary reduction tree.

Counterpart of ``prealps_tpu/ops/tsqr.py`` (the tall-skinny QR of the
reference's tournament-pivoting kernels, utils/iterativeKernels/
tournamentPivoting.c:35-40, and of utils/cholqr.c): a QR per row block,
then pairs of R factors stacked and factored again, log2(nblocks) levels of
small (2t × t) QRs. On the card the QRs are cuSOLVER's through
``torch.linalg.qr``.
"""

from __future__ import annotations

import torch

from prealps_tpu_torch.parallel.mesh import all_gather


def sign_fixed(r: torch.Tensor) -> torch.Tensor:
    """R with a non-negative diagonal (the unique factor): rows scaled by
    sign(diag), with sign(0) taken as 1, as the JAX package does."""
    s = torch.sign(torch.diagonal(r))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return r * s[:, None]


def tsqr_r(x: torch.Tensor, nblocks: int = 8) -> torch.Tensor:
    """R factor of x (m, t) via a local binary reduction tree.

    Returns upper-triangular R (t, t) with A = QR (Q not formed). Sign
    convention: R has non-negative diagonal.
    """
    m, t = x.shape
    nblocks = max(1, min(nblocks, m // max(t, 1)))
    # pad rows so blocks are equal
    mb = -(-m // nblocks)
    pad = nblocks * mb - m
    if pad:
        x = torch.cat([x, x.new_zeros((pad, t))], dim=0)
    r = torch.linalg.qr(x.reshape(nblocks, mb, t), mode="r").R   # (nblocks, t, t)
    while r.shape[0] > 1:
        if r.shape[0] % 2 == 1:
            r = torch.cat([r, r.new_zeros((1,) + tuple(r.shape[1:]))], dim=0)
        r = torch.linalg.qr(r.reshape(r.shape[0] // 2, 2 * r.shape[1], t),
                            mode="r").R
    return sign_fixed(r[0])


def tsqr(x: torch.Tensor, nblocks: int = 8):
    """Full TSQR: returns (Q, R) with Q (m, t) orthonormal, A = QR.

    Q is recovered as X R⁻¹ with one refinement pass (numerically fine for
    the well-conditioned panels Krylov methods produce; for nearly singular
    panels use tsqr_r + explicit column handling).
    """
    r = tsqr_r(x, nblocks)
    q = torch.linalg.solve_triangular(r, x, upper=True, left=False)
    # one reorthogonalisation pass (CholQR2-style)
    r2 = tsqr_r(q, nblocks)
    q = torch.linalg.solve_triangular(r2, q, upper=True, left=False)
    return q, r2 @ r


def tsqr_r_distributed(x_loc: torch.Tensor, group) -> torch.Tensor:
    """R factor across shards (x_loc: this rank's rows): the local R
    factors gathered with a leading axis (the untiled all-gather of
    ``parallel/mesh.py::all_gather``), then one stacked QR — the
    cross-device level of the reduction tree (one collective). Every rank
    returns the same R."""
    r_loc = tsqr_r(x_loc, nblocks=4)
    t = r_loc.shape[1]
    r_all = all_gather(r_loc[None], group, dim=0)           # (S, t, t)
    r = torch.linalg.qr(r_all.reshape(-1, t), mode="r").R
    return sign_fixed(r)
