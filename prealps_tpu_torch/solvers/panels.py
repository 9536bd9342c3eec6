"""Panel layout operations for the ECG state.

The lane-major "tbn" layout of ``prealps_tpu/solvers/panels.py``: panels are
(t, *space) with space typically (br, nrb), so the long node axis is the
contiguous one. Every layout-dependent operation the solver needs goes
through this namespace.
"""

from __future__ import annotations

import torch


class TBN:
    """Lane-major (t, *space) panels."""

    name = "tbn"

    @staticmethod
    def gram(x, y):
        """(t, s) block xᵀy over all space entries."""
        return x.reshape(x.shape[0], -1) @ y.reshape(y.shape[0], -1).T

    @staticmethod
    def update(x, p, coef):
        """x + p·coef with coef (d, r): combine direction panels."""
        return x + TBN.rotate(p, coef)

    @staticmethod
    def downdate(x, p, coef):
        return x - TBN.rotate(p, coef)

    @staticmethod
    def rotate(p, q):
        """Σ_d p[d]·q[d, r] (right-multiplication by a small t×t matrix)."""
        return (q.T @ p.reshape(p.shape[0], -1)).reshape((q.shape[1],) + p.shape[1:])

    mix = rotate

    @staticmethod
    def scale_dirs(p, mask):
        return p * mask.reshape((-1,) + (1,) * (p.dim() - 1))

    @staticmethod
    def sum_dirs(x_blk):
        return torch.sum(x_blk, dim=0)

    @staticmethod
    def split(b, t, assign):
        """b: (*space); assign: (*space) ints -> (t, *space): column j holds
        the entries of b assigned to j."""
        tt = torch.arange(t, device=b.device).reshape((t,) + (1,) * b.dim())
        return torch.where(assign[None] == tt, b[None],
                           torch.zeros((), dtype=b.dtype, device=b.device))

    @staticmethod
    def zeros_like_panel(b, t):
        return torch.zeros((t,) + tuple(b.shape), dtype=b.dtype, device=b.device)

    @staticmethod
    def take_dirs(p, idx):
        return p[idx]

