"""Panel layout operations for the ECG state.

The two layouts of ``prealps_tpu/solvers/panels.py``:

* "nt"  — rows-major (m, t) panels: the general-sparse formats (ELL,
  block-ELL) and the host block-Jacobi preconditioner work on them.
* "tbn" — lane-major (t, *space) panels with space typically (br, nrb), so
  the long node axis is the contiguous one: the stencil formats.

Every layout-dependent operation the solver needs goes through one of these
namespaces; the solver algebra in ecg.py is layout-blind. Products are
plain matmuls, which run in true f32 once ``config.strict_fp32`` has
switched TF32 off (the JAX versions ask for ``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch


class NT:
    """Rows-major (m, t) panels."""

    name = "nt"

    @staticmethod
    def gram(x, y):
        """(t, s) block xᵀy."""
        return x.mT @ y

    @staticmethod
    def update(x, p, coef):
        """x + p·coef with coef (d, r): combine direction columns."""
        return x + p @ coef

    @staticmethod
    def downdate(x, p, coef):
        return x - p @ coef

    @staticmethod
    def right_solve(u, p):
        """P U⁻¹ (mix direction columns by the inverse factor)."""
        return torch.linalg.solve_triangular(u, p, upper=True, left=False)

    @staticmethod
    def rotate(p, q):
        """P Q (direction mixing by a small t×t matrix)."""
        return p @ q

    mix = rotate

    @staticmethod
    def scale_dirs(p, mask):
        return p * mask[None, :]

    @staticmethod
    def sum_dirs(x_blk):
        return torch.sum(x_blk, dim=1)

    @staticmethod
    def split(b, t, assign):
        """b: (m,); assign: (m,) ints -> (m, t): column j holds the entries
        of b assigned to j."""
        onehot = torch.nn.functional.one_hot(assign.long(), t).to(b.dtype)
        return onehot * b[:, None]

    @staticmethod
    def zeros_like_panel(b, t):
        return torch.zeros(tuple(b.shape) + (t,), dtype=b.dtype, device=b.device)

    @staticmethod
    def take_dirs(p, idx):
        return p[:, idx]


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
    def right_solve(u, p):
        """(P U⁻¹) in lane-major is U⁻ᵀ applied on the left: solve Uᵀ X = P."""
        t = p.shape[0]
        out = torch.linalg.solve_triangular(u.mT, p.reshape(t, -1), upper=False)
        return out.reshape(p.shape)

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


LAYOUTS = {"nt": NT, "tbn": TBN}
