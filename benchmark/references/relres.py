"""Plain f64 reference check of a linear solve: the relative residual of
the returned x on the benchmark's own copy of the matrix and right-hand
side, in NumPy/SciPy float64.

It imports nothing of the program and takes nothing the program made. The
scaled residual is worked out again from the definition of the symmetric
row-and-column equilibration that preAlps applies before it solves
(D_ii = 1 / sqrt(max_j |a_ij|), the system D A D y = D b, x = D y):
‖D (b − A x)‖ / ‖D b‖.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def equilibration(a: sp.csr_matrix) -> np.ndarray:
    """D's diagonal: 1 / sqrt of each row's largest |a_ij|."""
    rowmax = np.asarray(abs(a).max(axis=1).todense()).ravel()
    return 1.0 / np.sqrt(rowmax)


def residuals(a: sp.csr_matrix, d: np.ndarray, b: np.ndarray, x: np.ndarray) -> dict:
    """Relative residuals of x: on the original system and on the scaled
    one. A non-finite x reads as infinitely wrong."""
    x = np.asarray(x, dtype=np.float64)
    if x.shape != b.shape or not np.all(np.isfinite(x)):
        return {"relres": np.inf, "relres_scaled": np.inf}
    r = b - a @ x
    return {"relres": float(np.linalg.norm(r) / np.linalg.norm(b)),
            "relres_scaled": float(np.linalg.norm(d * r) / np.linalg.norm(d * b))}
