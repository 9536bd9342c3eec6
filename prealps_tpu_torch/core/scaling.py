"""Symmetric row/column equilibration (host side, numpy/scipy).

A copy of ``prealps_tpu/core/scaling.py``: A' = D A D with
D_ii = 1/sqrt(max_j |a_ij|), which keeps an SPD matrix SPD with a unit-ish
diagonal. Bitwise equal to the JAX package's version (test_torch_host.py).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def sym_rac_scaling(a: sp.csr_matrix):
    """Return (A_scaled, d) with A_scaled = diag(d) @ A @ diag(d).

    Raises if a row is entirely zero.
    """
    a = a.tocsr()
    counts = np.diff(a.indptr)
    if np.any(counts == 0):
        raise ValueError("cannot scale: matrix has an empty row (rcmin=0)")
    # maximum |a_ij| per row: segmented reduce over the CSR runs (safe
    # because empty rows were rejected above)
    absa = np.abs(a.data)
    rowmax = np.maximum.reduceat(absa, a.indptr[:-1])
    if np.any(rowmax == 0):
        raise ValueError("cannot scale: matrix has an empty row (rcmin=0)")
    d = 1.0 / np.sqrt(rowmax)
    data = a.data * np.repeat(d, counts)   # a_ij · d_i
    data *= d[a.indices]                   # · d_j
    scaled = sp.csr_matrix(
        (data, a.indices.copy(), a.indptr.copy()), shape=a.shape
    )
    # canonical form: explicit zeros dropped (FEM assembly stores some), so
    # downstream structure detection keys on the true pattern
    scaled.eliminate_zeros()
    scaled.sort_indices()
    return scaled, d
