"""MatrixMarket, vector and partition files (host side, scipy).

The port's copy of ``prealps_tpu/core/io.py``: the scipy-backed
MatrixMarket reader (CSR with sorted indices, symmetric files expanded)
and writer, plain-text vectors, and row-partition files (one part id per
row, ``%`` comments, -1 on separator rows). ``tests/test_torch_io.py``
holds each load bitwise equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp


def load_mtx(path: str, dtype=np.float64) -> sp.csr_matrix:
    """Load a MatrixMarket file into CSR (symmetric files expanded)."""
    csr = sp.csr_matrix(scipy.io.mmread(path), dtype=dtype)
    csr.sum_duplicates()
    csr.sort_indices()
    return csr


def save_mtx(path: str, a: sp.spmatrix, comment: str = "") -> None:
    scipy.io.mmwrite(path, sp.coo_matrix(a), comment=comment)


def load_vector(path: str, dtype=np.float64) -> np.ndarray:
    """A dense vector stored as a MatrixMarket array or as plain text."""
    try:
        return np.asarray(scipy.io.mmread(path), dtype=dtype).ravel()
    except Exception:
        return np.loadtxt(path, dtype=dtype).ravel()


def save_vector(path: str, v: np.ndarray) -> None:
    np.savetxt(path, np.asarray(v).ravel())


def load_partition(path: str, n: int | None = None) -> np.ndarray:
    """A row-partition vector: one part id per row (-1 marks separator rows
    for the block-arrow preconditioners), plain text with '%' comments."""
    part = np.loadtxt(path, dtype=np.int64, comments="%").ravel()
    if n is not None and part.shape[0] != n:
        raise ValueError(
            f"partition file has {part.shape[0]} entries, matrix has {n} rows")
    return part


def save_partition(path: str, part: np.ndarray) -> None:
    """Write a row-partition vector (one part id per line, '%' header)."""
    part = np.asarray(part, dtype=np.int64).ravel()
    with open(path, "w") as f:
        f.write(f"% prealps_tpu partition: {part.shape[0]} rows, "
                f"{int(part.max()) + 1} parts"
                f"{', separator rows marked -1' if (part < 0).any() else ''}\n")
        np.savetxt(f, part, fmt="%d")
