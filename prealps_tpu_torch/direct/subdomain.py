"""Batched subdomain factorizations of the general-matrix preconditioners.

The PyTorch counterpart of ``prealps_tpu/direct/subdomain.py``: each
subdomain block is RCM-ordered (host), densified, padded with an identity
tail and factored by ONE batched Cholesky; the solves are batched
triangular solves. The factors are computed on the host by
``np.linalg.cholesky`` in the build dtype, as the JAX package computes
them, so that both packages hold the same bits (``torch.linalg.cholesky``
on the card would round f32 differently); only the solves run on
``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.core.partition import rcm_order
from prealps_tpu_torch.precond.block_jacobi import BlockJacobi


def build_block_solver(a: sp.spmatrix, offsets: np.ndarray, rcm: bool = True,
                       dtype=None, device="cpu") -> BlockJacobi:
    """Exact solver of a block-diagonal SPD matrix with blocks at
    ``offsets`` (the Aii part of a block-arrow matrix): a cholesky-mode
    ``BlockJacobi``, which for a truly block-diagonal matrix is a direct
    solver."""
    a = sp.csr_matrix(a)
    m = a.shape[0]
    nblocks = len(offsets) - 1
    mb = int(np.diff(offsets).max())
    dtype = dtype or a.dtype
    blocks = np.zeros((nblocks, mb, mb), dtype=dtype)
    gather_idx = np.full(nblocks * mb, m, dtype=np.int64)
    inv_perm = np.empty(m, dtype=np.int64)
    for i in range(nblocks):
        r0, r1 = int(offsets[i]), int(offsets[i + 1])
        sz = r1 - r0
        sub = a[r0:r1, r0:r1]
        p = rcm_order(sub) if rcm and sz > 2 else np.arange(sz)
        blocks[i, :sz, :sz] = sub[p][:, p].toarray()
        blocks[i, sz:, sz:] = np.eye(mb - sz)
        rows = r0 + p
        pos = i * mb + np.arange(sz)
        gather_idx[pos] = rows
        inv_perm[rows] = pos
    factors = np.linalg.cholesky(blocks)
    return BlockJacobi(factors=torch.from_numpy(factors).to(device),
                       gather_idx=torch.from_numpy(gather_idx).to(device),
                       inv_perm=torch.from_numpy(inv_perm).to(device),
                       mode="cholesky")


@dataclass
class DenseCholesky:
    """Dense Cholesky solver of one small SPD matrix (the separator block
    Agg of LORASC)."""

    factor: torch.Tensor   # (n, n) lower

    @classmethod
    def build(cls, a, dtype=None, device="cpu") -> "DenseCholesky":
        dense = a.toarray() if sp.issparse(a) else np.asarray(a)
        if dtype is not None:
            dense = dense.astype(dtype)
        return cls(factor=torch.from_numpy(np.linalg.cholesky(dense)).to(device))

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        """(n, t) -> A⁻¹ z by two triangular solves."""
        y = torch.linalg.solve_triangular(self.factor, z, upper=False)
        return torch.linalg.solve_triangular(self.factor.mT, y, upper=True)
