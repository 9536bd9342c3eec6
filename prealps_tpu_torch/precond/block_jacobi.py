"""Block-Jacobi preconditioner on row-major panels, built on the host.

The PyTorch counterpart of ``prealps_tpu/precond/block_jacobi.py``. The
diagonal of A is split into nb contiguous row blocks (``nsplit``), each
RCM-ordered and densified, padded to a common size mb with an identity
tail; the host factors them in f64. Two apply modes:

* ``mode="inverse"`` (the default for float32): explicit f64 inverses cast
  to the working type; the apply is one batched GEMM (``torch.bmm``).
* ``mode="cholesky"`` (the default otherwise): lower Cholesky factors; the
  apply is two batched triangular solves (exact, the f64 path).

``gather_idx`` maps padded block-major positions to local rows, with the
sentinel m pointing at a zero row appended to the panel; ``inv_perm`` maps
local rows back to their padded block-major position.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.core.partition import nsplit, rcm_order


@dataclass
class BlockJacobi:
    factors: torch.Tensor     # (nb, mb, mb) inverses or lower Cholesky factors
    gather_idx: torch.Tensor  # (nb·mb,) int64 in [0, m]; m = appended zero row
    inv_perm: torch.Tensor    # (m,) int64 into nb·mb
    mode: str = "cholesky"

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        """(m, t) -> (m, t): w = blockdiag(Aᵢᵢ)⁻¹ z."""
        nb, mb, _ = self.factors.shape
        t = z.shape[1]
        z_ext = torch.cat([z, torch.zeros((1, t), dtype=z.dtype, device=z.device)])
        zb = z_ext[self.gather_idx].reshape(nb, mb, t)
        if self.mode == "inverse":
            w = torch.bmm(self.factors, zb)
        else:
            y = torch.linalg.solve_triangular(self.factors, zb, upper=False)
            w = torch.linalg.solve_triangular(self.factors.mT, y, upper=True)
        return w.reshape(nb * mb, t)[self.inv_perm]


def block_jacobi_host(a: sp.spmatrix, nblocks: int | None = None,
                      block_size: int | None = None, rcm: bool = True,
                      dtype=None, mode: str | None = None):
    """Host build from the local diagonal matrix ``a``: (factors (nb, mb, mb)
    numpy in ``dtype``, gather_idx (nb·mb,) int32, inv_perm (m,) int32,
    mode). Default: blocks of ~1024 rows."""
    a = sp.csr_matrix(a)
    m = a.shape[0]
    if nblocks is None:
        nblocks = max(1, -(-m // (block_size or 1024)))
    offsets = nsplit(m, nblocks)
    mb = int(np.diff(offsets).max())
    dtype = np.dtype(dtype or a.dtype)
    if mode is None:
        mode = "inverse" if dtype == np.float32 else "cholesky"
    blocks = np.zeros((nblocks, mb, mb), dtype=np.float64)
    gather_idx = np.full(nblocks * mb, m, dtype=np.int32)
    inv_perm = np.empty(m, dtype=np.int32)
    for i in range(nblocks):
        r0, r1 = int(offsets[i]), int(offsets[i + 1])
        sz = r1 - r0
        sub = a[r0:r1, r0:r1]
        p = rcm_order(sub) if rcm and sz > 2 else np.arange(sz)
        blocks[i, :sz, :sz] = sub[p][:, p].toarray()
        blocks[i, sz:, sz:] = np.eye(mb - sz)
        rows = r0 + p                       # local rows in block-major order
        pos = i * mb + np.arange(sz)        # padded positions
        gather_idx[pos] = rows
        inv_perm[rows] = pos
    if mode == "inverse":
        factors = np.linalg.inv(blocks).astype(dtype)
    else:
        factors = np.linalg.cholesky(blocks).astype(dtype)
    return factors, gather_idx, inv_perm, mode


def build_block_jacobi(a: sp.spmatrix, nblocks: int | None = None,
                       block_size: int | None = None, rcm: bool = True,
                       dtype=None, mode: str | None = None,
                       device="cpu") -> BlockJacobi:
    """``block_jacobi_host`` with the arrays moved to ``device``."""
    factors, gather_idx, inv_perm, mode = block_jacobi_host(
        a, nblocks, block_size, rcm, dtype, mode)
    return BlockJacobi(
        factors=torch.from_numpy(factors).to(device),
        gather_idx=torch.from_numpy(gather_idx.astype(np.int64)).to(device),
        inv_perm=torch.from_numpy(inv_perm.astype(np.int64)).to(device),
        mode=mode)
