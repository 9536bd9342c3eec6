"""Sparse formats (ELL, block-ELL, stencil block-sparse) and panel layouts.

The host conversions are numpy copies of ``prealps_tpu/ops/formats.py``
(``csr_to_ell``, ``csr_to_block_ell``, ``csr_to_stencil_bsr``/``_t``) and
give the same arrays bit for bit; the arrays then move to the requested
device as tensors.

General formats (row-major (n, t) panels):

* ELL        vals (n, L), cols (n, L) int32: every row padded to the longest
             row L; padding entries have value 0 and column 0.
* block-ELL  blocks (nrb, S, bm, bk), blkcols (nrb, S) int32: for each bm-row
             block, its S bk-wide column blocks with nonzeros, padded to the
             longest such list; padding slots point at column block 0 and
             hold zeros, so they add nothing.

A stencil operator stores, for each node r and each of S constant node
offsets o_s, one dense br×br block:  y_r = Σ_s B[r, s] · x_{r + o_s}.
Boundary blocks are zero, so out-of-range neighbours contribute nothing.

Layouts (t = number of panel columns, nrb = number of nodes):

* lane-major panel  (t, br, nrb)       the solver's panel shape
* flat k-major      (br·t, nrb)        row k·t + j = component k of column j;
                                       the stencil kernel's x and y layout
* block table 4-D   (S, br, br, nrb)   blocks_t[s, m, k, r]
* block table flat  (S·br², nrb)       row s·br² + m·br + k
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch


@dataclass
class EllMatrix:
    vals: torch.Tensor   # (n, L)
    cols: torch.Tensor   # (n, L) int32
    shape: tuple         # (n, ncols)


@dataclass
class BlockEllMatrix:
    blocks: torch.Tensor   # (nrb, S, bm, bk)
    blkcols: torch.Tensor  # (nrb, S) int32
    shape: tuple           # (n_pad, ncols_pad): multiples of bm and bk

    @property
    def bm(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def bk(self) -> int:
        return int(self.blocks.shape[3])


def csr_to_ell(a: sp.spmatrix, ncols: int | None = None, dtype=None,
               device="cpu") -> EllMatrix:
    """CSR -> ELL on ``device``: rows padded to the longest row L."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    row_len = np.diff(a.indptr)
    ell_width = max(int(row_len.max()), 1)
    vals = np.zeros((n, ell_width), dtype=dtype or a.dtype)
    cols = np.zeros((n, ell_width), dtype=np.int32)
    rows = np.repeat(np.arange(n), row_len)
    slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_len)
    vals[rows, slot] = a.data
    cols[rows, slot] = a.indices
    return EllMatrix(torch.from_numpy(vals).to(device),
                     torch.from_numpy(cols).to(device),
                     (n, ncols if ncols is not None else a.shape[1]))


def csr_to_block_ell(a: sp.spmatrix, bm: int = 8, bk: int = 128,
                     ncols: int | None = None, dtype=None,
                     device="cpu") -> BlockEllMatrix:
    """CSR -> block-ELL on ``device``; n is padded to a multiple of bm and
    the column count to a multiple of bk."""
    a = sp.csr_matrix(a)
    n, m = a.shape
    ncols = ncols if ncols is not None else m
    n_pad = -(-n // bm) * bm
    ncols_pad = -(-ncols // bk) * bk
    nrb = n_pad // bm
    ncb = ncols_pad // bk

    coo = a.tocoo()
    rb = coo.row // bm
    cb = coo.col // bk
    # unique (row block, column block) pairs, in order
    pair_key = rb.astype(np.int64) * ncb + cb
    uniq_keys = np.unique(pair_key)
    uniq_rb = (uniq_keys // ncb).astype(np.int64)
    uniq_cb = (uniq_keys % ncb).astype(np.int64)
    counts_per_rb = np.bincount(uniq_rb, minlength=nrb)
    s_max = max(int(counts_per_rb.max() if counts_per_rb.size else 0), 1)
    # slot of each pair within its row block
    slot_of_uniq = np.arange(uniq_keys.size) - np.concatenate(
        [[0], np.cumsum(counts_per_rb)])[uniq_rb]

    blocks = np.zeros((nrb, s_max, bm, bk), dtype=dtype or a.dtype)
    blkcols = np.zeros((nrb, s_max), dtype=np.int32)
    blkcols[uniq_rb, slot_of_uniq] = uniq_cb
    slot = slot_of_uniq[np.searchsorted(uniq_keys, pair_key)]
    blocks[rb, slot, coo.row % bm, coo.col % bk] = coo.data
    return BlockEllMatrix(torch.from_numpy(blocks).to(device),
                          torch.from_numpy(blkcols).to(device), (n_pad, ncols_pad))


@dataclass
class StencilBsrMatrix:
    """Node-major stencil blocks (nrb, S, br, br) with static node offsets."""

    blocks: torch.Tensor   # (nrb, S, br, br)
    offsets: tuple         # S python ints, ascending
    shape: tuple           # (n, n), n = nrb·br

    @property
    def br(self) -> int:
        return int(self.blocks.shape[2])


@dataclass
class StencilBsrTMatrix:
    """Lane-major stencil blocks blocks_t[s, m, k, r] (node index minor)."""

    blocks_t: torch.Tensor  # (S, br, br, nrb)
    offsets: tuple
    shape: tuple

    @property
    def br(self) -> int:
        return int(self.blocks_t.shape[1])


def stencil_blocks_host(a: sp.spmatrix, br: int, max_offsets: int = 64,
                        dtype=None):
    """Host stencil conversion: (blocks (nrb, S, br, br) numpy, offsets)
    or None if the block pattern is not a small constant stencil.
    Requires br | a.shape[0]."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    if n % br or a.shape[1] != n:
        return None
    nrb = n // br
    coo = a.tocoo()
    rb = coo.row // br
    cb = coo.col // br
    delta = cb - rb
    offs = np.unique(delta)
    if offs.size > max_offsets:
        return None
    slot = np.searchsorted(offs, delta)
    blocks = np.zeros((nrb, offs.size, br, br), dtype=dtype or a.dtype)
    blocks[rb, slot, coo.row % br, coo.col % br] = coo.data
    return blocks, tuple(int(d) for d in offs)


def csr_to_stencil_bsr(a: sp.spmatrix, br: int, max_offsets: int = 64,
                       dtype=None, device="cpu") -> StencilBsrMatrix | None:
    """Stencil-BSR on ``device``; None if A is not stencil-structured."""
    host = stencil_blocks_host(a, br, max_offsets, dtype)
    if host is None:
        return None
    blocks, offsets = host
    n = a.shape[0]
    return StencilBsrMatrix(torch.from_numpy(blocks).to(device), offsets,
                            (n, n))


def csr_to_stencil_bsr_t(a: sp.spmatrix, br: int, max_offsets: int = 64,
                         dtype=None, device="cpu") -> StencilBsrTMatrix | None:
    """Lane-major variant of csr_to_stencil_bsr: blocks_t (S, br, br, nrb)."""
    host = stencil_blocks_host(a, br, max_offsets, dtype)
    if host is None:
        return None
    blocks, offsets = host
    blocks_t = np.ascontiguousarray(blocks.transpose(1, 2, 3, 0))
    n = a.shape[0]
    return StencilBsrTMatrix(torch.from_numpy(blocks_t).to(device), offsets,
                             (n, n))


def stencil_blocks_flat(blocks_t: torch.Tensor) -> torch.Tensor:
    """(S, br, br, nrb) -> (S·br², nrb) flat block table."""
    s, br, _, nrb = blocks_t.shape
    return blocks_t.reshape(s * br * br, nrb)


def panel_to_flat_kmajor(xt: torch.Tensor) -> torch.Tensor:
    """(t, br, nrb) lane-major -> (br·t, nrb) k-major flat rows."""
    t_dim, br, nrb = xt.shape
    return xt.permute(1, 0, 2).reshape(br * t_dim, nrb)


def panel_from_flat_kmajor(yf: torch.Tensor, br: int) -> torch.Tensor:
    """(br·t, nrb) k-major flat -> (t, br, nrb) lane-major."""
    bt_rows, nrb = yf.shape
    return yf.reshape(br, bt_rows // br, nrb).permute(1, 0, 2)


def panel_to_lane_major(x: torch.Tensor, br: int) -> torch.Tensor:
    """(n, t) -> (t, br, nrb)"""
    n, t = x.shape
    return x.reshape(n // br, br, t).permute(2, 1, 0)


def panel_from_lane_major(xt: torch.Tensor) -> torch.Tensor:
    """(t, br, nrb) -> (n, t)"""
    t, br, nrb = xt.shape
    return xt.permute(2, 1, 0).reshape(nrb * br, t)
