"""Sparse formats (ELL, block-ELL, stencil block-sparse) and panel layouts.

The host conversions are numpy copies of ``prealps_tpu/ops/formats.py``
(``csr_to_ell``, ``csr_to_block_ell``, ``csr_to_stencil_bsr``/``_t``,
``csr_to_dia_ell`` and the format detection of ``fmt="auto"``:
``dia_coverage``, ``block_fill``, ``detect_format``,
``csr_to_dia_ell_auto``) and give the same arrays and choices bit for bit;
the arrays then move to the requested device as tensors.

General formats (row-major (n, t) panels):

* ELL        vals (n, L), cols (n, L) int32: every row padded to the longest
             row L; padding entries have value 0 and column 0.
* block-ELL  blocks (nrb, S, bm, bk), blkcols (nrb, S) int32: for each bm-row
             block, its S bk-wide column blocks with nonzeros, padded to the
             longest such list; padding slots point at column block 0 and
             hold zeros, so they add nothing.
* DIA+ELL    diags (D, n): the D promoted diagonals, entry [d, i] = a[i, i +
             off_d] (zero where that column leaves the matrix), plus an ELL
             remainder of the entries on no promoted diagonal. A DIA table
             is also a br = 1 stencil block table (S = D).

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

from prealps_tpu_torch.core.partition import morton_perm, pseudo_coords, rcm_order


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


@dataclass
class DiaEllMatrix:
    """Hybrid DIA + ELL: y[i] = Σ_d diags[d, i] · x[i + offsets[d]] plus the
    ELL remainder of the entries off the promoted diagonals."""

    offsets: tuple            # diagonal offsets (col − row), ascending
    diags: torch.Tensor       # (D, n); entry [d, i] multiplies x[i + off_d]
    rem: EllMatrix | None     # stragglers (None if band-complete)
    shape: tuple


def dia_ell_host(a: sp.spmatrix, min_fill: float = 0.2, max_diags: int = 512,
                 dtype=None):
    """Host DIA + ELL split: (offsets, diags (D, n) numpy, remainder CSR or
    None). Diagonals holding at least ``min_fill · n`` nonzeros are promoted
    (at most ``max_diags``, densest first); the rest is the remainder."""
    a = sp.csr_matrix(a)
    n, m = a.shape
    if n != m:
        raise ValueError("DIA+ELL requires a square matrix")
    dtype = np.dtype(dtype) if dtype is not None else a.dtype
    coo = a.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq, counts = np.unique(off, return_counts=True)
    dense = uniq[counts >= max(int(min_fill * n), 1)]
    if dense.size > max_diags:
        order = np.argsort(counts[np.isin(uniq, dense)])[::-1]
        dense = np.sort(dense[order[:max_diags]])
    on_dia = np.isin(off, dense)
    diags = np.zeros((max(dense.size, 1), n), dtype=dtype)
    pos = {int(o): d for d, o in enumerate(dense)}
    if dense.size:
        didx = np.fromiter((pos[int(o)] for o in off[on_dia]), dtype=np.int64,
                           count=int(on_dia.sum()))
        np.add.at(diags, (didx, coo.row[on_dia]), coo.data[on_dia])
    rem_mask = ~on_dia
    rem = None
    if rem_mask.any():
        rem = sp.csr_matrix(sp.coo_matrix(
            (coo.data[rem_mask], (coo.row[rem_mask], coo.col[rem_mask])),
            shape=a.shape))
    offsets = tuple(int(o) for o in dense) if dense.size else (0,)
    return offsets, diags, rem


def csr_to_dia_ell(a: sp.spmatrix, min_fill: float = 0.2, max_diags: int = 512,
                   dtype=None, device="cpu") -> DiaEllMatrix:
    """Square CSR -> hybrid DIA + ELL on ``device`` (``dia_ell_host``)."""
    offsets, diags, rem = dia_ell_host(a, min_fill, max_diags, dtype)
    dtype = diags.dtype
    return DiaEllMatrix(
        offsets=offsets, diags=torch.from_numpy(diags).to(device),
        rem=None if rem is None else csr_to_ell(rem, dtype=dtype, device=device),
        shape=a.shape)


def dia_coverage(a: sp.spmatrix, min_fill: float = 0.2) -> float:
    """Fraction of nnz on diagonals that would be promoted at `min_fill`."""
    a = sp.csr_matrix(a)
    coo = a.tocoo()
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    _, counts = np.unique(off, return_counts=True)
    dense = counts >= max(int(min_fill * a.shape[0]), 1)
    return float(counts[dense].sum() / max(a.nnz, 1))


def block_fill(a: sp.spmatrix, bm: int = 8, bk: int = 8) -> float:
    """nnz density of the occupied bm×bk blocks (1.0 = perfectly dense)."""
    coo = sp.csr_matrix(a).tocoo()
    if coo.nnz == 0:
        return 0.0
    ncb = -(-a.shape[1] // bk)
    keys = (coo.row // bm).astype(np.int64) * ncb + coo.col // bk
    nblk = np.unique(keys).size
    return float(coo.nnz / (nblk * bm * bk))


def detect_format(a: sp.spmatrix, br: int = 3, nshards: int = 1,
                  dia_min_cov: float = 0.85, bell_min_fill: float = 0.06,
                  allow_stencil: bool = True,
                  allow_reorder: bool = True) -> tuple[str, dict]:
    """Pick the storage format for `a` (the cascade of
    ``prealps_tpu/ops/formats.py::detect_format``, the same choices and
    permutations):

      1. stencil-BSR: few constant node offsets with dense-enough blocks;
      2. DIA+ELL: ≥ dia_min_cov of nnz on promoted diagonals, in the
         caller's order or ("dia_rcm") under RCM;
      3. block-ELL 8×8 under a Morton order of BFS pseudo-coordinates
         ("block_ell_morton") or in the natural order;
      4. ELL otherwise.

    allow_reorder=False disables the choices that permute rows. Returns
    (fmt, info): fmt in {"stencil", "dia", "dia_rcm", "block_ell_morton",
    "block_ell_natural", "ell"}; info carries the scores and, for the
    reordering choices, the permutation under info["perm"] and the permuted
    matrix under info["permuted"]."""
    a = sp.csr_matrix(a)
    n, m = a.shape
    info: dict = {}

    st_fill = 0.0
    stencil_ok = False
    if allow_stencil and n == m and n % br == 0:
        coo = a.tocoo()
        delta = coo.col.astype(np.int64) // br - coo.row.astype(np.int64) // br
        offs = np.unique(delta)
        info["stencil_offsets"] = int(offs.size)
        if offs.size <= 64:
            st_fill = a.nnz / ((n // br) * offs.size * br * br)
            info["stencil_fill"] = round(float(st_fill), 3)
            stencil_ok = st_fill >= 0.1

    cov = dia_coverage(a, min_fill=0.05)
    info["dia_coverage"] = round(float(cov), 3)

    # a scalar-banded matrix also passes the br-block stencil test, at
    # ~1/br block fill: DIA wins only where it qualifies outright
    prefer_dia = cov >= max(0.9, dia_min_cov) and st_fill < 0.5
    if stencil_ok and not prefer_dia:
        return "stencil", info
    if cov >= dia_min_cov:
        return "dia", info
    if stencil_ok:
        return "stencil", info
    if n == m and allow_reorder:
        perm_r = rcm_order(a)
        ap_r = a[perm_r][:, perm_r].tocsr()
        cov_r = dia_coverage(ap_r, min_fill=0.05)
        info["dia_coverage_rcm"] = round(float(cov_r), 3)
        if cov_r >= dia_min_cov:
            info["perm"] = perm_r
            info["permuted"] = ap_r
            return "dia_rcm", info

    # multi-shard block-ELL moves 128-wide column blocks: no Morton probe
    bk = 8 if nshards <= 1 else 128
    fill_nat = block_fill(a, 8, bk)
    info["bell_fill_natural"] = round(fill_nat, 3)
    if n == m and nshards <= 1 and allow_reorder:
        perm = morton_perm(pseudo_coords(a))
        ap = a[perm][:, perm].tocsr()
        fill_m = block_fill(ap, 8, bk)
        info["bell_fill_morton"] = round(fill_m, 3)
        if fill_m >= bell_min_fill and fill_m > 1.3 * fill_nat:
            info["perm"] = perm
            info["permuted"] = ap
            return "block_ell_morton", info
    if fill_nat >= max(bell_min_fill, 0.1):
        return "block_ell_natural", info
    return "ell", info


def csr_to_dia_ell_auto(a: sp.spmatrix, min_fill: float = 0.2, dtype=None,
                        device="cpu"):
    """DIA+ELL in the caller's order when it is diagonal-dominated
    (coverage ≥ 0.9), else under RCM where that covers more. Returns
    (DiaEllMatrix, perm), perm None when the caller's order is kept."""
    cov_nat = dia_coverage(a, min_fill)
    if cov_nat >= 0.9:
        return csr_to_dia_ell(a, min_fill=min_fill, dtype=dtype, device=device), None
    perm = rcm_order(sp.csr_matrix(a))
    ap = sp.csr_matrix(sp.csr_matrix(a)[perm][:, perm])
    cov_rcm = dia_coverage(ap, min_fill)
    if cov_rcm > cov_nat:
        return csr_to_dia_ell(ap, min_fill=min_fill, dtype=dtype, device=device), perm
    return csr_to_dia_ell(a, min_fill=min_fill, dtype=dtype, device=device), None


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
