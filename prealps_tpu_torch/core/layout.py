"""Row layouts: how a global sparse operator maps onto padded shard rows.

numpy copies of ``prealps_tpu/core/layout.py``: a ``RowLayout`` records the
row permutation and the padding that makes every shard's row panel the
same multiple of the block sizes. Padded rows carry an identity diagonal,
so the operator stays SPD and padded solution entries are exactly zero;
with a stencil operator the padded nodes' blocks are zero off the
diagonal, which is what makes the wrap halo of the stencil SpMM exact on
one shard and the ring halo exact on several (parallel/driver.py).

Two constructors: ``contiguous_row_layout`` (stencil formats: no
permutation, all padding at the global tail) and ``build_row_layout`` /
``layout_from_part`` (general formats: rows grouped by the k-way
partition, each shard padded at its own tail). ``build_halo_plan`` derives
the ELL SpMM's neighbour exchange over several shards, and
``build_block_halo_plan`` the block-ELL SpMM's, at column-block
granularity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from prealps_tpu_torch.core.partition import kway_partition, partition_to_perm


@dataclass(frozen=True)
class RowLayout:
    """Static description of a 1-D row partition over ``nshards`` devices."""

    n: int                     # original global size
    n_pad: int                 # padded global size (= nshards * rows_per_shard)
    nshards: int
    rows_per_shard: int
    perm: np.ndarray           # padded position -> old row index; -1 on padding
    inv_perm: np.ndarray       # old row index -> padded position (length n)
    offsets: np.ndarray        # unpadded partition offsets, length nshards+1
    deps: tuple = field(default=(), compare=False)


def contiguous_row_layout(n: int, nshards: int, row_multiple: int = 8) -> RowLayout:
    """Identity-ordered contiguous row partition with ALL padding at the
    global tail (last shard). No permutation, so stencil offsets survive."""
    rps = -(-n // nshards)
    rps = -(-rps // row_multiple) * row_multiple
    n_pad = rps * nshards
    part = np.minimum(np.arange(n) // rps, nshards - 1).astype(np.int64)
    counts = np.bincount(part, minlength=nshards)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    perm = np.full(n_pad, -1, dtype=np.int64)
    perm[:n] = np.arange(n)
    inv = np.arange(n, dtype=np.int64)
    deps = tuple(
        tuple(q for q in range(nshards) if q != s) for s in range(nshards)
    )
    return RowLayout(
        n=n, n_pad=n_pad, nshards=nshards, rows_per_shard=rps,
        perm=perm, inv_perm=inv, offsets=offsets, deps=deps,
    )


def build_row_layout(a: sp.spmatrix, nshards: int, refine_passes: int = 8,
                     row_multiple: int = 8) -> RowLayout:
    """Partition A's rows into ``nshards`` balanced parts (``kway_partition``;
    one shard: every row in part 0) and build the layout."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    if nshards == 1:
        part = np.zeros(n, dtype=np.int64)
    else:
        part = kway_partition(a, nshards, refine_passes)
    return layout_from_part(a, part, nshards, row_multiple=row_multiple)


def layout_from_part(a: sp.spmatrix, part: np.ndarray, nshards: int,
                     row_multiple: int = 8) -> RowLayout:
    """Rows grouped part by part; each shard's panel is rounded up to
    ``row_multiple`` rows and padded at its own tail."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    counts = np.bincount(part, minlength=nshards)
    rows_per_shard = -(-int(counts.max()) // row_multiple) * row_multiple
    perm_grouped, offsets = partition_to_perm(part, nshards)
    n_pad = rows_per_shard * nshards

    # dependency sets on the permuted matrix: shard s depends on shard q if
    # a column of s's rows falls in q's range (one shard depends on none, and
    # skips the permuted copy of A)
    ap = a[perm_grouped][:, perm_grouped].tocsr() if nshards > 1 else None
    deps = [()] if nshards == 1 else []
    for s in range(nshards if nshards > 1 else 0):
        cols = ap.indices[ap.indptr[offsets[s]]: ap.indptr[offsets[s + 1]]]
        owners = np.searchsorted(offsets, cols, side="right") - 1
        deps.append(tuple(sorted(set(int(o) for o in owners) - {s})))

    # permuted index -> padded index (shard-local padding at the panel tail)
    idx_perm = np.arange(n)
    owner = np.searchsorted(offsets, idx_perm, side="right") - 1
    new_positions = owner * rows_per_shard + (idx_perm - offsets[owner])
    perm_pad = np.full(n_pad, -1, dtype=np.int64)
    perm_pad[new_positions] = perm_grouped
    inv = np.empty(n, dtype=np.int64)
    inv[perm_grouped] = new_positions
    return RowLayout(
        n=n, n_pad=n_pad, nshards=nshards, rows_per_shard=rows_per_shard,
        perm=perm_pad, inv_perm=inv, offsets=offsets, deps=tuple(deps),
    )


def permute_and_pad_matrix(a: sp.spmatrix, layout: RowLayout) -> sp.csr_matrix:
    """Return the (n_pad, n_pad) permuted matrix with identity on padded rows."""
    a = sp.csr_matrix(a)
    coo = a.tocoo()
    rows = layout.inv_perm[coo.row]
    cols = layout.inv_perm[coo.col]
    pad_rows = np.flatnonzero(layout.perm < 0)
    data = np.concatenate([coo.data, np.ones(pad_rows.size, dtype=coo.data.dtype)])
    rows = np.concatenate([rows, pad_rows])
    cols = np.concatenate([cols, pad_rows])
    out = sp.coo_matrix((data, (rows, cols)), shape=(layout.n_pad, layout.n_pad)).tocsr()
    out.sort_indices()
    return out


def pad_to_padded(layout: RowLayout, x: np.ndarray) -> np.ndarray:
    """Global vector/block in ORIGINAL ordering -> padded permuted ordering."""
    x = np.asarray(x)
    out = np.zeros((layout.n_pad,) + x.shape[1:], dtype=x.dtype)
    out[layout.inv_perm] = x
    return out


def unpad_from_padded(layout: RowLayout, xp: np.ndarray) -> np.ndarray:
    """Padded permuted vector/block -> original global ordering."""
    return np.asarray(xp)[layout.inv_perm]


@dataclass(frozen=True)
class HaloPlan:
    """Static neighbour-exchange schedule of the ELL SpMM over several
    shards (``prealps_tpu/core/layout.py::HaloPlan``): each shard packs the
    rows of X its neighbours reference (``send_idx``), one all-to-all moves
    the packs, and the shard's ELL columns are remapped into
    [own rows ∥ halo buffer] coordinates (``cols_local``)."""

    h: int                    # rows per (src, dst) slot (max over pairs)
    send_idx: np.ndarray      # (S, S, h) int32: local rows shard s packs for d
    cols_local: np.ndarray    # (n_pad, L) int32: ELL cols in local+halo space
    comm_rows: int            # true (unpadded) total rows exchanged

    @property
    def halo_rows_per_shard(self) -> int:
        return self.send_idx.shape[1] * self.h


def build_halo_plan(layout: RowLayout, ell_cols: np.ndarray,
                    ell_vals: np.ndarray) -> HaloPlan:
    """The exchange schedule of the padded ELL structure: ``ell_cols`` /
    ``ell_vals`` (n_pad, L) global padded column ids and values (zero values
    mark padding slots, left out of the dependency scan)."""
    s_n = layout.nshards
    mpl = layout.rows_per_shard
    used = ell_vals != 0
    owner_of = ell_cols // mpl

    needed = [[None] * s_n for _ in range(s_n)]  # needed[s][q]: global cols
    h = 1
    comm_rows = 0
    for s in range(s_n):
        rows = slice(s * mpl, (s + 1) * mpl)
        cols_s = ell_cols[rows][used[rows]]
        own = owner_of[rows][used[rows]]
        for q in range(s_n):
            if q == s:
                continue
            cq = np.unique(cols_s[own == q])
            needed[s][q] = cq
            h = max(h, cq.size)
            comm_rows += cq.size

    send_idx = np.zeros((s_n, s_n, h), dtype=np.int32)
    for q in range(s_n):
        for s in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            send_idx[q, s, : cq.size] = (cq - q * mpl).astype(np.int32)

    cols_local = np.zeros_like(ell_cols, dtype=np.int32)
    for s in range(s_n):
        rows = slice(s * mpl, (s + 1) * mpl)
        c = ell_cols[rows]
        o = c // mpl
        out = np.where(o == s, c - s * mpl, 0).astype(np.int64)
        for q in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            sel = o == q
            if cq.size and np.any(sel):
                # padding (zero-value) slots may name off-shard columns
                # absent from cq: clamp them into the buffer (value zero)
                pos = np.minimum(np.searchsorted(cq, c[sel]), cq.size - 1)
                out[sel] = mpl + q * h + pos
            elif np.any(sel):
                out[sel] = 0
        cols_local[rows] = out.astype(np.int32)
    return HaloPlan(h=h, send_idx=send_idx, cols_local=cols_local,
                    comm_rows=comm_rows)


@dataclass(frozen=True)
class BlockHaloPlan:
    """Static neighbour-exchange schedule of the block-ELL SpMM over several
    shards (``prealps_tpu/core/layout.py::BlockHaloPlan``): ``HaloPlan`` at
    the granularity of bk-row X blocks. Each shard packs the blocks its
    neighbours reference (``send_idx``), one all-to-all moves the packs, and
    the shard's block columns are remapped into [own blocks ∥ halo buffer]
    block coordinates (``blkcols_local``)."""

    hb: int                     # blocks per (src, dst) slot (max over pairs)
    send_idx: np.ndarray        # (S, S, hb) int32: local blocks s packs for d
    blkcols_local: np.ndarray   # (nrb, s_max) int32 in local+halo block space
    comm_blocks: int            # true (unpadded) total blocks exchanged


def build_block_halo_plan(layout: RowLayout, blkcols: np.ndarray,
                          blocks: np.ndarray, bk: int) -> BlockHaloPlan:
    """The exchange schedule of the padded block-ELL structure: ``blkcols``
    (nrb, s_max) global bk-column-block ids and ``blocks`` their value
    blocks (all-zero blocks mark padding slots, left out of the scan).
    Raises unless rows_per_shard is a multiple of bk, so that no X block
    straddles two shards."""
    s_n = layout.nshards
    mpl = layout.rows_per_shard
    if mpl % bk:
        raise ValueError(f"rows_per_shard={mpl} not a multiple of bk={bk}")
    nblk_loc = mpl // bk
    nrb_tot, s_max = blkcols.shape
    nrb_loc = nrb_tot // s_n
    used = np.asarray(blocks).reshape(nrb_tot, s_max, -1).any(axis=2)
    owner_of = blkcols // nblk_loc

    needed = [[None] * s_n for _ in range(s_n)]  # needed[s][q]: global blocks
    hb = 1
    comm_blocks = 0
    for s in range(s_n):
        rows = slice(s * nrb_loc, (s + 1) * nrb_loc)
        cb_s = blkcols[rows][used[rows]]
        own = owner_of[rows][used[rows]]
        for q in range(s_n):
            if q == s:
                continue
            cq = np.unique(cb_s[own == q])
            needed[s][q] = cq
            hb = max(hb, cq.size)
            comm_blocks += cq.size

    send_idx = np.zeros((s_n, s_n, hb), dtype=np.int32)
    for q in range(s_n):
        for s in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            send_idx[q, s, : cq.size] = (cq - q * nblk_loc).astype(np.int32)

    blkcols_local = np.zeros_like(blkcols, dtype=np.int32)
    for s in range(s_n):
        rows = slice(s * nrb_loc, (s + 1) * nrb_loc)
        c = blkcols[rows]
        o = c // nblk_loc
        out = np.where(o == s, c - s * nblk_loc, 0).astype(np.int64)
        for q in range(s_n):
            if q == s:
                continue
            cq = needed[s][q]
            sel = o == q
            if cq.size and np.any(sel):
                # padding (all-zero) slots may name off-shard blocks absent
                # from cq: clamp them into the buffer (values zero)
                pos = np.minimum(np.searchsorted(cq, c[sel]), cq.size - 1)
                out[sel] = nblk_loc + q * hb + pos
            elif np.any(sel):
                out[sel] = 0
        blkcols_local[rows] = out.astype(np.int32)
    return BlockHaloPlan(hb=hb, send_idx=send_idx, blkcols_local=blkcols_local,
                         comm_blocks=comm_blocks)
