"""Row layouts: how a global sparse operator maps onto padded device rows.

The stencil subset of ``prealps_tpu/core/layout.py``, copied in numpy: a
``RowLayout`` records the row permutation and the padding that makes every
shard's row panel a multiple of the block sizes. Padded rows carry an
identity diagonal, so the operator stays SPD and padded solution entries
are exactly zero; with a stencil operator the padded nodes' blocks are zero
off the diagonal, which is what makes the single-shard wrap halo of the
stencil SpMM exact (parallel/driver.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp


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
