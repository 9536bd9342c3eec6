"""spMSV: sparse matrix × sparse multivector product with structure tracking.

Counterpart of ``prealps_tpu/ops/spmsv.py`` (reference:
utils/iterativeKernels/spMSV.c preAlps_spMSV — C = A·B for a sparse block
multivector B; the routine tracks the block structure of B and C, skips
empty blocks and switches C to dense when it fills in; used to build
s-step / CA Krylov bases, not by ECG).

Two forms, as in the JAX package:

* the dense carrier: values (n, t) dense, the BLOCK STRUCTURE tracked
  exactly as the reference's ABlockStruct contract (spMSV.h:57-60):
  ``block_support_graph`` is the precomputed block graph, ``spmsv`` masks
  B's dead blocks, applies A (any panel operator, such as the block-ELL
  kernel) and predicts C's support and the sparse→dense switch;
  ``spmsv_chain`` builds [B, AB, A²B, …] and stops masking once dense;
* the packed form: only B's active row blocks are stored
  (``pack_multivector``: ids (cap,) and values (cap, bs, t), -1 a dead
  slot) and only C's active row blocks are computed (``spmsv_packed`` on a
  square-block ``BlockEllMatrix``; its device part alone,
  ``spmsv_packed_device``): one gather of A's active block rows, one
  gather of B's referenced blocks, one batched contraction, so bytes and
  flops follow the active fraction.

The support helpers (``block_support_graph``, ``propagate_support``,
``predict_c_support``) are numpy/scipy copies of the JAX package's,
bitwise.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def block_support_graph(a: sp.spmatrix, offsets: np.ndarray) -> sp.csr_matrix:
    """Block connectivity graph: G[i, j] = 1 iff block row i of A has a
    nonzero in block column j (blocks given by `offsets`) — the
    ABlockStruct the reference requires precomputed (spMSV.h:57-60)."""
    a = sp.csr_matrix(a)
    nb = len(offsets) - 1
    coo = a.tocoo()
    rb = np.searchsorted(offsets, coo.row, side="right") - 1
    cb = np.searchsorted(offsets, coo.col, side="right") - 1
    g = sp.coo_matrix((np.ones_like(rb), (rb, cb)), shape=(nb, nb))
    g = (g.tocsr() > 0).astype(np.int8)
    return g


def propagate_support(g: sp.csr_matrix, support: np.ndarray, steps: int = 1) -> np.ndarray:
    """Support after `steps` applications: struct(G^steps · support).

    support: (nb,) or (nb, k) boolean; returns the same shape."""
    s = support.astype(np.int8)
    for _ in range(steps):
        s = np.asarray((g @ s) > 0, dtype=np.int8)
    return s.astype(bool)


def predict_c_support(g: sp.csr_matrix, b_ids, nb: int) -> np.ndarray:
    """Active C block rows = struct(G) · support(B) (host metadata)."""
    s = np.zeros(nb, dtype=np.int8)
    ids = np.asarray(b_ids)
    s[ids[ids >= 0]] = 1
    return np.flatnonzero(np.asarray((g @ s) > 0))


def spmsv(a_apply, b: torch.Tensor, b_struct: np.ndarray,
          a_block_struct: sp.spmatrix, row_offsets: np.ndarray,
          col_offsets: np.ndarray | None = None, dense_switch: float = 0.5):
    """C = A·B for a block-sparse multivector B with structure tracking.

    b: (n, t) dense carrier. b_struct: host boolean, either (nbr,) — one
    support flag per block row, all columns alike — or (nbr, nbc) with
    col_offsets giving B's column blocks (the reference's b_ncolparts,
    spMSV.h:53-55). a_block_struct: block graph of A (block_support_graph).

    Returns (c, c_struct, is_dense):
      c        = A · (B restricted to its support), (n, t);
      c_struct = predicted support of C (same shape class as b_struct) —
                 struct(A)·struct(B), exact for generic values;
      is_dense = True when c_struct's fill ratio ≥ dense_switch — the
                 reference's sparse→dense switch (spMSV.h return code 1);
                 callers should stop masking from then on.
    """
    n, t = b.shape
    b_struct = np.asarray(b_struct)
    row_sizes = torch.from_numpy(np.diff(row_offsets)).to(b.device)
    flags = torch.from_numpy(b_struct.astype(np.float64)).to(b.device, b.dtype)
    mask = torch.repeat_interleave(flags, row_sizes, dim=0, output_size=n)
    if b_struct.ndim == 1:
        mask = mask[:, None]
    else:
        if col_offsets is None:
            raise ValueError("a 2-D b_struct needs col_offsets")
        col_sizes = torch.from_numpy(np.diff(col_offsets)).to(b.device)
        mask = torch.repeat_interleave(mask, col_sizes, dim=1, output_size=t)
    c = a_apply(b * mask)
    c_struct = propagate_support(sp.csr_matrix(a_block_struct), b_struct)
    is_dense = bool(np.mean(c_struct) >= dense_switch)
    return c, c_struct, is_dense


def spmsv_chain(a_apply, b: torch.Tensor, b_struct: np.ndarray,
                a_block_struct: sp.spmatrix, row_offsets: np.ndarray, steps: int,
                col_offsets: np.ndarray | None = None, dense_switch: float = 0.5):
    """s-step basis build: [B, AB, A²B, …] with structure tracking; masking
    is dropped once the support fills in (the dense regime). Returns
    (panels list, structs list)."""
    panels, structs = [b], [np.asarray(b_struct)]
    cur, cur_struct = b, np.asarray(b_struct)
    dense = False
    for _ in range(steps):
        if dense:
            cur = a_apply(cur)
            cur_struct = np.ones_like(cur_struct)
        else:
            cur, cur_struct, dense = spmsv(
                a_apply, cur, cur_struct, a_block_struct, row_offsets,
                col_offsets, dense_switch)
        panels.append(cur)
        structs.append(cur_struct)
    return panels, structs


def pack_multivector(b: torch.Tensor, bs: int, ids: np.ndarray, cap: int):
    """(n, t) dense -> (ids (cap,) int32, vals (cap, bs, t)) active row
    blocks, on b's device.

    ids: host int array of active block rows (sorted, unique), len ≤ cap.
    """
    n, t = b.shape
    ids_pad = np.full(cap, -1, dtype=np.int32)
    ids_pad[: len(ids)] = np.asarray(ids, dtype=np.int32)
    bb = b.reshape(n // bs, bs, t)
    gather = torch.from_numpy(np.where(ids_pad >= 0, ids_pad, 0).astype(np.int64))
    live = torch.from_numpy(ids_pad >= 0).to(b.device, b.dtype)
    vals = bb[gather.to(b.device)] * live[:, None, None]
    return torch.from_numpy(ids_pad).to(b.device), vals


def unpack_multivector(ids: torch.Tensor, vals: torch.Tensor, nb: int) -> torch.Tensor:
    """Packed blocks -> dense (nb*bs, t) (dead slots ignored): an
    ``index_add_`` into nb + 1 blocks, the last one the dead slots' sink
    (JAX's ``.at[].add``)."""
    _, bs, t = vals.shape
    out = torch.zeros((nb + 1, bs, t), dtype=vals.dtype, device=vals.device)
    idx = torch.where(ids >= 0, ids, nb).long()
    out.index_add_(0, idx, vals)
    return out[:nb].reshape(nb * bs, t)


def spmsv_packed(ab, b_ids: torch.Tensor, b_vals: torch.Tensor,
                 c_ids: np.ndarray, cap_c: int):
    """Packed C = A·B on active blocks only.

    ab: BlockEllMatrix with bm == bk == bs (``formats.csr_to_block_ell``;
    its dense ``blocks`` are the operand); b_ids/b_vals: packed B
    (``pack_multivector``); c_ids: host prediction of C's active block
    rows (``predict_c_support`` — generically exact); returns (c_ids_dev
    (cap_c,) int32, c_vals (cap_c, bs, t)).

    FLOPs = cap_c · S · bs² · t (vs nb · S · bs² · t dense): the saving is
    the active fraction. The ids go to the device padded with -1 (dead
    slots), then ``spmsv_packed_device`` computes.
    """
    c_ids_pad = np.full(cap_c, -1, dtype=np.int32)
    c_ids_pad[: len(c_ids)] = np.asarray(c_ids, dtype=np.int32)
    c_ids_d = torch.from_numpy(c_ids_pad).to(b_vals.device)
    return c_ids_d, spmsv_packed_device(ab, b_ids, b_vals, c_ids_d)


def spmsv_packed_device(ab, b_ids: torch.Tensor, b_vals: torch.Tensor,
                        c_ids_d: torch.Tensor) -> torch.Tensor:
    """The device part of ``spmsv_packed``, with C's padded block ids
    (cap_c,) already on the device: no host transfer, so a caller can time
    it by device time. One gather of A's active block rows, one gather of
    B's referenced blocks (slots of dead or absent block columns read a
    zero block), one batched contraction ``csmk,cskt->cmt``; returns
    c_vals (cap_c, bs, t), dead slots zero."""
    nrb, _, bs, bs2 = ab.blocks.shape
    if bs != bs2:
        raise ValueError("spmsv_packed needs square blocks (bm == bk)")
    dev = b_vals.device
    cap_b, _, t = b_vals.shape
    c_gather = torch.where(c_ids_d >= 0, c_ids_d, 0).long()

    # slot of each block column in B's packed buffer; absent -> cap_b (a
    # zero block). Dead slots write cap_b to the sink nrb, so the sink keeps
    # it without a write from the host (which would synchronise the stream)
    live = b_ids >= 0
    posmap = torch.full((nrb + 1,), cap_b, dtype=torch.long, device=dev)
    posmap[torch.where(live, b_ids, nrb).long()] = torch.where(
        live, torch.arange(cap_b, device=dev), cap_b)

    blk = ab.blocks[c_gather]                          # (cap_c, S, bs, bs)
    cols = ab.blkcols[c_gather].long()                 # (cap_c, S)
    pos = posmap[torch.clamp(cols, max=nrb)]           # (cap_c, S)
    b_ext = torch.cat([b_vals, b_vals.new_zeros((1, bs, t))], dim=0)
    gathered = b_ext[pos]                              # (cap_c, S, bs, t)
    c_vals = torch.einsum("csmk,cskt->cmt", blk, gathered)
    return c_vals * (c_ids_d >= 0)[:, None, None].to(c_vals.dtype)
