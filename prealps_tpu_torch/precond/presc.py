"""PRESC on a general sparse matrix: Schur preconditioner with local Schur
deflation, the single-device build.

The PyTorch counterpart of ``prealps_tpu/precond/presc.py`` (reference:
src/preconditioners/presc.c, presc_eigsolve.c). The apply is LORASC's
(``precond/lorasc.py::Lorasc``); the deflation pencil differs:

* SSLOC: S u = λ Sloc u, Sloc = blockdiag of the exact local Schur
  complements Sloc_p = Agg_pp − Agi_p Aii_p⁻¹ Aig_p of each part's owned
  separator rows, by host sparse solves (``schur_method="dense"``) or by
  the batched block-banded partial factorization on ``device``
  (``"banded"``, ``direct/banded.py::block_banded_schur``);
* SALOC: S u = λ Aloc u, Aloc = blockdiag(Agg_pp).

As in the JAX package, σᵢ = (tol − λᵢ)/λᵢ (the reference leaves PRESC's
weights unassigned), and the separator rows are regrouped by the part
that owns them.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from prealps_tpu_torch.config import resolve_device
from prealps_tpu_torch.core.partition import (
    BlockArrowStruct,
    block_arrow_structure,
    permute,
    rcm_order,
)
from prealps_tpu_torch.direct.subdomain import DenseCholesky, build_block_solver
from prealps_tpu_torch.ops.formats import csr_to_ell
from prealps_tpu_torch.precond.lorasc import (
    Lorasc,
    arrow_blocks,
    deflation_pairs,
    schur_complement_dense,
)


def separator_owners(ap: sp.csr_matrix, arrow: BlockArrowStruct) -> np.ndarray:
    """The part each separator row couples to most strongly (ties to the
    lower part id; rows with no interior coupling to part 0)."""
    ni, n = arrow.sep_start, arrow.n
    k = arrow.nparts
    off = arrow.interior_offsets
    owners = np.zeros(n - ni, dtype=np.int64)
    agi = ap[ni:, :ni].tocsr()
    for i in range(n - ni):
        cols = agi.indices[agi.indptr[i]: agi.indptr[i + 1]]
        if cols.size == 0:
            continue
        parts = np.searchsorted(off, cols, side="right") - 1
        owners[i] = int(np.argmax(np.bincount(parts, minlength=k)))
    return owners


def _sep_offsets(sep_owner, k):
    return np.concatenate([[0], np.cumsum(np.bincount(sep_owner, minlength=k))])


def local_schur_complements(ap: sp.csr_matrix, arrow: BlockArrowStruct, sep_owner):
    """Exact local Schur complements Sloc_p (dense, host sparse solves),
    separator grouped by owner. Returns (blocks list, sep_offsets)."""
    ni = arrow.sep_start
    off = arrow.interior_offsets
    blocks = []
    for p in range(arrow.nparts):
        rows = np.flatnonzero(sep_owner == p) + ni
        i0, i1 = int(off[p]), int(off[p + 1])
        agg_pp = ap[rows][:, rows].toarray()
        if rows.size == 0:
            blocks.append(np.zeros((0, 0)))
            continue
        aig_p = ap[i0:i1, rows]
        agi_p = ap[rows, i0:i1]
        if i1 > i0 and aig_p.nnz:
            w = spla.spsolve(ap[i0:i1, i0:i1].tocsc(), aig_p.tocsc())
            if sp.issparse(w):
                w = w.toarray()
            w = np.atleast_2d(np.asarray(w))
            if w.shape[0] != i1 - i0:
                w = w.T
            s = agg_pp - agi_p @ w
        else:
            s = agg_pp
        blocks.append(0.5 * (s + s.T))
    return blocks, _sep_offsets(sep_owner, arrow.nparts)


def local_schur_complements_banded(ap: sp.csr_matrix, arrow: BlockArrowStruct,
                                   sep_owner, dtype=np.float64, device="cpu"):
    """The exact local Schur complements by the batched block-banded
    partial factorization on ``device`` (the role of MKL-PARDISO's
    iparm[35]=2). Each part's rows are laid out [interior (RCM), pad,
    separator, pad]; identity padding rows decouple, so the sep×sep window
    of the Schur complement onto the trailing block is Sloc_p. Same return
    contract as ``local_schur_complements``."""
    ni_all = arrow.sep_start
    off = arrow.interior_offsets
    k = arrow.nparts
    part_rows, ni_p, ns_p = [], [], []
    for p in range(k):
        srows = np.flatnonzero(sep_owner == p) + ni_all
        irows = np.arange(int(off[p]), int(off[p + 1]))
        sub_i = ap[irows][:, irows]
        pi = rcm_order(sub_i) if irows.size > 2 else np.arange(irows.size)
        part_rows.append(np.concatenate([irows[pi], srows]))
        ni_p.append(irows.size)
        ns_p.append(srows.size)
    ni_max, ns_max = max(ni_p), max(max(ns_p), 1)

    def positions(p):   # interior i -> i, separator j -> ni_max + j
        return np.concatenate([np.arange(ni_p[p]), ni_max + np.arange(ns_p[p])])

    bw = 1
    for p in range(k):
        pos = positions(p)
        sub = ap[part_rows[p]][:, part_rows[p]].tocoo()
        if sub.nnz:
            bw = max(bw, int(np.abs(pos[sub.row] - pos[sub.col]).max()))
    # the Schur window inside the trailing block: ns_max ≤ n_schur ≤ bs
    bs = -(-max(bw, ns_max) // 8) * 8
    while True:
        nblk = ni_max // bs + 1
        n_schur = nblk * bs - ni_max
        if n_schur >= ns_max and n_schur <= bs and bs >= bw:
            break
        bs += 8
    rows_padded = nblk * bs

    d = np.zeros((k, nblk, bs, bs), dtype=dtype)
    e = np.zeros((k, nblk, bs, bs), dtype=dtype)
    for p in range(k):
        pos = positions(p)
        sub = ap[part_rows[p]][:, part_rows[p]].tocoo()
        r, c = pos[sub.row], pos[sub.col]
        rb, cb = r // bs, c // bs
        same = rb == cb
        np.add.at(d[p], (rb[same], r[same] % bs, c[same] % bs), sub.data[same])
        # the lower couplings only: each upper entry's partner is in the COO
        low = rb == cb + 1
        np.add.at(e[p], (rb[low], r[low] % bs, c[low] % bs), sub.data[low])
        padr = np.setdiff1d(np.arange(rows_padded), pos)
        d[p, padr // bs, padr % bs, padr % bs] = 1.0

    from prealps_tpu_torch.direct.banded import block_banded_schur

    schur, bad = block_banded_schur(torch.from_numpy(d).to(device),
                                    torch.from_numpy(e).to(device), n_schur)
    if bad:
        raise RuntimeError("banded partial factorization failed (not SPD?)")
    schur = schur.cpu().numpy().astype(np.float64)
    base = ni_max - (rows_padded - n_schur)
    blocks = []
    for p in range(k):
        s = schur[p, base: base + ns_p[p], base: base + ns_p[p]]
        blocks.append(0.5 * (s + s.T))
    return blocks, _sep_offsets(sep_owner, k)


def build_presc(
    a: sp.spmatrix,
    nparts: int = 8,
    deflation_tol: float = 1e-2,
    max_deflation: int = 64,
    eigs_kind: str = "ssloc",        # ssloc | saloc
    eig_method: str = "direct",      # direct | lanczos
    schur_method: str = "dense",     # dense (host) | banded (device)
    lanczos_ncv: int | None = None,
    arrow: BlockArrowStruct | None = None,
    dtype=None,
    device="cuda",
):
    """PRESC for A (original ordering). Returns (precond, arrow') where
    arrow' carries the final permutation (separator regrouped by owner)."""
    dev = resolve_device(device)
    a = sp.csr_matrix(a)
    dtype = np.dtype(dtype) if dtype is not None else a.dtype
    if arrow is None:
        arrow = block_arrow_structure(a, nparts)
    ap = permute(a, arrow.perm)
    ni, n = arrow.sep_start, arrow.n

    owner = separator_owners(ap, arrow)
    sep_order = np.argsort(owner, kind="stable")
    perm2 = np.concatenate([np.arange(ni), ni + sep_order])
    ap = permute(ap, perm2)
    arrow = BlockArrowStruct(perm=arrow.perm[perm2],
                             interior_offsets=arrow.interior_offsets,
                             sep_start=ni, n=n, part=arrow.part)
    owner = owner[sep_order]
    aii, aig, agi, agg = arrow_blocks(ap, ni)

    aii_solver = build_block_solver(aii, arrow.interior_offsets, dtype=dtype,
                                    device=dev)
    agg_solver = DenseCholesky.build(agg, dtype=dtype, device=dev)

    s_dense = schur_complement_dense(aii, aig, agi, agg)
    if eigs_kind == "ssloc":
        if schur_method == "banded":
            blocks, _ = local_schur_complements_banded(ap, arrow, owner,
                                                       dtype=np.float64, device=dev)
        elif schur_method == "dense":
            blocks, _ = local_schur_complements(ap, arrow, owner)
        else:
            raise ValueError(f"unknown schur_method {schur_method!r}")
    elif eigs_kind == "saloc":
        sep_off = _sep_offsets(owner, arrow.nparts)
        blocks = [agg[sep_off[p]: sep_off[p + 1], sep_off[p]: sep_off[p + 1]].toarray()
                  for p in range(arrow.nparts)]
    else:
        raise ValueError(f"unknown eigs_kind {eigs_kind!r}")
    b_dense = scipy.linalg.block_diag(*[b for b in blocks if b.size])

    # B must be SPD; guard small indefiniteness from disconnected parts
    b_dense = b_dense + 1e-12 * np.eye(b_dense.shape[0]) * max(b_dense.diagonal().max(), 1)
    if eig_method == "direct":
        lam, vecs = scipy.linalg.eigh(s_dense, b_dense)
    elif eig_method == "lanczos":
        # matrix-free generalized Lanczos on OP = B⁻¹S in the B-inner
        # product, in f64 (the PARPACK mode-2 role)
        from prealps_tpu_torch.ops.lanczos import lanczos_gen

        ng = s_dense.shape[0]
        b_chol = np.linalg.cholesky(b_dense)
        binv_s = torch.from_numpy(
            np.linalg.solve(b_chol.T, np.linalg.solve(b_chol, s_dense))).to(dev)
        b_t = torch.from_numpy(b_dense).to(dev)
        res = lanczos_gen(lambda v: binv_s @ v, lambda v: b_t @ v, ng,
                          lanczos_ncv or min(ng, 2 * max_deflation + 1),
                          dtype=torch.float64, device=dev)
        lam, vecs = res.eigvalues.cpu().numpy(), res.eigvectors.cpu().numpy()
    else:
        raise ValueError(f"unknown eig_method {eig_method!r}")
    e_mat, sigma = deflation_pairs(lam, vecs, n - ni, deflation_tol, max_deflation)

    precond = Lorasc(
        aii_solver=aii_solver, agg_solver=agg_solver,
        aig=csr_to_ell(aig, dtype=dtype, device=dev),
        agi=csr_to_ell(agi, dtype=dtype, device=dev),
        e_mat=torch.from_numpy(np.asarray(e_mat, dtype=dtype)).to(dev),
        sigma=torch.from_numpy(np.asarray(sigma, dtype=dtype)).to(dev),
        ni=ni, ng=n - ni)
    return precond, arrow
