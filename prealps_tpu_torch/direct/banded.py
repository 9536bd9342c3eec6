"""Batched block-banded Cholesky: the subdomain direct solver of LORASC.

The PyTorch counterpart of ``prealps_tpu/direct/banded.py:49-419``. After a
bandwidth-reducing ordering (``plan_block_banded``: per-part RCM and a
uniform block size, host numpy, with ``assemble_host`` and
``to_band``/``from_band``) each subdomain matrix is block-tridiagonal with
bs×bs blocks (D_i diagonal, E_i subdiagonal), factored batched over the P
subdomains, block by block:

    M_i = E_i L_{i-1}⁻ᵀ ;  S_i = D_i − M_i M_iᵀ ;  L_i = chol(S_i)

with L_i⁻¹ stored explicitly so that the solves are GEMMs only:

    forward:   y_i = L_i⁻¹ (v_i − M_i y_{i-1})
    backward:  w_i = L_i⁻ᵀ (y_i − M_{i+1}ᵀ w_{i+1})

The ``lax.scan`` recurrences become Python loops over the nblk blocks of
batched ``torch.matmul`` (the JAX package leaves these einsums to XLA).
``cholesky(symmetrize_input=True)`` becomes a symmetrisation and
``torch.linalg.cholesky_ex``; a failed factor (or a non-finite inverse) in
any subdomain zeroes that block's inverses and sets ``failed``, as the JAX
version's NaN mapping does.

The two-level solve (``prepare_two_level``, ``block_banded_solve_two_level``)
shares each step's GEMMs between the L ranks of a process group, each
holding bs/L rows of every factor block: one all-gather in the group per
block step, forward and backward (the distributed LORASC's interior
solves). ``block_banded_schur`` is the factor recursion stopped one block
early plus one dense Schur complement on the last block: the exact Schur
complement onto the trailing rows, which PRESC's banded local Schur
complements (``precond/presc.py``) take.

The factors may be stored in bf16 (LORASC's ``factor_store="bf16"``) while
the vectors stay f32. The solves then compute what the JAX package's mixed
einsum computes: each block's factor is widened to the vector's type
(exactly) inside the recursion, and the products, sums and output are in
the vector's type. Widening one block at a time keeps the bf16 factors the
only stored copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.core.partition import rcm_order
from prealps_tpu_torch.parallel.mesh import all_gather, size_of


# --- host planning (numpy copies, bitwise the JAX package's) ---------------


@dataclass(frozen=True)
class BandPlan:
    """A batched block-banded system: nparts subdomains, each padded to
    nblk·bs rows. ``perm[p]`` maps band position -> part-local row (-1 on
    padding), ``inv_perm[p]`` part-local row -> band position (the padding
    tail maps to itself); ``bandwidth`` is the largest half-bandwidth after
    ordering (≤ bs)."""

    nparts: int
    nblk: int
    bs: int
    bandwidth: int
    perm: np.ndarray
    inv_perm: np.ndarray
    sizes: np.ndarray

    @property
    def rows_padded(self) -> int:
        return self.nblk * self.bs


def plan_block_banded(blocks: list, bs: int | None = None, order: str = "rcm",
                      bs_multiple: int = 8) -> BandPlan:
    """Per block a bandwidth-reducing ordering (RCM, or "natural"), and one
    block size for all: the largest bandwidth rounded up to
    ``bs_multiple`` unless ``bs`` is given."""
    nparts = len(blocks)
    perms = []
    bandwidth = 1
    sizes = np.array([b.shape[0] for b in blocks], dtype=np.int64)
    for b in blocks:
        b = sp.csr_matrix(b)
        m = b.shape[0]
        p = rcm_order(b) if (order == "rcm" and m > 2) else np.arange(m)
        coo = b[p][:, p].tocoo()
        if coo.nnz:
            bandwidth = max(bandwidth, int(np.abs(coo.row - coo.col).max()))
        perms.append(p)
    if bs is None:
        bs = -(-max(bandwidth, 1) // bs_multiple) * bs_multiple
    bs = max(bs, bs_multiple)
    if bandwidth > bs:
        raise ValueError(f"bandwidth {bandwidth} exceeds block size {bs}")
    nblk = max(1, -(-int(sizes.max()) // bs))
    rows = nblk * bs
    perm = np.full((nparts, rows), -1, dtype=np.int64)
    inv_perm = np.zeros((nparts, rows), dtype=np.int64)
    for i, p in enumerate(perms):
        m = p.shape[0]
        perm[i, :m] = p
        inv = np.empty(m, dtype=np.int64)
        inv[p] = np.arange(m)
        inv_perm[i, :m] = inv
        inv_perm[i, m:] = np.arange(m, rows)
    return BandPlan(nparts=nparts, nblk=nblk, bs=bs, bandwidth=bandwidth,
                    perm=perm, inv_perm=inv_perm, sizes=sizes)


def assemble_host(plan: BandPlan, blocks: list, dtype=np.float64, parts=None):
    """(D, E) numpy arrays of the subdomain matrices, (P, nblk, bs, bs)
    each: the full symmetric diagonal blocks and the subdiagonal blocks
    (E[:, 0] = 0), the padding rows an identity diagonal. ``parts`` picks
    the subdomains to assemble (default all), in that order: a rank
    assembles only its own."""
    parts = range(plan.nparts) if parts is None else list(parts)
    nblk, bs = plan.nblk, plan.bs
    d = np.zeros((len(parts), nblk, bs, bs), dtype=dtype)
    e = np.zeros((len(parts), nblk, bs, bs), dtype=dtype)
    for k, i in enumerate(parts):
        b = blocks[i]
        m = b.shape[0]
        p = plan.perm[i, :m]
        coo = sp.csr_matrix(b)[p][:, p].tocoo()
        rb, cb = coo.row // bs, coo.col // bs
        rl, cl = coo.row % bs, coo.col % bs
        same = rb == cb
        np.add.at(d[k], (rb[same], rl[same], cl[same]), coo.data[same])
        sub = rb == cb + 1
        np.add.at(e[k], (rb[sub], rl[sub], cl[sub]), coo.data[sub])
        pad = np.arange(m, plan.rows_padded)
        d[k, pad // bs, pad % bs, pad % bs] = 1.0
    return d, e


def to_band(plan: BandPlan, parts: list) -> np.ndarray:
    """Per-part vectors or panels -> the (P, nblk, bs, t) band layout."""
    t = parts[0].shape[1] if parts[0].ndim > 1 else 1
    out = np.zeros((plan.nparts, plan.rows_padded, t))
    for i, v in enumerate(parts):
        v2 = v.reshape(v.shape[0], -1)
        out[i, : v2.shape[0]] = v2[plan.perm[i, : v2.shape[0]]]
    return out.reshape(plan.nparts, plan.nblk, plan.bs, t)


def from_band(plan: BandPlan, w) -> list:
    """(P, nblk, bs, t) -> per-part (m, t) panels in the caller's order."""
    w = np.asarray(w).reshape(plan.nparts, plan.rows_padded, -1)
    outs = []
    for i in range(plan.nparts):
        m = int(plan.sizes[i])
        out = np.empty((m, w.shape[2]))
        out[plan.perm[i, :m]] = w[i, :m]
        outs.append(out)
    return outs


# --- device: factorization and solves --------------------------------------


@dataclass
class BlockBandedCholesky:
    """Factored batched block-banded SPD matrix (see module docstring)."""

    l_inv: torch.Tensor   # (P, nblk, bs, bs) inverted diagonal Cholesky factors
    m_off: torch.Tensor   # (P, nblk, bs, bs) subdiagonal factors, M[0] = 0
    failed: torch.Tensor  # () bool: some block failed to factor

    def solve(self, v: torch.Tensor) -> torch.Tensor:
        """v: (P, nblk, bs, t) -> (P, nblk, bs, t)."""
        return block_banded_solve(self, v)


def block_banded_cholesky(d: torch.Tensor, e: torch.Tensor,
                          shift: float = 0.0) -> BlockBandedCholesky:
    """Factor the batched block-banded matrix given by (D, E).

    ``shift`` adds shift·diag(D_i) before factoring (the f32 builds retry
    with growing shifts when a factor fails)."""
    P, nblk, bs, _ = d.shape
    dtype, dev = d.dtype, d.device
    if shift:
        d = d + shift * torch.diag_embed(torch.diagonal(d, dim1=-2, dim2=-1))
    eye = torch.eye(bs, dtype=dtype, device=dev).expand(P, bs, bs)
    l_inv = torch.empty_like(d)
    m_off = torch.empty_like(d)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    l_prev = torch.zeros((P, bs, bs), dtype=dtype, device=dev)
    for i in range(nblk):
        m_i = e[:, i] @ l_prev.mT
        s_i = d[:, i] - m_i @ m_i.mT
        l_i, info = torch.linalg.cholesky_ex(0.5 * (s_i + s_i.mT))
        ok = info == 0
        l_i = torch.where(ok[:, None, None], l_i, eye)
        inv = torch.linalg.solve_triangular(l_i, eye, upper=False)
        bad = ~ok.all() | ~torch.isfinite(inv).all()
        l_prev = torch.where(bad, torch.zeros((), dtype=dtype, device=dev), inv)
        l_inv[:, i] = l_prev
        m_off[:, i] = m_i
        failed = failed | bad
    return BlockBandedCholesky(l_inv=l_inv, m_off=m_off, failed=failed)


def block_banded_solve(fac: BlockBandedCholesky, v: torch.Tensor) -> torch.Tensor:
    """Solve A w = v for the factored block-banded A; v: (P, nblk, bs, t)."""
    nblk = v.shape[1]
    l_inv = lambda i: fac.l_inv[:, i].to(v.dtype)
    m_off = lambda i: fac.m_off[:, i].to(v.dtype)
    y = [None] * nblk
    for i in range(nblk):
        rhs = v[:, i] if i == 0 else v[:, i] - m_off(i) @ y[i - 1]
        y[i] = l_inv(i) @ rhs
    w = [None] * nblk
    for i in reversed(range(nblk)):
        rhs = y[i] if i == nblk - 1 else y[i] - m_off(i + 1).mT @ w[i + 1]
        w[i] = l_inv(i).mT @ rhs
    return torch.stack(w, dim=1)


def block_banded_solve_t(fac: BlockBandedCholesky, v3: torch.Tensor) -> torch.Tensor:
    """t-major variant of block_banded_solve: v3 (nblk, P, t, bs), the layout
    of the LORASC sweeps. Same factors, same math."""
    nblk = v3.shape[0]
    l_inv = lambda i: fac.l_inv[:, i].to(v3.dtype)
    m_off = lambda i: fac.m_off[:, i].to(v3.dtype)
    y = [None] * nblk
    for i in range(nblk):
        rhs = v3[i] if i == 0 else v3[i] - y[i - 1] @ m_off(i).mT
        y[i] = rhs @ l_inv(i).mT
    w = [None] * nblk
    for i in reversed(range(nblk)):
        rhs = y[i] if i == nblk - 1 else y[i] - w[i + 1] @ m_off(i + 1)
        w[i] = rhs @ l_inv(i)
    return torch.stack(w, dim=0)


def block_banded_matvec(d: torch.Tensor, e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = A v for the block-banded (D, E) operator; v: (P, nblk, bs, t)."""
    y = d @ v
    y[:, 1:] += e[:, 1:] @ v[:, :-1]
    y[:, :-1] += e[:, 1:].mT @ v[:, 1:]
    return y


# --- two-level: the solve's rows shared by the ranks of a group ------------


@dataclass
class BlockBandedCholesky2L:
    """Block-banded factors folded for the row-shared solve: each step
    needs one all-gather in the group,

      forward:  y_i = L_i⁻¹ v_i − (L_i⁻¹ M_i) y_{i−1}
      backward: w_i = L_i⁻ᵀ y_i − (L_i⁻ᵀ M_{i+1}ᵀ) w_{i+1}

    Each array is (P, nblk, bs, bs), or (P, nblk, bs/L, bs) on a rank that
    holds its rows of a group of L (``rows``)."""

    l_inv: torch.Tensor    # L_i⁻¹
    w_fwd: torch.Tensor    # L_i⁻¹ M_i
    l_inv_t: torch.Tensor  # L_i⁻ᵀ
    w_bwd: torch.Tensor    # L_i⁻ᵀ M_{i+1}ᵀ

    def rows(self, lo: int, hi: int) -> "BlockBandedCholesky2L":
        """The factor rows [lo, hi) of every block, contiguous copies."""
        return BlockBandedCholesky2L(
            *(f[:, :, lo:hi].contiguous() for f in
              (self.l_inv, self.w_fwd, self.l_inv_t, self.w_bwd)))


def prepare_two_level(fac: BlockBandedCholesky) -> BlockBandedCholesky2L:
    """Fold the factors for the row-shared solve (build time)."""
    l_inv, m_off = fac.l_inv, fac.m_off
    m_next = torch.cat([m_off[:, 1:], torch.zeros_like(m_off[:, :1])], dim=1)
    l_inv_t = l_inv.mT
    return BlockBandedCholesky2L(l_inv=l_inv, w_fwd=l_inv @ m_off,
                                 l_inv_t=l_inv_t.contiguous(),
                                 w_bwd=l_inv_t @ m_next.mT)


def block_banded_solve_two_level(fac2: BlockBandedCholesky2L, v: torch.Tensor,
                                 group=None) -> torch.Tensor:
    """Solve with the factors' rows shared over ``group`` (None: one rank,
    all rows). fac2's arrays hold this rank's bs/L rows, (P, nblk, bs/L,
    bs); v is the whole (P, nblk, bs, t), the same on every rank of the
    group; returns the whole solution on every rank, after one all-gather
    in the group per block step."""
    nblk = v.shape[1]
    shared = size_of(group) > 1

    def gather(chunk):
        return all_gather(chunk, group, dim=1) if shared else chunk

    prev = torch.zeros_like(v[:, 0])
    y = [None] * nblk
    for i in range(nblk):
        prev = gather(fac2.l_inv[:, i] @ v[:, i] - fac2.w_fwd[:, i] @ prev)
        y[i] = prev
    w = [None] * nblk
    nxt = torch.zeros_like(v[:, 0])
    for i in reversed(range(nblk)):
        nxt = gather(fac2.l_inv_t[:, i] @ y[i] - fac2.w_bwd[:, i] @ nxt)
        w[i] = nxt
    return torch.stack(w, dim=1)


# --- partial factorization with Schur output --------------------------------


def _chol_flagged(s: torch.Tensor):
    """Lower Cholesky factor of sym(s) with a per-batch failure flag; a
    failed factor is zeroed (the JAX version's NaN mapping)."""
    l, info = torch.linalg.cholesky_ex(0.5 * (s + s.mT))
    ok = (info == 0)[:, None, None]
    return torch.where(ok, l, torch.zeros_like(l)), bool((info != 0).any())


def block_banded_schur(d: torch.Tensor, e: torch.Tensor, n_schur: int,
                       shift: float = 0.0):
    """Exact Schur complement of the batched block-banded SPD matrix (D, E)
    onto its trailing n_schur rows (0 < n_schur ≤ bs: the Schur rows live
    in the last block). The factor recursion runs over the leading nblk − 1
    blocks, corrects the last diagonal block, and one dense Schur
    complement of that block onto its trailing rows follows.

    Returns (schur, failed): schur (P, n_schur, n_schur), symmetric, and
    whether a factor failed (not SPD)."""
    P, nblk, bs, _ = d.shape
    if not (0 < n_schur <= bs):
        raise ValueError(f"n_schur must be in (0, {bs}], got {n_schur}")
    dtype, dev = d.dtype, d.device
    if shift:
        d = d + shift * torch.diag_embed(torch.diagonal(d, dim1=-2, dim2=-1))
    eye = torch.eye(bs, dtype=dtype, device=dev).expand(P, bs, bs)
    bad = False
    l_inv_prev = torch.zeros((P, bs, bs), dtype=dtype, device=dev)
    for i in range(nblk - 1):
        m_i = e[:, i] @ l_inv_prev.mT
        l_i, fail = _chol_flagged(d[:, i] - m_i @ m_i.mT)
        bad |= fail
        l_inv_prev = torch.linalg.solve_triangular(l_i, eye, upper=False)
    d_last = d[:, -1]
    if nblk > 1:
        m_last = e[:, -1] @ l_inv_prev.mT
        d_last = d_last - m_last @ m_last.mT
    k = bs - n_schur
    if k == 0:
        schur = d_last
    else:
        l11, fail = _chol_flagged(d_last[:, :k, :k])
        bad |= fail
        w = torch.linalg.solve_triangular(l11, d_last[:, k:, :k].mT, upper=False)
        schur = d_last[:, k:, k:] - w.mT @ w
    return 0.5 * (schur + schur.mT), bad
