"""LORASC at scale: banded interiors + matrix-free device deflation.

The PyTorch counterpart of ``prealps_tpu/precond/lorasc_scale.py``
(reference: src/preconditioners/lorasc.c:95-311 build, :368-618 apply,
lorasc_eigsolve.c:31-205 PARPACK deflation):

* **Interiors** Aii: batched block-banded Cholesky (direct/banded.py) of
  each part after a node-level ordering, assembled on the device by
  scattering the resident stencil blocks into band layout.
* **Separator** Agg: the same machinery with one batch entry.
* **Deflation** S u = λ Agg u: the block thick-restart Lanczos
  (ops/lanczos.py) on the device. S·V needs Aig/Agi products; both come
  from the full stencil SpMM on zero-embedded vectors (interior rows of
  A·(embed_sep v) are Aig·v, separator rows of A·(embed_int z) are Agi·z),
  so every operator product of the build and the apply is the lane-major
  stencil kernel B2a (``ops/spmm.py::stencil_bsr_spmm_t``).
* **PRESC pencils** (``pencil="sloc" | "saloc"``, reference presc.h:18-21):
  S u = λ Sloc u with the exact local Schur complement of each part's
  owned separator rows (SSLOC), or S u = λ Aloc u with Aloc =
  blockdiag(Agg_pp) (SALOC), assembled on the device one part at a time
  (``_build_sloc_operands``).
* **Apply**: in arrow coordinates through node-level gathers while the ECG
  operator stays in the original (stencil) ordering. ``factor_store="bf16"``
  stores the four banded factor tensors in bf16 after every build consumer
  has run in f32; the solves widen them block by block.

Vectors are lane-major (t, br, nrb) panels; node-major intermediates are
flat (nrb + 1, br·t) with a trailing zero node that padding indices point
at. Scatters use ``index_add_`` with int64 indices.

Without ``grid=`` or a pinned partition the parts come from the generic
block-arrow structure of the node graph (``core/partition.py``).
``factor_store="auto"`` keeps the build's type (f32, or f64 in an f64
build), as the JAX rule does on every backend but the TPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.core.gridpart import collapse_to_nodes, grid_box_partition
from prealps_tpu_torch.config import resolve_device
from prealps_tpu_torch.core.partition import block_arrow_structure, rcm_order
from prealps_tpu_torch.direct.banded import (
    BlockBandedCholesky,
    block_banded_cholesky,
    block_banded_matvec,
    block_banded_solve_t,
)
from prealps_tpu_torch.ops.formats import StencilBsrTMatrix, csr_to_stencil_bsr_t
from prealps_tpu_torch.ops.lanczos import (
    block_lanczos_thick_restart,
    lanczos_gen,
    lanczos_thick_restart,
    rayleigh_ritz_refine,
    resolve_block_policy,
)
from prealps_tpu_torch.ops.spmm import stencil_bsr_spmm_t
from prealps_tpu_torch.utils.timing import sync


# ---------------------------------------------------------------------------
# host planning: node-level band layout of interiors and separator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArrowBandPlan:
    """Node-level block-arrow + band layout (host side, all static)."""

    nparts: int
    br: int
    nrb: int
    # interiors
    bs_i: int
    nblk_i: int
    nbn_i: int                 # band node slots per part (= nblk_i*bs_i // br)
    int_nodes: np.ndarray      # (P, nbn_i) node id at band position, nrb = pad
    ni_dof: np.ndarray         # (P,) real interior dofs per part
    # separator
    bs_g: int
    nblk_g: int
    nsn: int                   # real separator nodes
    nsn_pad: int
    sep_nodes: np.ndarray      # (nsn_pad,) node id at band position, nrb = pad
    # per-node maps (device assembly inputs)
    part_arr: np.ndarray       # (nrb,) int32: part id, -1 for separator
    pos_arr: np.ndarray        # (nrb,) int32: band node position within part/sep

    @property
    def ng_pad(self) -> int:
        return self.nsn_pad * self.br

    @property
    def ng(self) -> int:
        return self.nsn * self.br


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def plan_arrow_bands(
    node_graph: sp.csr_matrix,
    node_part: np.ndarray,
    in_sep: np.ndarray,
    nparts: int,
    br: int,
    bs_multiple: int | None = None,
    interior_order: str = "auto",
) -> ArrowBandPlan:
    """Order each interior part and the separator at the node level for a
    small bandwidth and derive uniform static band shapes (numpy copy of the
    JAX planner). interior_order: "natural" keeps each part's lexicographic
    order, "rcm" reorders, "auto" keeps the narrower of the two per part;
    the separator always uses RCM."""
    nrb = node_graph.shape[0]
    mult = bs_multiple or int(np.lcm(8, br))
    part_arr = np.where(in_sep, -1, node_part).astype(np.int32)
    pos_arr = np.zeros(nrb, dtype=np.int32)

    def _bw(sub, perm):
        coo = sub[perm][:, perm].tocoo()
        return int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0

    part_nodes = []
    bw_i = 1
    for p in range(nparts):
        nodes = np.flatnonzero(part_arr == p)
        sub = node_graph[nodes][:, nodes]
        nat = np.arange(nodes.size)
        if interior_order == "natural" or nodes.size <= 2:
            perm, bw_p = nat, _bw(sub, nat)
        elif interior_order == "rcm":
            perm = rcm_order(sub)
            bw_p = _bw(sub, perm)
        else:  # auto
            perm_r = rcm_order(sub)
            bw_r, bw_n = _bw(sub, perm_r), _bw(sub, nat)
            perm, bw_p = (nat, bw_n) if bw_n <= bw_r else (perm_r, bw_r)
        ordered = nodes[perm]
        pos_arr[ordered] = np.arange(nodes.size)
        part_nodes.append(ordered)
        bw_i = max(bw_i, bw_p)
    bs_i = _round_up(bw_i * br + br, mult)
    max_nodes = max((pn.size for pn in part_nodes), default=1)
    nbn_i = _round_up(max(max_nodes, 1), bs_i // br)
    nblk_i = nbn_i * br // bs_i
    int_nodes = np.full((nparts, nbn_i), nrb, dtype=np.int64)
    for p, pn in enumerate(part_nodes):
        int_nodes[p, : pn.size] = pn
    ni_dof = np.array([pn.size * br for pn in part_nodes], dtype=np.int64)

    snodes = np.flatnonzero(part_arr == -1)
    nsn = snodes.size
    if nsn:
        sub = node_graph[snodes][:, snodes]
        perm = rcm_order(sub) if nsn > 2 else np.arange(nsn)
        ordered = snodes[perm]
        pos_arr[ordered] = np.arange(nsn)
        coo = sub[perm][:, perm].tocoo()
        bw_g = max(1, int(np.abs(coo.row - coo.col).max()) if coo.nnz else 1)
    else:
        ordered = snodes
        bw_g = 1
    bs_g = _round_up(bw_g * br + br, mult)
    nsn_pad = _round_up(max(nsn, 1), bs_g // br)
    nblk_g = nsn_pad * br // bs_g
    sep_nodes = np.full(nsn_pad, nrb, dtype=np.int64)
    sep_nodes[:nsn] = ordered

    return ArrowBandPlan(
        nparts=nparts, br=br, nrb=nrb,
        bs_i=bs_i, nblk_i=nblk_i, nbn_i=nbn_i, int_nodes=int_nodes,
        ni_dof=ni_dof,
        bs_g=bs_g, nblk_g=nblk_g, nsn=nsn, nsn_pad=nsn_pad,
        sep_nodes=sep_nodes,
        part_arr=part_arr, pos_arr=pos_arr,
    )


# ---------------------------------------------------------------------------
# device assembly: stencil blocks -> band (D, E)
# ---------------------------------------------------------------------------

def assemble_band_from_stencil(
    blocks_t: torch.Tensor,     # (S, br, br, nrb) lane-major stencil
    offsets: tuple,
    part_arr: torch.Tensor,     # (nrb,) part id, -1 separator
    pos_arr: torch.Tensor,      # (nrb,) band node position
    nparts: int,
    nblk: int,
    bs: int,
    counts: torch.Tensor,       # (P,) real dofs per part (pad gets identity)
    separator: bool,
):
    """Scatter the resident stencil into batched block-banded (D, E).

    One scatter-add over all (offset, m, k, node) tuples of the lower
    triangle, then D is symmetrised. Entries whose endpoints are not both in
    the selected region (same interior part, resp. separator) are left out:
    that is the Aii / Agg restriction of the block-arrow form."""
    _, br, _, nrb = blocks_t.shape
    dtype, dev = blocks_t.dtype, blocks_t.device
    size = nparts * nblk * bs * bs
    part_arr = part_arr.long()
    pos_arr = pos_arr.long()

    pos_h = torch.stack([torch.roll(pos_arr, -off) for off in offsets])
    part_h = torch.stack([torch.roll(part_arr, -off) for off in offsets])
    pos_g = pos_arr[None, None, None, :]
    part_g = part_arr[None, None, None, :]
    pos_hb = pos_h[:, None, None, :]
    part_hb = part_h[:, None, None, :]
    m_i = torch.arange(br, device=dev)[None, :, None, None]
    k_i = torch.arange(br, device=dev)[None, None, :, None]

    if separator:
        valid = (part_g == -1) & (part_hb == -1)
        pid = torch.zeros_like(part_g)
    else:
        valid = (part_g >= 0) & (part_hb == part_g)
        pid = torch.clamp(part_g, min=0)

    dr = pos_g * br + m_i
    dc = pos_hb * br + k_i
    keep = valid & (dr >= dc)
    blk = dr // bs
    base = ((pid * nblk + blk) * bs + dr % bs) * bs
    in_d = (dc // bs) == blk
    in_e = (dc // bs) == blk - 1
    def scatter(sel, idx):
        take = (keep & sel).expand(blocks_t.shape)
        out = torch.zeros(size, dtype=dtype, device=dev)
        out.index_add_(0, idx.expand(blocks_t.shape)[take], blocks_t[take])
        return out.reshape(nparts, nblk, bs, bs)

    d = scatter(in_d, base + dc - blk * bs)
    e = scatter(in_e, base + dc - (blk - 1) * bs)
    # symmetrise D from its lower triangle
    d = torch.tril(d) + torch.tril(d, -1).mT
    # identity on padding rows
    rows = torch.arange(nblk * bs, device=dev)
    pad = (rows[None, :] >= counts.to(dev)[:, None]).to(dtype)   # (P, nblk*bs)
    pidx = torch.arange(nparts, device=dev)[:, None]
    d[pidx, rows[None, :] // bs, rows[None, :] % bs, rows[None, :] % bs] += pad
    return d, e


# ---------------------------------------------------------------------------
# the preconditioner
# ---------------------------------------------------------------------------

@dataclass
class ScalableLorasc:
    """Device LORASC. apply() maps lane-major panels (t, br, nrb) -> same."""

    plan: ArrowBandPlan
    operands: dict = field(repr=False)   # device tensors, see build
    deflated: int = 0
    timings: dict = field(default_factory=dict)  # build stage wall clock (s)
    nev: int = 0   # Lanczos / Rayleigh-Ritz width the build used

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return lorasc_apply(self.plan, self.operands, r)


def _gather_int(plan: ArrowBandPlan, ops, rn2: torch.Tensor) -> torch.Tensor:
    """(nrb+1, br·t) flat node-major -> interior band (nblk_i, P, t, bs_i)."""
    t = rn2.shape[1] // plan.br
    vi = rn2[ops["int_nodes"]].reshape(plan.nparts, plan.nbn_i, plan.br, t)
    vi = vi.permute(0, 3, 1, 2).reshape(plan.nparts, t, plan.nblk_i, plan.bs_i)
    return vi.permute(2, 0, 1, 3)


def _gather_sep(plan: ArrowBandPlan, ops, rn2: torch.Tensor) -> torch.Tensor:
    """(nrb+1, br·t) -> separator dofs (ng_pad, t)."""
    t = rn2.shape[1] // plan.br
    return rn2[ops["sep_nodes"]].reshape(plan.ng_pad, t)


def _embed_int(plan: ArrowBandPlan, ops, wb: torch.Tensor) -> torch.Tensor:
    """Interior band (nblk_i, P, t, bs_i) -> flat node-major (nrb, br·t)."""
    t = wb.shape[2]
    w = wb.permute(1, 2, 0, 3).reshape(plan.nparts, t, plan.nbn_i, plan.br)
    w = w.permute(0, 2, 3, 1).reshape(plan.nparts * plan.nbn_i, plan.br * t)
    out = torch.zeros((plan.nrb + 1, plan.br * t), dtype=wb.dtype, device=wb.device)
    out.index_add_(0, ops["int_nodes"].reshape(-1), w)
    return out[:-1]


def _embed_sep(plan: ArrowBandPlan, ops, zg: torch.Tensor) -> torch.Tensor:
    """Separator dofs (ng_pad, t) -> flat node-major (nrb, br·t)."""
    t = zg.shape[1]
    w = zg.reshape(plan.nsn_pad, plan.br * t)
    out = torch.zeros((plan.nrb + 1, plan.br * t), dtype=zg.dtype, device=zg.device)
    out.index_add_(0, ops["sep_nodes"], w)
    return out[:-1]


def _to_node_major(r: torch.Tensor) -> torch.Tensor:
    """(t, br, nrb) -> (nrb+1, br·t) flat, trailing zero node (pad target)."""
    t, br, nrb = r.shape
    rn = r.permute(2, 1, 0).reshape(nrb, br * t)
    return torch.cat([rn, torch.zeros_like(rn[:1])], dim=0)


def _from_node_major(plan: ArrowBandPlan, rn2: torch.Tensor) -> torch.Tensor:
    """(nrb, br·t) flat -> (t, br, nrb)."""
    nrb = rn2.shape[0]
    t = rn2.shape[1] // plan.br
    return rn2.reshape(nrb, plan.br, t).permute(2, 1, 0)


def _sep_band(plan: ArrowBandPlan, g: torch.Tensor) -> torch.Tensor:
    """(ng_pad, t) -> (1, nblk_g, bs_g, t), the block_banded_matvec layout."""
    return g.reshape(1, plan.nblk_g, plan.bs_g, -1)


def _sep_flat(plan: ArrowBandPlan, gb: torch.Tensor) -> torch.Tensor:
    return gb.reshape(plan.ng_pad, -1)


def _sep_band_t(plan: ArrowBandPlan, g: torch.Tensor) -> torch.Tensor:
    """(ng_pad, t) -> t-major band (nblk_g, 1, t, bs_g)."""
    t = g.shape[1]
    return g.reshape(plan.nblk_g, plan.bs_g, t).permute(0, 2, 1)[:, None]


def _sep_flat_t(plan: ArrowBandPlan, gb: torch.Tensor) -> torch.Tensor:
    """(nblk_g, 1, t, bs_g) -> (ng_pad, t)."""
    t = gb.shape[2]
    return gb[:, 0].permute(0, 2, 1).reshape(plan.ng_pad, t)


def _agg_solve(plan, ops, g: torch.Tensor) -> torch.Tensor:
    fac = BlockBandedCholesky(ops["agg_linv"], ops["agg_moff"], ops["agg_failed"])
    return _sep_flat_t(plan, block_banded_solve_t(fac, _sep_band_t(plan, g)))


def _aii_solve(plan, ops, vb: torch.Tensor) -> torch.Tensor:
    fac = BlockBandedCholesky(ops["aii_linv"], ops["aii_moff"], ops["aii_failed"])
    return block_banded_solve_t(fac, vb)


def _coarse_solve(ops: dict, c: torch.Tensor) -> torch.Tensor:
    """Λc⁻¹ c through the inverse Cholesky factor L⁻¹ of Λc = ŴᵀAŴ
    (precomputed on the host in f64): Λc⁻¹ = L⁻ᵀ L⁻¹."""
    linv = ops["coarse_linv"]
    return linv.T @ (linv @ c)


def lorasc_apply(plan: ArrowBandPlan, ops: dict, r: torch.Tensor) -> torch.Tensor:
    """M⁻¹ r (reference: lorasc.c:368-618 forward + backward sweeps), with
    the Agi/Aig products through the full stencil SpMM on zero-embedded
    vectors. Two correction modes, chosen by the operands present:

    * σ (reference form): zg += E σ Eᵀ g;
    * balancing deflation ("w_lift" present): M⁻¹ = Pᵀ M0⁻¹ P + Q with
      Q = Ŵ Λc⁻¹ Ŵᵀ, P = I − A Q over the lifted basis Ŵ = [−Aii⁻¹Aig E; E],
      so AŴ = [0; S E] is separator-supported and P needs no operator apply.

    The two sweep products use ``a_stencil_m`` where the build attached one
    (the bf16 copy of ``a_store="bf16"``: a preconditioner-side
    perturbation only; the iteration keeps the full-precision operator).
    """
    a_t = ops.get("a_stencil_m", ops["a_stencil"])
    deflate = "w_lift" in ops
    t = r.shape[0]
    rn = _to_node_major(r)
    vi = _gather_int(plan, ops, rn)
    vg = _gather_sep(plan, ops, rn)

    if deflate:
        # pre-projection P r = r − AŴ Λc⁻¹ (Ŵᵀ r): separator rows only
        w2 = ops["w_lift"].reshape(ops["w_lift"].shape[0], -1)
        c1 = w2 @ r.reshape(t, -1).T
        vg = vg - ops["aw_sep"] @ _coarse_solve(ops, c1)

    # forward sweep: zi = Aii⁻¹ vi ; g = vg − Agi zi  (one SpMM)
    zi = _aii_solve(plan, ops, vi)
    y = stencil_bsr_spmm_t(a_t, _from_node_major(plan, _embed_int(plan, ops, zi)))
    agi_zi = _gather_sep(plan, ops, _to_node_major(y))
    g = (vg - agi_zi) * ops["sep_mask"][:, None]

    # separator solve (+ low-rank σ correction: zg += E σ Eᵀ g)
    zg = _agg_solve(plan, ops, g)
    if not deflate:
        corr = ops["e_mat"].T @ g
        zg = zg + ops["e_mat"] @ (corr * ops["sigma"][:, None])
    zg = zg * ops["sep_mask"][:, None]

    # backward sweep: wi = zi − Aii⁻¹ (Aig zg)  (one SpMM)
    y2 = stencil_bsr_spmm_t(a_t, _from_node_major(plan, _embed_sep(plan, ops, zg)))
    aig_zg = _gather_int(plan, ops, _to_node_major(y2))
    wi = zi - _aii_solve(plan, ops, aig_zg)

    w = _embed_int(plan, ops, wi) + _embed_sep(plan, ops, zg)
    out = _from_node_major(plan, w)
    if deflate:
        # post-projection + coarse solve: y + Ŵ Λc⁻¹ (c1 − (AŴ)ᵀ y)
        d = ops["aw_sep"].T @ zg
        out = out + (_coarse_solve(ops, c1 - d).T @ w2).reshape(out.shape)
    return out


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _sep_node_owners(node_graph: sp.csr_matrix, plan: ArrowBandPlan,
                     part_arr: np.ndarray) -> np.ndarray:
    """Owner part of each separator node: the part it couples to most
    strongly (|A| mass), near-ties (within 1 %) going to the least-loaded
    candidate, so the separator splits evenly (numpy copy of the JAX
    version; reference: the ODB structure keeps each rank's separator rows
    local, preAlps_utils.c:521)."""
    g = node_graph.tocsr()
    owners = np.zeros(plan.nsn, dtype=np.int64)
    fill = np.zeros(plan.nparts, dtype=np.int64)
    for j in range(plan.nsn):
        u = int(plan.sep_nodes[j])
        cols = g.indices[g.indptr[u]: g.indptr[u + 1]]
        vals = np.abs(g.data[g.indptr[u]: g.indptr[u + 1]])
        parts = part_arr[cols]
        mask = parts >= 0
        if not np.any(mask):
            owners[j] = int(np.argmin(fill))
            fill[owners[j]] += 1
            continue
        w = np.zeros(plan.nparts)
        np.add.at(w, parts[mask], vals[mask])
        cand = np.flatnonzero(w >= 0.99 * w.max())
        owners[j] = int(cand[np.argmin(fill[cand])])
        fill[owners[j]] += 1
    return owners


def _sloc_index_maps(plan: ArrowBandPlan, node_graph, offsets):
    """Host index maps of the PRESC operands (the JAX build's, in numpy):
    each part's owned nodes (pad nrb) and their count nso,
    ``own_dof`` (P, c) (separator band dof of each owned dof, c = nso·br)
    and its mask, and the scatter maps ``aig_col`` (S, P, nbn_i) and
    ``agg_col`` (S, P, nso): the owned slot of node + offset when the
    neighbour is owned by the same part, else the dump slot nso."""
    br, P, nrb = plan.br, plan.nparts, plan.nrb
    owners = _sep_node_owners(node_graph, plan, plan.part_arr)
    nso = max(int(np.bincount(owners, minlength=P).max()), 1)
    own_nodes = np.full((P, nso), nrb, dtype=np.int64)    # pad -> nrb
    owned_slot = np.full(nrb + 1, nso, dtype=np.int64)    # dump slot
    owner_of_node = np.full(nrb + 1, -1, dtype=np.int64)
    fill = np.zeros(P, dtype=np.int64)
    for j in range(plan.nsn):
        p = owners[j]
        u = int(plan.sep_nodes[j])
        own_nodes[p, fill[p]] = u
        owned_slot[u] = fill[p]
        owner_of_node[u] = p
        fill[p] += 1
    sep_pos_of_node = np.full(nrb + 1, plan.nsn_pad - 1, dtype=np.int64)
    sep_pos_of_node[plan.sep_nodes[: plan.nsn]] = np.arange(plan.nsn)
    own_mask = own_nodes < nrb
    own_pos = sep_pos_of_node[np.minimum(own_nodes, nrb)]
    own_dof = (own_pos[:, :, None] * br
               + np.arange(br)[None, None, :]).reshape(P, nso * br)

    def scatter_map(nodes, valid):
        col = np.full((len(offsets),) + nodes.shape, nso, dtype=np.int32)
        for s, off in enumerate(offsets):
            nb = nodes + off
            ok = valid & (nb >= 0) & (nb < nrb)
            nb_c = np.where(ok, nb, nrb)
            same_owner = owner_of_node[nb_c] == np.arange(P)[:, None]
            col[s] = np.where(ok & same_owner, owned_slot[nb_c], nso)
        return col

    valid_band = plan.int_nodes < nrb
    return dict(nso=nso, own_nodes=own_nodes, own_mask=own_mask,
                own_dof=own_dof, valid_band=valid_band,
                aig_col=scatter_map(plan.int_nodes, valid_band),
                agg_col=scatter_map(own_nodes, own_mask))


def _own_apply(ops: dict, m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """blockdiag over the parts of m (P, c, c) applied to the owned
    separator dofs of v (ng_pad, k) and scattered back, identity on the
    separator's pad rows: the PRESC pencils' B (m = Sloc) and B⁻¹
    (m = Sloc⁻¹). Only the pad slots of ``own_dof`` repeat, and they carry
    zeros, so the scatter does not depend on order."""
    own, own_mask = ops["own_dof"], ops["own_dof_mask"][:, :, None]
    sep = ops["sep_mask"][:, None]
    yo = (m @ (v[own] * own_mask)) * own_mask
    y = torch.zeros_like(v).index_add_(0, own.reshape(-1), yo.reshape(-1, v.shape[1]))
    return y * sep + v * (1.0 - sep)


def _build_sloc_operands(plan: ArrowBandPlan, node_graph, a_stencil, dev: dict,
                         dtype, schur: bool = True) -> dict:
    """SSLOC / SALOC pencil operands (reference presc.h:18-21), added to
    ``dev``: ``sloc`` (P, c, c), ``sloc_inv``, ``own_dof`` and
    ``own_dof_mask``.

    schur=True (SSLOC, presc.c:239-241): per part p the exact local Schur
    complement Sloc_p = Agg_pp − Agi_p Aii_p⁻¹ Aig_p over the separator
    rows owned by p. Aig_p and Agg_pp are scatter-added from the resident
    lane-major blocks (only the dump slot receives duplicates, so the sums
    do not depend on order), W = Aii_p⁻¹ Aig_p rides the part's banded
    factor, and Sloc_p = Agg_pp − Aig_pᵀ W, symmetrised. One part at a
    time: the batched form's temporaries reach ~1.6 GB at n = 148k.
    schur=False (SALOC, presc_eigsolve.c:249-423): Aloc_p = Agg_pp alone.
    Each operand gets identity on its pad dofs and a batched Cholesky;
    sloc_inv = L⁻ᵀ L⁻¹. A factor that fails raises FloatingPointError."""
    br, P, nrb = plan.br, plan.nparts, plan.nrb
    bt = a_stencil.blocks_t                          # (S, br, br, nrb)
    device = bt.device
    tdt = _torch_dtype(dtype)
    maps = _sloc_index_maps(plan, node_graph, a_stencil.offsets)
    nso = maps["nso"]
    c = nso * br

    def idx(arr):
        return torch.from_numpy(np.asarray(arr, dtype=np.int64)).to(device)

    def mask(arr):
        return torch.from_numpy(np.asarray(arr, dtype=dtype)).to(device)

    int_nodes_c = idx(np.minimum(plan.int_nodes, nrb - 1))
    own_nodes_c = idx(np.minimum(maps["own_nodes"], nrb - 1))
    band_ok, own_ok = mask(maps["valid_band"]), mask(maps["own_mask"])
    aig_col, agg_col = idx(maps["aig_col"]), idx(maps["agg_col"])

    def assemble(nodes, ok, col):
        """(rows·br, c) dense coupling of ``nodes`` (rows of them) to the
        part's owned separator dofs: block s of node j lands in owned slot
        col[s, j] (slot nso is the dump)."""
        rows = nodes.shape[0]
        vals = (bt[:, :, :, nodes].permute(0, 3, 1, 2)
                * ok[None, :, None, None]).to(tdt)            # (S, rows, br, br)
        out = torch.zeros((rows * (nso + 1), br, br), dtype=tdt, device=device)
        slot = torch.arange(rows, device=device)[None, :] * (nso + 1) + col
        out.index_add_(0, slot.reshape(-1), vals.reshape(-1, br, br))
        out = out.reshape(rows, nso + 1, br, br)[:, :nso]
        return out.permute(0, 2, 1, 3).reshape(rows * br, c)

    no_fail = torch.zeros((), dtype=torch.bool, device=device)
    parts = []
    for p in range(P):
        agg = assemble(own_nodes_c[p], own_ok[p], agg_col[:, p])
        if not schur:
            parts.append(0.5 * (agg + agg.T))
            continue
        aig = assemble(int_nodes_c[p], band_ok[p], aig_col[:, p])
        fac = BlockBandedCholesky(dev["aii_linv"][p: p + 1],
                                  dev["aii_moff"][p: p + 1], no_fail)
        vb = aig.reshape(1, plan.nblk_i, plan.bs_i, c).permute(1, 0, 3, 2)
        w = block_banded_solve_t(fac, vb).permute(1, 0, 3, 2).reshape(
            plan.nblk_i * plan.bs_i, c)
        sloc = agg - aig.T @ w
        parts.append(0.5 * (sloc + sloc.T))
        del aig, vb, w
    sloc = torch.stack(parts)
    del parts

    # identity on the pad dofs keeps the batched Cholesky defined
    m = mask(np.repeat(maps["own_mask"], br, axis=1))           # (P, c)
    eye = torch.eye(c, dtype=tdt, device=device)[None]
    sloc = sloc * (m[:, :, None] * m[:, None, :]) + eye * (1.0 - m[:, :, None] * eye)
    lfac, info = torch.linalg.cholesky_ex(0.5 * (sloc + sloc.mT))
    if bool((info != 0).any() | torch.isnan(lfac).any()):
        raise FloatingPointError("PRESC pencil operand (Sloc/Aloc) is not SPD")
    linv = torch.linalg.solve_triangular(lfac, eye.expand_as(lfac), upper=False)
    dev["sloc"] = sloc
    dev["sloc_inv"] = linv.mT @ linv
    dev["own_dof"] = idx(maps["own_dof"])
    dev["own_dof_mask"] = m
    return dev


def _host_refine_pairs(a: sp.csr_matrix, plan: ArrowBandPlan,
                       vecs_np: np.ndarray, deflation_tol: float,
                       resid_tol: float = 1e-3):
    """One-time float64 Rayleigh–Ritz refinement of the f32 Lanczos
    candidates on the host (numpy/scipy copy of the JAX version): project S
    and Agg onto span(candidates) with the original scipy operator (splu
    per interior), re-solve the small generalized problem, keep pairs by
    true f64 residuals. Returns (theta (k',), e_ng (ng, k') f64)."""
    import scipy.sparse.linalg as spla

    br = plan.br
    sep_nodes = plan.sep_nodes[: plan.nsn]
    sep_dofs = (sep_nodes[:, None] * br + np.arange(br)).reshape(-1)
    v = np.asarray(vecs_np[: plan.ng], dtype=np.float64)   # (ng, k)
    # drop numerically dependent candidates early (duplicates)
    q, rr = np.linalg.qr(v)
    keep = np.abs(np.diag(rr)) > 1e-7 * max(np.abs(rr).max(), 1e-30)
    v = q[:, : keep.size][:, keep]
    k = v.shape[1]
    if k == 0:
        return np.zeros(0), np.zeros((plan.ng, 0))

    agg = a[sep_dofs][:, sep_dofs].tocsr()
    sv = agg @ v
    for p in range(plan.nparts):
        int_nodes = np.flatnonzero(plan.part_arr == p)
        if int_nodes.size == 0:
            continue
        idofs = (int_nodes[:, None] * br + np.arange(br)).reshape(-1)
        aig = a[idofs][:, sep_dofs].tocsc()
        if aig.nnz == 0:
            continue
        lu = spla.splu(a[idofs][:, idofs].tocsc())
        sv -= aig.T @ lu.solve(aig @ v)
    bv = agg @ v
    gs = v.T @ sv
    gb = v.T @ bv
    gs = 0.5 * (gs + gs.T)
    gb = 0.5 * (gb + gb.T)
    # whiten B on the subspace (drops residual near-dependence)
    w, u = np.linalg.eigh(gb)
    good = w > max(w.max(), 1e-300) * 1e-10
    u = u[:, good] / np.sqrt(w[good])
    lam, c = np.linalg.eigh(u.T @ gs @ u)
    cc = u @ c
    svc = sv @ cc
    bvc = bv @ cc
    res = (np.linalg.norm(svc - bvc * lam[None, :], axis=0)
           / np.maximum(np.linalg.norm(bvc, axis=0), 1e-300))
    sel = (lam <= deflation_tol) & (lam > 0) & (res <= resid_tol)
    e = (v @ cc)[:, sel]
    # B-normalize the kept vectors (uᵀ Agg u = 1, the PARPACK convention)
    bn = np.sqrt(np.maximum(np.einsum("gk,gk->k", e, agg @ e), 1e-300))
    return lam[sel], e / bn[None, :]


def _torch_dtype(dtype) -> torch.dtype:
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def build_scalable_lorasc(
    a: sp.spmatrix,
    nparts: int,
    br: int = 3,
    grid: tuple[int, int, int] | None = None,
    deflation_tol: float = 1e-2,
    max_deflation: int = 64,
    ncv: int | None = None,
    dtype=np.float32,
    shift: float = 0.0,
    a_stencil: StencilBsrTMatrix | None = None,
    eig_resid_tol: float = 0.03,
    restarts: int = 5,
    pencil: str = "agg",
    host_refine: bool | None = None,
    correction: str = "sigma",
    node_part: np.ndarray | None = None,
    in_sep: np.ndarray | None = None,
    lanczos_block: int | None = None,
    factor_store: str = "auto",
    device="cuda",
) -> ScalableLorasc:
    """Build the scalable LORASC for a stencil-structured operator ``a``
    (already scaled as the solver uses it; original ordering) on ``device``.

    grid: (gx, gy, gz) node-grid dims for the geometric box partition, a
    pinned partition through node_part / in_sep, or neither: the generic
    block-arrow partition of the node graph (``core/partition.py``). a_stencil: an existing
    lane-major StencilBsrTMatrix of ``a`` on ``device`` (shared with the
    solver). pencil: "agg" (S u = λ Agg u), or the PRESC pencils "sloc"
    (S u = λ Sloc u, exact local Schur complements) and "saloc" (S u =
    λ Aloc u). correction: "sigma" (zg += E σ Eᵀ g) or "deflate" (balancing
    projection over the lifted basis). lanczos_block: panel width of the
    block Lanczos (None = env PREALPS_LANCZOS_BLOCK, default 8).
    factor_store: storage type of the banded factors the apply streams,
    "f32", "bf16" or "auto" (auto is f32 off a TPU, the JAX rule).
    device: default "cuda", which raises without a card; "cpu" runs on the
    host.
    """
    device = resolve_device(device)
    if pencil not in ("agg", "sloc", "saloc"):
        raise ValueError(f"unknown pencil {pencil!r} (agg | sloc | saloc)")
    if correction not in ("sigma", "deflate"):
        raise ValueError(f"unknown correction {correction!r} (sigma | deflate)")
    if factor_store not in ("auto", "f32", "bf16"):
        raise ValueError(
            f"unknown factor_store {factor_store!r} (f32 | bf16 | auto)")
    tdt = _torch_dtype(dtype)
    f32 = tdt == torch.float32
    timings: dict = {}
    t0 = time.perf_counter()

    def _mark(stage):
        nonlocal t0
        sync(device)
        now = time.perf_counter()
        timings[stage] = round(now - t0, 2)
        t0 = now

    a = sp.csr_matrix(a)
    n = a.shape[0]
    assert n % br == 0
    nrb = n // br
    if a_stencil is None:
        a_stencil = csr_to_stencil_bsr_t(a, br=br, dtype=dtype, device=device)
        if a_stencil is None:
            raise ValueError("matrix is not stencil-structured")

    node_graph = collapse_to_nodes(a, br)
    if node_part is not None:
        # pinned block-arrow partition (preAlps_utils.c:168-193): part id per
        # node, in_sep marks separator nodes (or node_part = -1 there)
        node_part = np.asarray(node_part, dtype=np.int64).ravel()
        if in_sep is None:
            in_sep = node_part < 0
        in_sep = np.asarray(in_sep, dtype=bool).ravel()
        if node_part.shape[0] != nrb or in_sep.shape[0] != nrb:
            raise ValueError(f"node partition needs {nrb} entries, got "
                             f"{node_part.shape[0]}")
        nparts = max(nparts, int(node_part.max()) + 1)
        node_part = np.maximum(node_part, 0)
        g = node_graph.tocoo()
        live = ~(in_sep[g.row] | in_sep[g.col])
        if np.any(node_part[g.row[live]] != node_part[g.col[live]]):
            raise ValueError(
                "pinned partition is not block-arrow: interior nodes of "
                "different parts are coupled outside the separator")
    elif grid is not None:
        gx, gy, gz = grid
        assert gx * gy * gz == nrb, (grid, nrb)
        node_part, in_sep = grid_box_partition(gx, gy, gz, nparts)
    else:
        arrow = block_arrow_structure(node_graph, nparts)
        node_part = np.maximum(arrow.part, 0)
        in_sep = arrow.part < 0

    plan = plan_arrow_bands(node_graph, node_part, in_sep, nparts, br)
    _mark("plan")

    def idx(arr):
        return torch.from_numpy(np.asarray(arr, dtype=np.int64)).to(device)

    dev = dict(a_stencil=a_stencil, int_nodes=idx(plan.int_nodes),
               sep_nodes=idx(plan.sep_nodes))
    part_d, pos_d = idx(plan.part_arr), idx(plan.pos_arr)

    # --- assemble + factor interiors and separator on the device; f32
    # builds of ill-conditioned operators can lose definiteness in the
    # block recursion: retry with growing diagonal shifts ---
    shift_now = shift
    for _ in range(4):
        d_i, e_i = assemble_band_from_stencil(
            a_stencil.blocks_t, a_stencil.offsets, part_d, pos_d, plan.nparts,
            plan.nblk_i, plan.bs_i, idx(plan.ni_dof), separator=False)
        fac_i = block_banded_cholesky(d_i, e_i, shift=shift_now)
        del d_i, e_i
        d_g, e_g = assemble_band_from_stencil(
            a_stencil.blocks_t, a_stencil.offsets, part_d, pos_d, 1,
            plan.nblk_g, plan.bs_g, idx([plan.ng]), separator=True)
        fac_g = block_banded_cholesky(d_g, e_g, shift=shift_now)
        if not (bool(fac_i.failed) or bool(fac_g.failed)):
            break
        shift_now = max(shift_now * 10, 1e-6)
    dev.update(
        aii_linv=fac_i.l_inv, aii_moff=fac_i.m_off, aii_failed=fac_i.failed,
        agg_linv=fac_g.l_inv, agg_moff=fac_g.m_off, agg_failed=fac_g.failed,
    )
    del fac_i, fac_g
    sep_mask = (np.arange(plan.ng_pad) < plan.ng).astype(dtype)
    dev["sep_mask"] = torch.from_numpy(sep_mask).to(device)
    _mark("factor")

    presc = pencil in ("sloc", "saloc")
    if presc:
        _build_sloc_operands(plan, node_graph, a_stencil, dev, dtype,
                             schur=pencil == "sloc")
        _mark(pencil)

    # --- deflation eigensolve on the device (replaces PARPACK) ---
    ng_pad = plan.ng_pad
    nev = min(max_deflation, max(plan.ng - 1, 1))
    ncv_default = (2 * nev + 1) if restarts > 0 else (3 * nev + 1)
    ncv_eff = min(ncv or ncv_default, max(plan.ng - 1, 2))
    lanczos_block, lanczos_nblocks, restarts = resolve_block_policy(
        restarts, ncv_eff, plan.ng, blk=lanczos_block)
    ops = dev
    mask_col = ops["sep_mask"][:, None]

    def s_apply_panel(v):
        # S V = Agg V − Agi Aii⁻¹ Aig V through two embedded stencil SpMMs
        vhat = _from_node_major(plan, _embed_sep(plan, ops, v))
        y1n = _to_node_major(stencil_bsr_spmm_t(ops["a_stencil"], vhat))
        agg_v = _gather_sep(plan, ops, y1n)
        zi = _aii_solve(plan, ops, _gather_int(plan, ops, y1n))
        y2 = stencil_bsr_spmm_t(
            ops["a_stencil"], _from_node_major(plan, _embed_int(plan, ops, zi)))
        agi_zi = _gather_sep(plan, ops, _to_node_major(y2))
        # identity on padding keeps pad Ritz values at 1 (never deflated)
        return (agg_v - agi_zi) * mask_col + v * (1.0 - mask_col)

    if presc:
        def b_apply_panel(v):
            return _own_apply(ops, ops["sloc"], v)

        def op_apply_panel(v):
            return _own_apply(ops, ops["sloc_inv"], s_apply_panel(v))
    else:
        def b_apply_panel(v):
            return _sep_flat(plan, block_banded_matvec(d_g, e_g, _sep_band(plan, v)))

        def op_apply_panel(v):
            return _agg_solve(plan, ops, s_apply_panel(v))

    v0 = torch.from_numpy(sep_mask * 1e-2).to(device=device, dtype=tdt)
    if lanczos_block > 1 and restarts > 0:
        lancz = block_lanczos_thick_restart(
            op_apply_panel, b_apply_panel, ng_pad, nblocks=lanczos_nblocks,
            nev=nev, bt=lanczos_block, restarts=restarts, dtype=tdt, v0=v0,
            device=device)
    elif restarts > 0:
        lancz = lanczos_thick_restart(
            lambda v: op_apply_panel(v[:, None])[:, 0],
            lambda v: b_apply_panel(v[:, None])[:, 0],
            ng_pad, ncv_eff, nev=nev, restarts=restarts, dtype=tdt, v0=v0,
            device=device)
    else:
        lancz = lanczos_gen(
            lambda v: op_apply_panel(v[:, None])[:, 0],
            lambda v: b_apply_panel(v[:, None])[:, 0],
            ng_pad, ncv_eff, dtype=tdt, v0=v0, device=device)
    # subspace Rayleigh-Ritz + true residuals: drops thick-restart
    # duplicates and under-reported residuals of locked directions
    vecs = lancz.eigvectors[:, :nev]
    theta, vecs, bnorm2, resid = rayleigh_ritz_refine(
        vecs, s_apply_panel(vecs), b_apply_panel(vecs))
    del lancz, d_g, e_g
    _mark("lanczos")

    # selection: λ ≤ tol among the first nev with a converged residual;
    # σ = (tol − λ)/λ with λ floored (f32: 0.1·tol caps the amplification
    # of stored-vector noise), unselected columns σ = 0
    ok = ((theta <= deflation_tol) & (bnorm2 > 0.5)
          & (resid <= eig_resid_tol * deflation_tol))
    floor_frac = 0.1 if f32 else 1e-4
    lam_eff = torch.clamp(theta, min=deflation_tol * floor_frac)
    sigma = torch.where(ok, (deflation_tol - lam_eff) / lam_eff,
                        torch.zeros_like(lam_eff)).to(tdt)
    dev["e_mat"] = (vecs * mask_col).to(tdt)
    dev["sigma"] = sigma
    deflated = int(ok.sum())

    # host f64 refinement of the kept pairs: by default only where it pays
    # (f32 σ form of the agg pencil; the deflate form self-corrects pair
    # noise); the PRESC pencils never refine on the host, as in JAX
    if host_refine is None:
        host_refine = f32 and pencil == "agg" and plan.ng > 0 and correction == "sigma"
    if host_refine and pencil == "agg":
        th_np = theta.cpu().numpy()
        rs_np = resid.cpu().numpy()
        bn_np = bnorm2.cpu().numpy()
        pre = np.flatnonzero(
            (th_np <= 3 * deflation_tol) & (bn_np > 0.25) & (rs_np <= 0.3))
        cand = (vecs[:, torch.from_numpy(pre).to(device)].cpu().numpy()
                if pre.size else np.zeros((ng_pad, 0)))
        lam_r, e_r = _host_refine_pairs(a, plan, cand, deflation_tol)
        if lam_r.size:
            kk = lam_r.size
            e_pad = np.zeros((ng_pad, kk), dtype=np.float64)
            e_pad[: plan.ng] = e_r
            lam_floor = np.maximum(lam_r, deflation_tol * floor_frac)
            dev["e_mat"] = torch.from_numpy(e_pad.astype(dtype)).to(device)
            dev["sigma"] = torch.from_numpy(
                ((deflation_tol - lam_floor) / lam_floor).astype(dtype)).to(device)
            deflated = int(kk)
        _mark("host_refine")

    if correction == "deflate":
        _attach_deflation_lift(plan, dev, dtype,
                               lam_floor=deflation_tol * floor_frac)
        _mark("lift")

    # banded-factor storage for the solve's applies: every build consumer
    # (Lanczos, the PRESC operands, the lift) has run on the f32 factors;
    # L̃⁻ᵀL̃⁻¹ stays SPD for any stored factors
    if factor_store == "bf16":
        for key in ("aii_linv", "aii_moff", "agg_linv", "agg_moff"):
            dev[key] = dev[key].to(torch.bfloat16)
    return ScalableLorasc(plan=plan, operands=dev, deflated=deflated,
                          timings=timings, nev=nev)


def _attach_deflation_lift(plan: ArrowBandPlan, dev: dict, dtype,
                           lam_floor: float) -> None:
    """Balancing-deflation operands from the final (E, σ > 0) pairs:
    Ŵ = [−Aii⁻¹ Aig E; E] lane-major (k, br, nrb), AŴ's separator block
    S E (its interior block vanishes: the lift is the discrete harmonic
    extension), and the host-f64 inverse Cholesky factor of
    Λc = Ŵᵀ A Ŵ = Eᵀ (S E), its eigenvalues floored at lam_floor (bounds
    ‖Q‖ ≤ 1/λf against working-precision noise in Ŵᵀr)."""
    sel = torch.nonzero(dev["sigma"] > 0).reshape(-1)
    if sel.numel() == 0:
        return  # nothing deflated: M0 alone (no coarse operands attached)
    mask_col = dev["sep_mask"][:, None]
    e = dev["e_mat"][:, sel] * mask_col
    # one S·E sweep; its Aii⁻¹(Aig E) intermediate is the interior lift
    e_node = _embed_sep(plan, dev, e)
    y1n = _to_node_major(
        stencil_bsr_spmm_t(dev["a_stencil"], _from_node_major(plan, e_node)))
    agg_e = _gather_sep(plan, dev, y1n)
    zi = _aii_solve(plan, dev, _gather_int(plan, dev, y1n))
    w_int = _embed_int(plan, dev, zi)            # +Aii⁻¹ Aig E, node-major
    y2 = stencil_bsr_spmm_t(dev["a_stencil"], _from_node_major(plan, w_int))
    agi_zi = _gather_sep(plan, dev, _to_node_major(y2))
    sv = (agg_e - agi_zi) * mask_col
    w = _from_node_major(plan, e_node - w_int).contiguous()   # (k, br, nrb)
    lc64 = (e.T @ sv).cpu().numpy().astype(np.float64)
    lc64 = 0.5 * (lc64 + lc64.T)
    lam_c, u_c = np.linalg.eigh(lc64)
    lam_c = np.maximum(lam_c, lam_floor)
    linv = (u_c / np.sqrt(lam_c)[None, :]).T
    dev["w_lift"] = w
    dev["aw_sep"] = sv
    dev["coarse_linv"] = torch.from_numpy(linv.astype(dtype)).to(sv.device)
    # the σ operands are superseded
    dev["e_mat"] = torch.zeros((e.shape[0], 0), dtype=e.dtype, device=e.device)
    dev["sigma"] = torch.zeros((0,), dtype=e.dtype, device=e.device)
