"""ECG with the distributed LORASC preconditioner, over a process group.

The PyTorch counterpart of ``prealps_tpu/parallel/lorasc_driver.py``
(reference: examples/test_lorasc.c with src/preconditioners/lorasc.c). The
JAX driver runs one program over a (G, L) device mesh under ``shard_map``;
here one process runs each device of that mesh (SPMD over a
``torch.distributed`` group of G·L ranks, ``parallel/mesh.py``), rank r at
(g, l) = (r // L, r % L). L = 1 (``nshards=G``) is the one-level case and
runs the same code.

Build (host, then device):

* ``lorasc_host_plan`` (numpy; bitwise the JAX build's host values): RAC
  scaling; the block-arrow structure with one interior part per group
  (``core/partition.py``); per-part RCM band plans of the interiors; each
  group's padded rows [interior ∥ separator slice]; the padded operator as
  ELL; the Agi / Aig blocks as ELL in padded separator coordinates; the
  exact-Schur rule and its ``splu`` patches; the ELL of Agg; and the
  separator's banded plan or its dense inverse.
* Each rank keeps only its slice, by the JAX build's shardings: its rows of
  the operator (and of the lift basis), its group's band maps, its L-th of
  its group's Agi / Aig rows and of its group's interior factors (factored
  on its device, then folded for the two-level solve); the separator
  operands are replicated.
* The deflation eigensolve S u = λ Agg u runs on every rank (block
  thick-restart Lanczos, ``ops/lanczos.py``) through the sharded S-apply;
  its pairs are filtered into σ, or lifted into the balancing
  ("deflate") correction.

Apply, per ECG iteration: an all-gather of x over the group for the ELL
product; the preconditioner's two interior solves (one all-gather in the
local group per block step, forward and backward, when L > 1), one
all-reduce of the separator right-hand side over the group, the replicated
separator solve and low-rank correction, an all-gather of Aig·zg in the
local group; and the ECG Grams, all-reduced (``solvers/ecg.py``).

Every host decision is taken on values that are the same on every rank:
all-reduced scalars, and what rank 0 computes and broadcasts
(``mesh.broadcast``): the partition, the exact-Schur patches, the dense
separator inverse, the Ritz pairs and the lift's coarse factor, which come
from host LAPACK or long device recursions that two processes need not
round alike. ``solve`` returns the whole x and the same info on every rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.config import strict_fp32
from prealps_tpu_torch.core.partition import block_arrow_structure, nsplit, permute
from prealps_tpu_torch.core.scaling import sym_rac_scaling
from prealps_tpu_torch.direct.banded import (
    assemble_host,
    block_banded_cholesky,
    block_banded_solve,
    block_banded_solve_two_level,
    plan_block_banded,
    prepare_two_level,
)
from prealps_tpu_torch.ops.blockops import psum
from prealps_tpu_torch.ops.lanczos import (
    block_lanczos_thick_restart,
    lanczos_gen,
    lanczos_thick_restart,
    rayleigh_ritz_refine,
    resolve_block_policy,
)
from prealps_tpu_torch.parallel.mesh import (
    all_gather,
    backend_of,
    broadcast,
    check_backend_device,
    mesh_groups,
    rank_of,
    shard_device,
    size_of,
)
from prealps_tpu_torch.solvers.ecg import ECGOptions, ecg_solve
from prealps_tpu_torch.solvers.refine import INNER_TOL, STALL_WINDOW, refine_solve
from prealps_tpu_torch.utils.timing import sync

# operand names by how the JAX build shards them (its ``specs``)
FLAT_ROWS = ("ell_vals", "ell_cols", "w_lift")               # P((AXIS, LOC))
BY_GROUP = ("band_perm", "band_inv", "int_mask", "sep_slice_mask")  # P(AXIS)
GROUP_ROWS = ("agi_vals", "agi_cols", "aig_vals", "aig_cols")  # P(AXIS, LOC)
FACTORS = ("l_inv", "w_fwd", "l_inv_t", "w_bwd")         # P(AXIS, _, LOC, _)
INDEX = ("ell_cols", "band_perm", "band_inv", "agi_cols", "aig_cols",
         "agg_ell_c", "aband_perm", "aband_inv")


def _ell_arrays(a: sp.spmatrix, width: int, dtype):
    """ELL arrays of a fixed width (the same for every shard)."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    row_len = np.diff(a.indptr)
    w = max(width, 1)
    vals = np.zeros((n, w), dtype=dtype)
    cols = np.zeros((n, w), dtype=np.int32)
    rows = np.repeat(np.arange(n), row_len)
    slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_len)
    vals[rows, slot] = a.data
    cols[rows, slot] = a.indices
    return vals, cols


def _round_up(x: int, mult: int) -> int:
    return -(-max(x, 1) // mult) * mult


def _local(fn):
    return fn()


def lorasc_host_plan(a: sp.spmatrix, g_n: int, l_n: int = 1, dtype=None,
                     scale: bool = True, exact_schur: Optional[bool] = None,
                     agg_dense_max: int = 4096, share=_local,
                     groups=None, timings: Optional[dict] = None) -> dict:
    """The host half of the build, for a (g_n, l_n) mesh: a dict of numpy
    arrays and sizes. Its operand arrays (``ell_vals``, ``band_perm``, ...,
    ``agg_inv`` or ``aband_perm`` / ``aband_inv`` / ``sep_real_mask``)
    are bitwise the JAX build's ``_operands`` of the same names, whole
    (before any rank takes its slice); ``d`` / ``e`` are the interior band
    blocks of the groups in ``groups`` (default all) and ``agg_d`` /
    ``agg_e`` the separator's when it is banded.

    ``share(fn)`` returns fn()'s value: the caller's hook to compute it on
    one rank and broadcast it (the partition, the exact-Schur patches and
    the dense separator inverse). ``timings`` collects the stage times
    ("partition", "plan")."""
    t0 = time.perf_counter()
    a = sp.csr_matrix(a)
    dtype = np.dtype(dtype) if dtype is not None else a.dtype
    scale_d = None
    if scale:
        a, scale_d = sym_rac_scaling(a)
    n = a.shape[0]

    # block-arrow structure, one interior part per group
    arrow = share(lambda: block_arrow_structure(a, g_n))
    t1 = time.perf_counter()
    ap = permute(a, arrow.perm)
    ni_tot, ng_tot = arrow.sep_start, arrow.sep_size
    off = arrow.interior_offsets
    aii = ap[:ni_tot, :ni_tot]
    aig = ap[:ni_tot, ni_tot:]
    agi = ap[ni_tot:, :ni_tot]
    agg = ap[ni_tot:, ni_tot:]

    # banded interior plans; every group's interior padded to ni_max rows
    blocks = [aii[int(off[s]): int(off[s + 1]), int(off[s]): int(off[s + 1])]
              for s in range(g_n)]
    bplan = plan_block_banded(blocks, order="rcm", bs_multiple=int(np.lcm(8, l_n)))
    d_np, e_np = assemble_host(bplan, blocks, dtype=dtype, parts=groups)
    rows_band = bplan.rows_padded
    ni_max = _round_up(max(rows_band, int(np.diff(off).max())), l_n)
    band_perm = np.zeros((g_n, rows_band), dtype=np.int32)   # band pos -> local row
    band_inv = np.zeros((g_n, ni_max), dtype=np.int32)       # local row -> band pos
    int_mask = np.zeros((g_n, ni_max), dtype=dtype)          # 1 on real rows
    for s in range(g_n):
        m = int(bplan.sizes[s])
        band_perm[s, :m] = bplan.perm[s, :m]
        band_perm[s, m:] = np.minimum(np.arange(m, rows_band), ni_max - 1)
        band_inv[s, :m] = bplan.inv_perm[s, :m]
        # pad rows map anywhere valid: int_mask zeroes them after every
        # interior solve, so M stays SPD on the real subspace
        band_inv[s, m:] = 0
        int_mask[s, :m] = 1.0

    # separator slices per group; the per-group row map [interior | slice]
    sep_off = nsplit(ng_tot, g_n)
    ng_max = _round_up(int(np.diff(sep_off).max()), l_n)
    ng_pad = ng_max * g_n
    rows_per_group = ni_max + ng_max
    if rows_per_group % l_n:
        ng_max += l_n - (rows_per_group % l_n)
        ng_pad = ng_max * g_n
        rows_per_group = ni_max + ng_max
    n_pad = rows_per_group * g_n
    row_of = np.full(n_pad, -1, dtype=np.int64)    # padded pos -> arrow pos
    for s in range(g_n):
        i0, i1 = int(off[s]), int(off[s + 1])
        base = s * rows_per_group
        row_of[base: base + (i1 - i0)] = np.arange(i0, i1)
        g0, g1 = int(sep_off[s]), int(sep_off[s + 1])
        row_of[base + ni_max: base + ni_max + (g1 - g0)] = ni_tot + np.arange(g0, g1)

    # padded separator coordinates: padded sep pos = s * ng_max + j
    sep_pad_of = np.full(ng_pad, -1, dtype=np.int64)
    sep_slice_mask = np.zeros((g_n, ng_max), dtype=dtype)
    for s in range(g_n):
        g0, g1 = int(sep_off[s]), int(sep_off[s + 1])
        sep_pad_of[s * ng_max: s * ng_max + (g1 - g0)] = np.arange(g0, g1)
        sep_slice_mask[s, : g1 - g0] = 1.0
    realg = sep_pad_of >= 0
    arrow_sep_to_pad = np.zeros(max(ng_tot, 1), dtype=np.int64)
    arrow_sep_to_pad[sep_pad_of[realg]] = np.flatnonzero(realg)

    # the padded operator in per-group row order, as ELL
    arrow_to_pad = np.full(n + 1, n_pad, dtype=np.int64)
    real = row_of >= 0
    arrow_to_pad[row_of[real]] = np.flatnonzero(real)
    coo = ap.tocoo()
    pad_rows = np.flatnonzero(~real)
    data = np.concatenate([coo.data, np.ones(pad_rows.size, dtype=coo.data.dtype)])
    rows = np.concatenate([arrow_to_pad[coo.row], pad_rows])
    colsg = np.concatenate([arrow_to_pad[coo.col], pad_rows])
    a_pad = sp.coo_matrix((data, (rows, colsg)), shape=(n_pad, n_pad)).tocsr()
    ell_vals, ell_cols = _ell_arrays(a_pad, int(np.diff(a_pad.indptr).max()), dtype)
    del a_pad, coo, data, rows, colsg

    # Agi / Aig in padded coordinates
    agi_parts, aig_parts = [], []
    l_agi = l_aig = 1
    for s in range(g_n):
        i0, i1 = int(off[s]), int(off[s + 1])
        blk = agi[:, i0:i1].tocsr()
        l_agi = max(l_agi, int(np.diff(blk.indptr).max()) if blk.nnz else 1)
        agi_parts.append(blk)
        blk = aig[i0:i1, :].tocsr()
        l_aig = max(l_aig, int(np.diff(blk.indptr).max()) if blk.nnz else 1)
        aig_parts.append(blk)
    agi_vals = np.zeros((g_n, ng_pad, l_agi), dtype=dtype)
    agi_cols = np.zeros((g_n, ng_pad, l_agi), dtype=np.int32)
    for s, blk in enumerate(agi_parts):
        v, c = _ell_arrays(blk, l_agi, dtype)
        agi_vals[s, arrow_sep_to_pad] = v
        agi_cols[s, arrow_sep_to_pad] = c
    aig_vals = np.zeros((g_n, ni_max, l_aig), dtype=dtype)
    aig_cols = np.zeros((g_n, ni_max, l_aig), dtype=np.int32)
    for s, blk in enumerate(aig_parts):
        v, c = _ell_arrays(blk, l_aig, dtype)
        aig_vals[s, : v.shape[0]] = v
        aig_cols[s, : v.shape[0]] = arrow_sep_to_pad[c.ravel()].reshape(c.shape)

    # the separator operator: Agg, or the exact Schur complement S = Agg −
    # Σ_s Agi_s Aii_s⁻¹ Aig_s from part-local boundary patches where the
    # separator holds a large share of the rows (the JAX build's rule)
    if exact_schur is None:
        exact_schur = bool(ng_tot > 0 and ng_tot >= 0.25 * n and ng_tot <= 8192)

    def schur_op():
        import scipy.sparse.linalg as spla

        rows_l, cols_l, vals_l = [], [], []
        for s in range(g_n):
            i0, i1 = int(off[s]), int(off[s + 1])
            if i1 == i0:
                continue
            aig_s = aig[i0:i1, :].tocsc()
            bset = np.flatnonzero(np.diff(aig_s.indptr))
            if bset.size == 0:
                continue
            lu = spla.splu(aii[i0:i1, i0:i1].tocsc())
            w = lu.solve(aig_s[:, bset].toarray())
            patch = np.asarray(agi[bset][:, i0:i1] @ w.reshape(i1 - i0, bset.size))
            rows_l.append(np.repeat(bset, bset.size))
            cols_l.append(np.tile(bset, bset.size))
            vals_l.append(patch.ravel())
        if not rows_l:          # no part couples to the separator: S = Agg
            return agg.tocsr()
        corr = sp.coo_matrix(
            (np.concatenate(vals_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(ng_tot, ng_tot)).tocsr()
        out = (agg.tocsr() - corr).tocsr()
        out.eliminate_zeros()
        return out

    sep_op = share(schur_op) if (exact_schur and ng_tot) else agg.tocsr()
    agg_banded = bool(ng_pad > agg_dense_max)

    # ELL of the padded Agg (the Lanczos B products)
    agg_coo = agg.tocoo()
    padg = np.flatnonzero(~realg)
    agg_pad_csr = sp.coo_matrix(
        (np.concatenate([agg_coo.data, np.ones(padg.size)]),
         (np.concatenate([arrow_sep_to_pad[agg_coo.row], padg]),
          np.concatenate([arrow_sep_to_pad[agg_coo.col], padg]))),
        shape=(ng_pad, ng_pad)).tocsr()
    agg_w = max(int(np.diff(agg_pad_csr.indptr).max()), 1)
    agg_ell_v, agg_ell_c = _ell_arrays(agg_pad_csr, agg_w, dtype)

    plan = dict(
        g_n=g_n, l_n=l_n, n=n, ng_tot=int(ng_tot), ni_max=int(ni_max),
        ng_max=int(ng_max), ng_pad=int(ng_pad), rows_per_group=int(rows_per_group),
        n_pad=int(n_pad), nblk=bplan.nblk, bs=bplan.bs, exact_schur=exact_schur,
        agg_banded=agg_banded, nblk_a=0, bs_a=0, a_scaled=a, scale_d=scale_d,
        arrow_perm=arrow.perm, row_of=row_of, sep_mask=realg.astype(dtype),
        d=d_np, e=e_np,
        ell_vals=ell_vals, ell_cols=ell_cols, band_perm=band_perm,
        band_inv=band_inv, int_mask=int_mask, sep_slice_mask=sep_slice_mask,
        agi_vals=agi_vals, agi_cols=agi_cols, aig_vals=aig_vals,
        aig_cols=aig_cols, agg_ell_v=agg_ell_v, agg_ell_c=agg_ell_c)
    if agg_banded:
        # RCM block-banded separator factor (the MUMPS role, n·band memory)
        aplan = plan_block_banded([sep_op], order="rcm")
        plan["agg_d"], plan["agg_e"] = assemble_host(aplan, [sep_op], dtype=dtype)
        plan.update(nblk_a=aplan.nblk, bs_a=aplan.bs)
        # band pos -> padded sep coordinate; padded coordinate -> band pos
        # (pad slots -> 0, masked back to the identity after the solve)
        aband_perm = np.zeros(aplan.rows_padded, dtype=np.int32)
        aband_perm[:ng_tot] = arrow_sep_to_pad[aplan.perm[0, :ng_tot]]
        aband_inv = np.zeros(ng_pad, dtype=np.int32)
        aband_inv[arrow_sep_to_pad[:ng_tot]] = aplan.inv_perm[0, :ng_tot]
        plan.update(aband_perm=aband_perm, aband_inv=aband_inv,
                    sep_real_mask=realg.astype(dtype))
    else:
        def dense_inverse():
            agg_pad = np.eye(ng_pad)
            idx = np.flatnonzero(realg)
            if ng_tot:
                agg_pad[np.ix_(idx, idx)] = sep_op.toarray()[
                    np.ix_(sep_pad_of[realg], sep_pad_of[realg])]
            np.linalg.cholesky(agg_pad)       # fail fast if not SPD
            return np.linalg.inv(agg_pad).astype(dtype)

        plan["agg_inv"] = share(dense_inverse)
    if timings is not None:
        timings["partition"] = t1 - t0
        timings["plan"] = time.perf_counter() - t1
    return plan


def _tensor(arr, device, index=False) -> torch.Tensor:
    arr = np.asarray(arr)
    return torch.from_numpy(np.array(arr, dtype=np.int64 if index else arr.dtype,
                                     order="C")).to(device)


def rank_slice(name: str, arr: np.ndarray, geo: dict, g: int, l: int):
    """Rank (g, l)'s part of a whole operand array, by the JAX build's
    sharding of ``name``."""
    l_n = geo["l_n"]
    if name in FLAT_ROWS:
        rpl = geo["rows_per_group"] // l_n
        r = g * l_n + l
        return arr[r * rpl:(r + 1) * rpl]
    if name in BY_GROUP:
        return arr[g]
    if name in GROUP_ROWS:
        m = arr.shape[1] // l_n
        return arr[g, l * m:(l + 1) * m]
    if name in FACTORS:
        m = arr.shape[2] // l_n
        return arr[g:g + 1, :, l * m:(l + 1) * m]
    return arr


@dataclass
class DistributedLorascECG:
    """ECG with distributed LORASC over a process group. Build once, solve
    many."""

    ngroups: int
    nlocal: int
    ni_max: int
    ng_max: int
    n: int
    scale_d: Optional[np.ndarray]
    arrow_perm: np.ndarray       # arrow position -> original row
    row_of: np.ndarray           # padded global position -> arrow row (-1 pad)
    opts: ECGOptions
    deflated: int
    geo: dict                    # sizes of the build (lorasc_host_plan's)
    ops: dict                    # this rank's operands on its device
    device: torch.device
    group: object
    local: object = None         # process group of this rank's L ranks
    target_tol: float = 0.0
    a_scaled: Optional[sp.csr_matrix] = None   # set when refining
    timings: dict = field(default_factory=dict)

    @property
    def nshards(self):
        return self.ngroups

    @property
    def g_idx(self) -> int:
        return rank_of(self.group) // self.nlocal

    @property
    def l_idx(self) -> int:
        return rank_of(self.group) % self.nlocal

    @classmethod
    def build(
        cls,
        a: sp.spmatrix,
        nshards: Optional[int] = None,
        opts: ECGOptions = ECGOptions(),
        deflation_tol: float = 1e-2,
        max_deflation: int = 64,
        ncv: Optional[int] = None,
        scale: bool = True,
        dtype=None,
        refine: Optional[bool] = None,
        inner_tol: float = INNER_TOL,
        mesh_shape: Optional[tuple] = None,
        shift: float = 0.0,
        eig_resid_tol: float = 0.03,
        restarts: int = 5,
        exact_schur: Optional[bool] = None,
        agg_dense_max: int = 4096,
        correction: str = "sigma",
        device="cuda",
        group=None,
    ) -> "DistributedLorascECG":
        """Build on every rank of ``group`` (a ``torch.distributed`` group of
        G·L ranks; every rank calls ``build`` with the same arguments).
        ``nshards=G`` is the one-level mesh (G, 1), ``mesh_shape=(G, L)``
        the two-level one; without either, G is the group's size.
        ``device="cuda"`` is ``cuda:{rank}`` and raises without a card;
        ranks that share a card name it (``"cuda:0"``) and a gloo group;
        ``device="cpu"`` runs on the host. The other arguments are the JAX
        driver's."""
        world = size_of(group)
        if mesh_shape is None:
            g_n, l_n = (nshards or world), 1
        else:
            g_n, l_n = (int(v) for v in mesh_shape)
        if g_n < 2:
            # one part has no separator: the block arrow (and LORASC)
            # degenerates; the reference runs under mpirun -np >= 2
            raise ValueError(
                "DistributedLorascECG needs >= 2 interior parts (nshards/"
                "mesh_shape); for a single device use "
                "parallel.lorasc_stencil.StencilLorascECG (stencil "
                "operators) or precond.lorasc (small matrices)")
        if g_n * l_n != world:
            raise ValueError(f"mesh {g_n}x{l_n} needs a process group of "
                             f"{g_n * l_n} ranks; got "
                             f"{'no group' if group is None else f'{world} ranks'}")
        if correction not in ("sigma", "deflate"):
            raise ValueError(f"unknown correction {correction!r}")
        rank = rank_of(group)
        device = shard_device(device, rank)
        check_backend_device(backend_of(group), world, device, rank)
        strict_fp32()
        g_idx, l_idx, local = mesh_groups(group, (g_n, l_n))
        a = sp.csr_matrix(a)
        dtype = np.dtype(dtype) if dtype is not None else a.dtype
        target_tol = opts.tol
        if refine is None:
            refine = dtype == np.float32 and opts.tol < inner_tol
        if refine:
            opts = replace(opts, tol=inner_tol,
                           stall_window=opts.stall_window or STALL_WINDOW)

        def share(fn):
            return broadcast(fn() if rank == 0 else None, group)

        timings: dict = {}
        plan = lorasc_host_plan(a, g_n, l_n, dtype, scale, exact_schur,
                                agg_dense_max, share=share, groups=[g_idx],
                                timings=timings)
        mark = time.perf_counter()
        geo = {k: v for k, v in plan.items() if isinstance(v, (int, bool))}
        ops = {}
        for name in (*FLAT_ROWS[:2], *BY_GROUP, *GROUP_ROWS, "agg_ell_v",
                     "agg_ell_c", "agg_inv", "aband_perm", "aband_inv",
                     "sep_real_mask", "sep_mask"):
            if name in plan:
                ops[name] = _tensor(rank_slice(name, plan[name], geo, g_idx, l_idx),
                                    device, name in INDEX)

        # interior factors of this rank's group, then its rows of them
        fac = block_banded_cholesky(_tensor(plan["d"], device),
                                    _tensor(plan["e"], device), shift=shift)
        fac2 = prepare_two_level(fac)
        del fac
        rows = plan["bs"] // l_n
        ops["fac"] = fac2.rows(l_idx * rows, (l_idx + 1) * rows)
        del fac2
        if plan["agg_banded"]:
            agg_fac = block_banded_cholesky(_tensor(plan["agg_d"], device),
                                            _tensor(plan["agg_e"], device),
                                            shift=shift)
            if bool(agg_fac.failed):
                raise FloatingPointError(
                    "separator operator (Agg or exact Schur) is not SPD")
            ops["agg_fac"] = agg_fac
        sync(device)
        timings["factor"] = time.perf_counter() - mark
        tdt = ops["ell_vals"].dtype
        ops["e_mat"] = torch.zeros((plan["ng_pad"], 1), dtype=tdt, device=device)
        ops["sigma"] = torch.zeros(1, dtype=tdt, device=device)
        solver = cls(
            ngroups=g_n, nlocal=l_n, ni_max=plan["ni_max"], ng_max=plan["ng_max"],
            n=plan["n"], scale_d=plan["scale_d"], arrow_perm=plan["arrow_perm"],
            row_of=plan["row_of"], opts=opts, deflated=plan["ng_tot"], geo=geo,
            ops=ops, device=device, group=group, local=local,
            target_tol=target_tol, a_scaled=plan["a_scaled"] if refine else None,
            timings=timings)
        del plan
        if not geo["exact_schur"]:
            mark = time.perf_counter()
            solver._deflate(deflation_tol, max_deflation, ncv, eig_resid_tol,
                            restarts, correction, share)
            sync(device)
            timings["lanczos"] = time.perf_counter() - mark
        return solver

    # --- the sharded pieces of the sweep (the JAX build's closures) --------

    def _gather_local(self, chunk: torch.Tensor) -> torch.Tensor:
        """The group's rows: an all-gather in the local group (L > 1)."""
        return chunk if self.local is None else all_gather(chunk, self.local, dim=0)

    def _agg_solve(self, g: torch.Tensor) -> torch.Tensor:
        """Separator solve (ng_pad, t) -> (ng_pad, t), replicated: one GEMM
        with the dense inverse, or the RCM-ordered banded solves."""
        ops, geo = self.ops, self.geo
        if "agg_inv" in ops:
            return ops["agg_inv"] @ g
        t = g.shape[1]
        gb = g[ops["aband_perm"]]
        gb[geo["ng_tot"]:] = 0.0
        zb = block_banded_solve(ops["agg_fac"],
                                gb.reshape(1, geo["nblk_a"], geo["bs_a"], t))
        z = zb.reshape(-1, t)[ops["aband_inv"]]
        m = ops["sep_real_mask"][:, None]
        return z * m + g * (1.0 - m)     # the identity on padding slots

    def _aii_solve(self, vi: torch.Tensor) -> torch.Tensor:
        """(ni_max, t), the same on the group's ranks -> solved; pad rows
        masked to zero on entry and exit."""
        ops, geo = self.ops, self.geo
        mask = ops["int_mask"][:, None]
        t = vi.shape[1]
        vb = (vi * mask)[ops["band_perm"]].reshape(1, geo["nblk"], geo["bs"], t)
        zb = block_banded_solve_two_level(ops["fac"], vb, self.local)
        return zb.reshape(-1, t)[ops["band_inv"]] * mask

    def _sep_assemble(self, vg: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
        """g = scatter(vg) − Agi zi, summed over the group: replicated. Each
        rank adds its rows of its group's Agi zi; the group's separator
        slice vg is added once, by its l = 0 rank."""
        ops, geo = self.ops, self.geo
        t = zi.shape[1]
        agiz = torch.einsum("gl,glt->gt", ops["agi_vals"], zi[ops["agi_cols"]])
        m = agiz.shape[0]
        g_full = torch.zeros((geo["ng_pad"], t), dtype=zi.dtype, device=zi.device)
        g_full[self.l_idx * m:(self.l_idx + 1) * m] = -agiz
        if self.l_idx == 0:
            g0 = self.g_idx * geo["ng_max"]
            g_full[g0:g0 + geo["ng_max"]] += vg
        return psum(g_full, self.group)

    def _aig_mul(self, zg: torch.Tensor) -> torch.Tensor:
        """Aig zg on this group's interior rows, (ni_max, t) in-group."""
        ops = self.ops
        return self._gather_local(
            torch.einsum("il,ilt->it", ops["aig_vals"], zg[ops["aig_cols"]]))

    def _sweep(self, v_grp: torch.Tensor, gmod=None):
        """The LORASC sweep on the group's panel (rows_per_group, t);
        returns (the same shape, the replicated zg). ``gmod``: the
        separator rhs subtraction of the balancing pre-projection."""
        ops, geo = self.ops, self.geo
        ni_max, ng_max = geo["ni_max"], geo["ng_max"]
        smask = ops["sep_slice_mask"][:, None]
        vi, vg = v_grp[:ni_max], v_grp[ni_max:] * smask
        zi = self._aii_solve(vi)
        g = self._sep_assemble(vg, zi)
        if gmod is not None:
            g = g - gmod
        e_mat = ops["e_mat"]
        corr = e_mat.T @ g
        zg = self._agg_solve(g) + e_mat @ (corr * ops["sigma"][:, None])
        wi = zi - self._aii_solve(self._aig_mul(zg))
        g0 = self.g_idx * ng_max
        wg = zg[g0:g0 + ng_max] * smask
        return torch.cat([wi, wg], dim=0), zg

    def _s_apply(self, v: torch.Tensor) -> torch.Tensor:
        """S V = Agg V − Agi Aii⁻¹ Aig V on a (ng_pad, k) panel, the
        identity on padding (matrixVectorOp.c AggInvxS)."""
        zi = self._aii_solve(self._aig_mul(v))
        g = self._sep_assemble(
            torch.zeros((self.geo["ng_max"], v.shape[1]), dtype=v.dtype,
                        device=v.device), zi)
        mask = self.ops["sep_mask"][:, None]
        return (self._b_apply(v) + g) * mask + v * (1.0 - mask)

    def _b_apply(self, v: torch.Tensor) -> torch.Tensor:
        """Agg V (padded, ELL)."""
        return torch.einsum("gl,glk->gk", self.ops["agg_ell_v"],
                            v[self.ops["agg_ell_c"]])

    # --- the deflation build ---------------------------------------------

    def _deflate(self, deflation_tol, max_deflation, ncv, eig_resid_tol,
                 restarts, correction, share):
        """The Lanczos eigensolve of S u = λ Agg u on every rank, rank 0's
        pairs on all, filtered into σ and E; with correction="deflate" the
        balancing lift over Ŵ = [−Aii⁻¹Aig E; E]."""
        ops, geo = self.ops, self.geo
        ng_tot, ng_pad = geo["ng_tot"], geo["ng_pad"]
        dtype = ops["ell_vals"].dtype
        dev = self.device
        nev = min(max_deflation, max(ng_tot - 1, 1))
        # PARPACK's ncv = 2·nev + 1 with restarts (eigsolver.c:110); one
        # pass needs the larger 3·nev + 1
        ncv_default = (2 * nev + 1) if restarts > 0 else (3 * nev + 1)
        ncv_eff = min(ncv or ncv_default, max(ng_tot - 1, 2))
        sep_mask = ops["sep_mask"]
        v0 = sep_mask * 1e-2

        def op_panel(v):
            return self._agg_solve(self._s_apply(v))

        def op_vec(v):
            return op_panel(v[:, None])[:, 0]

        def b_vec(v):
            return self._b_apply(v[:, None])[:, 0]

        blk, nblocks_eff, restarts_eff = resolve_block_policy(
            restarts, ncv_eff, ng_tot)
        if blk > 1:
            lancz = block_lanczos_thick_restart(
                op_panel, self._b_apply, ng_pad, nblocks=nblocks_eff, nev=nev,
                bt=blk, restarts=restarts_eff, dtype=dtype, v0=v0, device=dev)
        elif restarts > 0:
            lancz = lanczos_thick_restart(op_vec, b_vec, ng_pad, ncv_eff, nev=nev,
                                          restarts=restarts, dtype=dtype, v0=v0,
                                          device=dev)
        else:
            lancz = lanczos_gen(op_vec, b_vec, ng_pad, ncv_eff, dtype=dtype,
                                v0=v0, device=dev)
        # subspace RR refinement and true residuals (see
        # precond/lorasc_scale.py)
        vecs = lancz.eigvectors[:, :nev]
        theta, vecs, bnorm2, resid = rayleigh_ritz_refine(
            vecs, self._s_apply(vecs), self._b_apply(vecs))
        theta, vecs, bnorm2, resid = (
            t.to(dev) for t in share(
                lambda: tuple(t.cpu() for t in (theta, vecs, bnorm2, resid))))
        # filter unconverged Ritz pairs; dtype-aware σ cap
        ok = ((theta <= deflation_tol) & (bnorm2 > 0.5)
              & (resid <= eig_resid_tol * deflation_tol))
        floor_frac = 0.1 if dtype == torch.float32 else 1e-4
        lam_eff = torch.clamp(theta, min=deflation_tol * floor_frac)
        sigma = torch.where(ok, (deflation_tol - lam_eff) / lam_eff,
                            torch.zeros_like(lam_eff)).to(dtype)
        e_mat = (vecs * sep_mask[:, None]).to(dtype)
        ops["e_mat"], ops["sigma"] = e_mat, sigma
        self.deflated = int(ok.sum())
        if correction != "deflate":
            return
        sel = torch.nonzero(sigma > 0).flatten()
        if sel.numel() == 0:
            return
        e_s = e_mat[:, sel]
        sv = self._s_apply(e_s) * sep_mask[:, None]
        zi = self._aii_solve(self._aig_mul(e_s))
        g0 = self.g_idx * geo["ng_max"]
        e_slc = e_s[g0:g0 + geo["ng_max"]] * ops["sep_slice_mask"][:, None]
        w_grp = torch.cat([-zi, e_slc], dim=0)
        rpl = geo["rows_per_group"] // self.nlocal
        lc = (e_s.T @ sv).cpu().numpy()

        def coarse_factor():
            lc64 = np.asarray(lc, dtype=np.float64)
            lc64 = 0.5 * (lc64 + lc64.T)
            lam_c, u_c = np.linalg.eigh(lc64)
            lam_c = np.maximum(lam_c, deflation_tol * floor_frac)
            return (u_c / np.sqrt(lam_c)[None, :]).T

        ops["w_lift"] = w_grp[self.l_idx * rpl:(self.l_idx + 1) * rpl].contiguous()
        ops["aw_sep"] = sv
        ops["coarse_linv"] = torch.from_numpy(share(coarse_factor)).to(dtype).to(dev)
        # the σ path is superseded
        ops["e_mat"] = torch.zeros((ng_pad, 1), dtype=dtype, device=dev)
        ops["sigma"] = torch.zeros(1, dtype=dtype, device=dev)
        self.deflated = int(sel.numel())

    # --- the solve ---------------------------------------------------------

    def a_apply(self, x_loc: torch.Tensor) -> torch.Tensor:
        """This rank's rows of A·x: x all-gathered over the group, then the
        ELL gather product."""
        x_full = all_gather(x_loc, self.group, dim=0)
        return torch.einsum("ml,mlt->mt", self.ops["ell_vals"],
                            x_full[self.ops["ell_cols"]])

    def _coarse(self, c: torch.Tensor) -> torch.Tensor:
        linv = self.ops["coarse_linv"]
        return linv.T @ (linv @ c)

    def m_apply(self, v_loc: torch.Tensor) -> torch.Tensor:
        """The preconditioner on this rank's (rpl, t) rows: the group's
        panel, the sweep, this rank's rows of the result; the deflate mode
        wraps the sweep in the balancing projections (c1 = Ŵᵀr is one
        all-reduce over the group)."""
        ops = self.ops
        v_grp = self._gather_local(v_loc)
        gmod = c1 = None
        if "w_lift" in ops:
            c1 = psum(ops["w_lift"].T @ v_loc, self.group)
            gmod = ops["aw_sep"] @ self._coarse(c1)
        w_grp, zg = self._sweep(v_grp, gmod)
        rpl = v_loc.shape[0]
        out = w_grp[self.l_idx * rpl:(self.l_idx + 1) * rpl]
        if "w_lift" in ops:
            d = ops["aw_sep"].T @ zg
            out = out + ops["w_lift"] @ self._coarse(c1 - d)
        return out

    def _ecg(self, b_loc: torch.Tensor):
        rpl = b_loc.shape[0]
        n_pad = self.row_of.shape[0]
        gpos = rank_of(self.group) * rpl + torch.arange(rpl, device=self.device)
        return ecg_solve(self.a_apply, self.m_apply, b_loc, self.opts,
                         split_assign=(gpos * self.opts.t) // n_pad, group=self.group)

    def solve(self, b: np.ndarray, max_refine_rounds: int = 8):
        """Solve A x = b (every rank passes the same b); returns (x, info)
        on every rank, the same. info: iters, res, normb, breakdown,
        deflated, refine_rounds."""
        b = np.asarray(b)
        b_eff = self.scale_d * b if self.scale_d is not None else b.astype(np.float64)
        if self.a_scaled is not None:
            x, info = refine_solve(self.a_scaled, b_eff, self._solve_scaled_once,
                                   self.target_tol, max_rounds=max_refine_rounds)
        else:
            x, info = self._solve_scaled_once(b_eff)
            info["refine_rounds"] = 0
        info["deflated"] = self.deflated
        if self.scale_d is not None:
            x = self.scale_d * x
        return x, info

    def _solve_scaled_once(self, b_eff: np.ndarray):
        dtype = self.ops["ell_vals"].dtype
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        b_arrow = np.asarray(b_eff).astype(np_dtype)[self.arrow_perm]
        n_pad = self.row_of.shape[0]
        real = self.row_of >= 0
        b_pad = np.zeros(n_pad, dtype=np_dtype)
        b_pad[real] = b_arrow[self.row_of[real]]
        rpl = n_pad // size_of(self.group)
        r = rank_of(self.group)
        res = self._ecg(torch.from_numpy(b_pad[r * rpl:(r + 1) * rpl].copy())
                        .to(self.device))
        x_pad = all_gather(res.x, self.group, dim=0).cpu().numpy()
        x_arrow = np.zeros(self.n, dtype=np.float64)
        x_arrow[self.row_of[real]] = x_pad[real]
        x = np.empty(self.n)
        x[self.arrow_perm] = x_arrow
        info = {"iters": int(res.iters), "res": float(res.res),
                "normb": float(res.normb), "breakdown": bool(res.breakdown)}
        return x, info
