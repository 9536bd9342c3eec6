"""Carry a built solver's state across from the JAX package.

``solver_from_reference`` builds a port ``DistributedECG`` directly on the
operands another build produced (the JAX ``DistributedECG``'s, handed over
as numpy arrays), skipping the port's own build; ``lorasc_from_reference``
does the same for a JAX ``ScalableLorasc`` and
``distributed_lorasc_from_reference`` for a JAX ``DistributedLorascECG``
and ``ecg_solver_from_reference`` for the single-device ``ECGSolver``.
Both packages can then solve on identical operands (for LORASC:
identical deflation pairs, which an f32 Lanczos does not reproduce across
implementations), which separates solver parity from build parity in the
tests.

The scipy adapters (the counterpart of the reference's PETSc interface,
used for comparison baselines) wrap a built solver or a preconditioner
apply as a ``scipy.sparse.linalg.LinearOperator``, and
``ecg_vs_scipy_cg`` sets ECG beside scipy's CG on the same system.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from prealps_tpu_torch.api import ECGSolver
from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.layout import RowLayout
from prealps_tpu_torch.direct.banded import BlockBandedCholesky, BlockBandedCholesky2L
from prealps_tpu_torch.direct.device_bj import block_groups
from prealps_tpu_torch.direct.subdomain import DenseCholesky
from prealps_tpu_torch.ops.formats import (
    BlockEllMatrix,
    DiaEllMatrix,
    EllMatrix,
    StencilBsrTMatrix,
)
from prealps_tpu_torch.parallel.driver import (
    BlockEllOperands,
    DiaLaneOperands,
    DiaOperands,
    DistributedECG,
    EllOperands,
    StencilOperands,
    halo_send_row,
)
from prealps_tpu_torch.parallel.lorasc_driver import (
    FACTORS,
    INDEX,
    DistributedLorascECG,
    rank_slice,
)
from prealps_tpu_torch.parallel.mesh import mesh_groups, rank_of, shard_device, size_of
from prealps_tpu_torch.precond.block_jacobi import BlockJacobi
from prealps_tpu_torch.precond.chebyshev import Chebyshev
from prealps_tpu_torch.precond.lorasc import Lorasc
from prealps_tpu_torch.precond.lorasc_scale import ArrowBandPlan, ScalableLorasc
from prealps_tpu_torch.solvers.ecg import ECGOptions


def solver_from_reference(arrays: dict, meta: dict, device="cuda",
                          group=None) -> DistributedECG:
    """Port solver on a reference build's operands.

    With ``group`` (a process group of ``meta["nshards"]`` ranks), every
    rank passes the reference's global arrays (a JAX build over as many
    shards) and keeps its own shard: its nodes or rows of the operator and
    the preconditioner, its part of every block array, the replicated
    coarse inverse.

    arrays — numpy unless noted:
      ``scale_d``  (n,) RAC scaling vector, or None
      ``perm``, ``inv_perm``, ``layout_offsets``  the RowLayout arrays
      ``a_scaled`` scipy sparse scaled matrix (needed when refining), or None
      and by format (``meta["fmt"]``):
      * "stencil" (default): ``blocks`` stencil block table, (S, br, br, nrb)
        or flat (S·br², nrb); ``inv_f`` (nb, mb, mb) block inverses, or
        none; for bj2l also ``yq3`` (nb, q, mb) coarse modes and ``ac_inv``
        (nb·q, nb·q) coarse inverse (without them the preconditioner is
        plain block Jacobi, "bj_flat");
      * "ell": ``ell_vals``, ``ell_cols`` (n_pad, L); over several shards
        ``ell_cols`` in [own rows ∥ halo buffer] coordinates and
        ``ell_send_idx`` (S, S, h) (the JAX build's halo plan operands);
      * "block_ell" / "block_ell_xla": ``bell_blocks`` (nrb, S, 8, bk),
        ``bell_blkcols`` (nrb, S); over several shards ``bell_blkcols`` in
        [own blocks ∥ halo buffer] coordinates and ``bell_send_idx``
        (S, S, hb) (the JAX build's block halo plan operands);
      * "dia": ``dia_diags`` (D, n_pad) promoted diagonals (or the JAX
        lane-major build's (D, 1, 1, n_pad)), ``dia_rem_vals``,
        ``dia_rem_cols`` (n_pad, L) ELL remainder (the JAX driver keeps an
        all-zero slot where there is none); over several shards
        ``dia_rem_cols`` in [own rows ∥ halo buffer] coordinates and
        ``dia_send_idx`` (S, S, h); on ``meta["layout"] == "tbn"``
        ``inv_f`` (nb, mb, mb) device block inverses, or none;
      * row-major formats also ``bj_factors`` (nb, mb, mb), ``bj_gather_idx``
        (nb·mb,), ``bj_inv_perm`` (n_pad,) of the host block Jacobi (none
        for precond="none");
      and in place of those block inverses, the other preconditioner kinds:
      * "bj_dedup" (lane-major): ``inv_u`` (ng, br, mbn, br, mbn) unique
        inverses, with ``meta["groups"]`` the block ids of each;
      * "bj_lane" (lane-major): ``inv5`` (nb, br, mbn, br, mbn) inverses in
        bf16 (the JAX build's bf16 array);
      * "chebyshev": ``inv_panel`` D⁻¹ in the operator's space ((br, nrb)
        lane-major, (n_pad,) row-major), with ``meta["cheb"]`` = (λ_min,
        λ_max, degree).
    meta:
      ``n``, ``n_pad``, ``rows_per_shard``, ``nshards`` (default 1),
      ``opts`` (dict of ECGOptions
      fields, as the reference solver holds them after build),
      ``target_tol``; ``fmt``; for the stencil ``stencil_offsets`` (S node
      offsets) and ``br``; for DIA ``dia_offsets`` and ``layout`` ("nt" or
      "tbn"); for block-ELL ``ncols_pad``; for the row-major formats
      ``bj_mode`` ("inverse" or "cholesky").
    ``pre_perm`` in arrays (fmt="auto"'s row permutation) is kept.

    The operands' dtype (float32 or float64) is the solve's dtype.
    """
    nshards = int(meta.get("nshards", 1))
    if nshards != size_of(group):
        raise ValueError(f"a build over {nshards} shards needs a group of as "
                         f"many ranks; got {size_of(group)}")
    shard = rank_of(group)
    device = resolve_device(device) if group is None else shard_device(device, shard)
    strict_fp32()
    fmt = meta.get("fmt", "stencil")
    lane = fmt == "stencil" or (fmt == "dia" and meta.get("layout") == "tbn")

    def part(arr, axis=0):
        """This shard's equal part of a global array along ``axis``."""
        arr = np.asarray(arr)
        n = arr.shape[axis] // nshards
        return np.take(arr, np.arange(shard * n, (shard + 1) * n), axis=axis)

    def dev(name, dtype=None, axis=0, replicated=False):
        # copies: arrays handed over from another framework may be read-only
        arr = arrays[name] if replicated else part(arrays[name], axis)
        return torch.from_numpy(np.array(arr, dtype=dtype, order="C")).to(device)

    n_pad = int(meta["n_pad"])
    mpl = n_pad // nshards

    def send_row(name):
        if nshards == 1:
            return None
        return halo_send_row(np.asarray(arrays[name]), shard, device)

    if fmt == "stencil":
        br = int(meta["br"])
        offsets = tuple(int(o) for o in meta["stencil_offsets"])
        blocks = np.asarray(arrays["blocks"])
        blocks_flat = part(blocks.reshape(len(offsets) * br * br, blocks.shape[-1]), 1)
        dtype = blocks_flat.dtype
        bj2l = arrays.get("yq3") is not None
        operands = StencilOperands(
            blocks_flat=torch.from_numpy(np.array(blocks_flat, order="C")).to(device),
            offsets=offsets, br=br,
            inv_f=dev("inv_f", dtype) if arrays.get("inv_f") is not None else None,
            yq3=dev("yq3", dtype) if bj2l else None,
            ac_inv=dev("ac_inv", dtype, replicated=True) if bj2l else None)
    elif fmt == "dia" and meta.get("layout") == "tbn":
        offsets = tuple(int(o) for o in meta["dia_offsets"])
        diags = np.asarray(arrays["dia_diags"])
        dtype = diags.dtype
        operands = DiaLaneOperands(
            blocks_flat=torch.from_numpy(np.array(
                part(diags.reshape(len(offsets), n_pad), 1), order="C")).to(device),
            offsets=offsets, br=1,
            inv_f=dev("inv_f", dtype) if arrays.get("inv_f") is not None else None,
            rem_vals=dev("dia_rem_vals", dtype),
            rem_cols=dev("dia_rem_cols", np.int64),
            rem_send_idx=send_row("dia_send_idx"))
    else:
        bj = None
        if arrays.get("bj_factors") is not None:
            bj = BlockJacobi(factors=dev("bj_factors"),
                             gather_idx=dev("bj_gather_idx", np.int64),
                             inv_perm=dev("bj_inv_perm", np.int64),
                             mode=meta["bj_mode"])
        if fmt == "ell":
            send_idx = send_row("ell_send_idx")
            width = mpl if send_idx is None else mpl + send_idx.numel()
            operands = EllOperands(
                mat=EllMatrix(dev("ell_vals"), dev("ell_cols", np.int32),
                              (mpl, width)),
                bj=bj, send_idx=send_idx)
            dtype = np.asarray(arrays["ell_vals"]).dtype
        elif fmt in ("block_ell", "block_ell_xla"):
            send_idx = send_row("bell_send_idx")
            blocks = dev("bell_blocks")
            width = (int(meta["ncols_pad"]) if send_idx is None
                     else mpl + send_idx.numel() * blocks.shape[-1])
            operands = BlockEllOperands(
                mat=BlockEllMatrix(blocks, dev("bell_blkcols", np.int32),
                                   (mpl, width)),
                bj=bj, kernel=fmt == "block_ell", send_idx=send_idx)
            dtype = np.asarray(arrays["bell_blocks"]).dtype
        elif fmt == "dia":
            send_idx = send_row("dia_send_idx")
            width = mpl if send_idx is None else mpl + send_idx.numel()
            rem = EllMatrix(dev("dia_rem_vals"), dev("dia_rem_cols", np.int32),
                            (mpl, width))
            operands = DiaOperands(
                mat=DiaEllMatrix(offsets=tuple(int(o) for o in meta["dia_offsets"]),
                                 diags=dev("dia_diags", axis=1), rem=rem,
                                 shape=(mpl, mpl)),
                bj=bj, send_idx=send_idx)
            dtype = np.asarray(arrays["dia_diags"]).dtype
        else:
            raise ValueError(f"unknown fmt {fmt!r}")
    if arrays.get("inv_u") is not None:
        operands.inv_u = dev("inv_u", dtype)
        operands.groups = block_groups(meta["groups"], device)
    if arrays.get("inv5") is not None:
        operands.inv5 = _tensor(part(arrays["inv5"])).to(device)
    if arrays.get("inv_panel") is not None:
        lam_min, lam_max, degree = meta["cheb"]
        operands.cheb = Chebyshev(
            inv_diag=dev("inv_panel", dtype, axis=-1 if lane else 0),
            lam_min=float(lam_min),
            lam_max=float(lam_max), degree=int(degree),
            a_apply=operands.a_apply, lane_major=operands.layout == "tbn")
    operands.group, operands.shard = group, shard
    layout = RowLayout(
        n=int(meta["n"]), n_pad=n_pad, nshards=nshards,
        rows_per_shard=int(meta["rows_per_shard"]),
        perm=np.asarray(arrays["perm"]), inv_perm=np.asarray(arrays["inv_perm"]),
        offsets=np.asarray(arrays["layout_offsets"]))
    a_scaled = arrays.get("a_scaled")
    scale_d = arrays.get("scale_d")
    return DistributedECG(
        layout=layout, opts=ECGOptions(**meta["opts"]),
        scale_d=None if scale_d is None else np.asarray(scale_d),
        operands=operands, device=device, dtype=np.dtype(dtype),
        target_tol=float(meta["target_tol"]),
        a_scaled=None if a_scaled is None else sp.csr_matrix(a_scaled),
        pre_perm=arrays.get("pre_perm"), group=group,
    )


_LORASC_INDEX_OPERANDS = ("int_nodes", "sep_nodes", "own_dof")


def _tensor(arr, dtype=None) -> torch.Tensor:
    """numpy array -> CPU tensor; bf16 arrays (numpy's ``bfloat16`` from
    ml_dtypes, as the JAX package hands them over) through their uint16
    bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), order="C")
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=dtype, order="C"))


def lorasc_from_reference(plan_fields: dict, operands_np: dict, meta: dict,
                          device="cuda") -> ScalableLorasc:
    """Port ``ScalableLorasc`` on a reference build's plan and operands.

    plan_fields: the ``ArrowBandPlan`` fields (ints and numpy arrays).
    operands_np: numpy arrays by the operand names of the JAX build —
      ``blocks_t`` (the stencil table of ``a_stencil``), ``int_nodes``,
      ``sep_nodes``, ``aii_linv``, ``aii_moff``, ``aii_failed``,
      ``agg_linv``, ``agg_moff``, ``agg_failed``, ``sep_mask``, ``e_mat``,
      ``sigma``, and for the balancing correction ``w_lift``, ``aw_sep``,
      ``coarse_linv``; ``a_lo_blocks`` where the solve refines in f32; for
      the PRESC pencils ``sloc``, ``sloc_inv``, ``own_dof`` and
      ``own_dof_mask``; ``blocks_t_m``, the table of ``a_stencil_m``
      (``a_store="bf16"``). bf16 arrays (factors, tables) stay bf16.
    meta: ``offsets`` (stencil node offsets), ``shape`` (n, n) and
      ``deflated``.
    """
    device = resolve_device(device)
    strict_fp32()
    offsets = tuple(int(o) for o in meta["offsets"])
    shape = tuple(int(v) for v in meta["shape"])
    ops = {}
    for name, arr in operands_np.items():
        t = _tensor(arr, np.int64 if name in _LORASC_INDEX_OPERANDS else None)
        if name in ("blocks_t", "blocks_t_m"):
            key = "a_stencil" if name == "blocks_t" else "a_stencil_m"
            ops[key] = StencilBsrTMatrix(t.to(device), offsets, shape)
        else:
            ops[name] = t.to(device)
    return ScalableLorasc(plan=ArrowBandPlan(**plan_fields), operands=ops,
                          deflated=int(meta["deflated"]))


def distributed_lorasc_from_reference(arrays: dict, meta: dict, device="cuda",
                                      group=None) -> DistributedLorascECG:
    """Port ``DistributedLorascECG`` on a JAX build's operands.

    Every rank of ``group`` (G·L ranks for a build over a (G, L) mesh)
    passes the whole arrays and keeps its slice, by the JAX build's
    shardings (``lorasc_driver.rank_slice``): its rows of the operator and
    of the lift basis, its group's band maps, its share of its group's Agi
    / Aig rows and interior factor rows; the separator operands, the Ritz
    basis ``e_mat`` and ``sigma`` and the lift's ``aw_sep`` and
    ``coarse_linv`` are replicated. Both packages then apply the same
    preconditioner, whatever their Lanczos rounding.

    arrays — numpy, the JAX build's ``_operands[0]`` entries by name
      (``ell_vals``, ``ell_cols``, ``band_perm``, ``band_inv``,
      ``int_mask``, ``sep_slice_mask``, ``agi_vals``, ``agi_cols``,
      ``aig_vals``, ``aig_cols``, ``agg_ell_v``, ``agg_ell_c``, ``e_mat``,
      ``sigma``; ``agg_inv``, or ``aband_perm``, ``aband_inv``,
      ``sep_real_mask``; ``w_lift``, ``aw_sep``, ``coarse_linv`` where the
      build lifted), its two-level interior factors ``l_inv``, ``w_fwd``,
      ``l_inv_t``, ``w_bwd`` (G, nblk, bs, bs), the banded separator's
      factors ``agg_l_inv``, ``agg_m_off``, and ``scale_d`` (or None),
      ``arrow_perm``, ``row_of``, ``a_scaled`` (or None: no refinement);
    meta — ``ngroups``, ``nlocal``, ``ni_max``, ``ng_max``, ``n``,
      ``deflated``, ``target_tol`` and ``opts`` (dict of ECGOptions fields
      as the reference holds them after build).
    """
    g_n, l_n = int(meta["ngroups"]), int(meta["nlocal"])
    if g_n * l_n != size_of(group):
        raise ValueError(f"a build over a {g_n}x{l_n} mesh needs a group of "
                         f"{g_n * l_n} ranks; got {size_of(group)}")
    device = shard_device(device, rank_of(group))
    strict_fp32()
    g_idx, l_idx, local = mesh_groups(group, (g_n, l_n))
    ni_max, ng_max = int(meta["ni_max"]), int(meta["ng_max"])
    smask = np.asarray(arrays["sep_slice_mask"])
    nblk, bs = np.asarray(arrays["l_inv"]).shape[1:3]
    geo = dict(g_n=g_n, l_n=l_n, n=int(meta["n"]), ni_max=ni_max, ng_max=ng_max,
               ng_pad=ng_max * g_n, rows_per_group=ni_max + ng_max,
               n_pad=(ni_max + ng_max) * g_n, nblk=int(nblk), bs=int(bs),
               ng_tot=int(smask.sum()), agg_banded="agg_l_inv" in arrays,
               exact_schur=False)

    def dev(name, arr=None):
        arr = rank_slice(name, np.asarray(arrays[name] if arr is None else arr),
                         geo, g_idx, l_idx)
        return _tensor(arr, np.int64 if name in INDEX else None).to(device)

    skip = (*FACTORS, "agg_l_inv", "agg_m_off", "scale_d", "arrow_perm",
            "row_of", "a_scaled")
    ops = {name: dev(name) for name, arr in arrays.items()
           if name not in skip and arr is not None}
    ops["sep_mask"] = _tensor(smask.reshape(-1)).to(device)
    ops["fac"] = BlockBandedCholesky2L(*(dev(name) for name in FACTORS))
    if geo["agg_banded"]:
        a_l = np.asarray(arrays["agg_l_inv"])
        geo.update(nblk_a=int(a_l.shape[1]), bs_a=int(a_l.shape[2]))
        ops["agg_fac"] = BlockBandedCholesky(
            l_inv=_tensor(a_l).to(device),
            m_off=_tensor(arrays["agg_m_off"]).to(device),
            failed=torch.zeros((), dtype=torch.bool, device=device))
    a_scaled = arrays.get("a_scaled")
    scale_d = arrays.get("scale_d")
    return DistributedLorascECG(
        ngroups=g_n, nlocal=l_n, ni_max=ni_max, ng_max=ng_max, n=geo["n"],
        scale_d=None if scale_d is None else np.asarray(scale_d),
        arrow_perm=np.asarray(arrays["arrow_perm"]),
        row_of=np.asarray(arrays["row_of"]), opts=ECGOptions(**meta["opts"]),
        deflated=int(meta["deflated"]), geo=geo, ops=ops, device=device,
        group=group, local=local, target_tol=float(meta["target_tol"]),
        a_scaled=None if a_scaled is None else sp.csr_matrix(a_scaled))


def ecg_solver_from_reference(fields: dict, meta: dict, device="cuda") -> ECGSolver:
    """Port ``ECGSolver`` on a JAX single-device build's operands.

    fields — numpy arrays: the operator ``ell_vals``, ``ell_cols`` (the
      scaled, permuted matrix in ELL); ``a_solver`` (that matrix as scipy
      CSR, or None: no refinement); ``perm`` and ``scale_d`` (or None);
      for block Jacobi ``bj_factors``, ``bj_gather_idx``, ``bj_inv_perm``;
      for LORASC and PRESC ``aii_factors``, ``aii_gather_idx``,
      ``aii_inv_perm``, ``agg_factor``, ``aig_vals``, ``aig_cols``,
      ``agi_vals``, ``agi_cols``, ``e_mat`` and ``sigma``;
    meta — ``precond`` ("block_jacobi", "lorasc", "presc" or "none"),
      ``bj_mode``, ``ni``, ``ng``, ``n``, ``dtype``, ``target_tol`` and
      ``opts`` (dict of ECGOptions fields as the reference holds them after
      build)."""
    dev = resolve_device(device)
    strict_fp32()
    n = int(meta["n"])
    t = lambda name, dtype=None: _tensor(fields[name], dtype).to(dev)

    def ell(pre, ncols):
        vals = t(f"{pre}_vals")
        return EllMatrix(vals, t(f"{pre}_cols", np.int32), (vals.shape[0], ncols))

    kind = meta["precond"]
    m_obj = None
    if kind in ("block_jacobi", "bj"):
        m_obj = BlockJacobi(t("bj_factors"), t("bj_gather_idx", np.int64),
                            t("bj_inv_perm", np.int64), mode=meta["bj_mode"])
    elif kind in ("lorasc", "presc"):
        ni, ng = int(meta["ni"]), int(meta["ng"])
        m_obj = Lorasc(
            aii_solver=BlockJacobi(t("aii_factors"), t("aii_gather_idx", np.int64),
                                   t("aii_inv_perm", np.int64), mode="cholesky"),
            agg_solver=DenseCholesky(t("agg_factor")),
            aig=ell("aig", ng), agi=ell("agi", ni), e_mat=t("e_mat"),
            sigma=t("sigma"), ni=ni, ng=ng)
    a_solver = fields.get("a_solver")
    perm, scale_d = fields.get("perm"), fields.get("scale_d")
    return ECGSolver(
        opts=ECGOptions(**meta["opts"]), ell=ell("ell", n), precond=m_obj,
        dtype=np.dtype(meta["dtype"]), device=dev, n=n,
        target_tol=float(meta["target_tol"]),
        perm=None if perm is None else np.asarray(perm),
        scale_d=None if scale_d is None else np.asarray(scale_d),
        a_solver=None if a_solver is None else sp.csr_matrix(a_solver))


def as_scipy_linear_operator(solver) -> spla.LinearOperator:
    """A built solver (``ECGSolver``, ``DistributedECG`` on one shard,
    ``StencilLorascECG``) as a scipy LinearOperator computing A⁻¹ b."""
    n = solver.layout.n if hasattr(solver, "layout") else solver.n

    def matvec(b):
        x, _ = solver.solve(np.asarray(b).ravel())
        return x

    return spla.LinearOperator((n, n), matvec=matvec, dtype=np.float64)


def precond_as_scipy(m_apply, n: int, device="cuda",
                     dtype=torch.float64) -> spla.LinearOperator:
    """An (n, t) panel preconditioner apply as a scipy LinearOperator (for
    scipy.sparse.linalg.cg's ``M``); the vector goes to ``device`` (the
    preconditioner's; "cuda" unless named) in ``dtype`` and back."""
    dev = resolve_device(device)

    def matvec(v):
        z = torch.from_numpy(np.asarray(v, dtype=np.float64).reshape(n, 1))
        return m_apply(z.to(device=dev, dtype=dtype)).cpu().numpy().astype(np.float64).ravel()

    return spla.LinearOperator((n, n), matvec=matvec, dtype=np.float64)


def ecg_vs_scipy_cg(a: sp.spmatrix, b: np.ndarray, tol: float = 1e-6,
                    t: int = 4, maxiter: int = 10000, device="cuda"):
    """scipy CG and ECG with block Jacobi (on ``device``) on the same
    system: iteration counts, true relative residuals and wall times (the
    reference's test_ecg_bench_petsc_pcg)."""
    it = {"cg": 0}

    def cb(_):
        it["cg"] += 1

    t0 = time.time()
    x_cg, _ = spla.cg(a, b, rtol=tol, maxiter=maxiter, callback=cb)
    cg_time = time.time() - t0
    solver = ECGSolver.build(a, opts=ECGOptions(t=t, tol=tol, maxiter=maxiter),
                             precond="block_jacobi", device=device)
    t0 = time.time()
    x_ecg, ecg_info = solver.solve(b)
    ecg_time = time.time() - t0
    nb = np.linalg.norm(b)
    return {"cg_iters": it["cg"],
            "cg_relres": float(np.linalg.norm(b - a @ x_cg) / nb),
            "cg_time": cg_time,
            "ecg_iters": ecg_info["iters"],
            "ecg_relres": float(np.linalg.norm(b - a @ x_ecg) / nb),
            "ecg_time": ecg_time}
