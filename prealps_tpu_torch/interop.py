"""Carry a built solver's state across from the JAX package.

``solver_from_reference`` builds a port ``DistributedECG`` directly on the
operands another build produced (the JAX ``DistributedECG``'s, handed over
as numpy arrays), skipping the port's own build; ``lorasc_from_reference``
does the same for a JAX ``ScalableLorasc``. Both packages can then solve on
identical operands (for LORASC: identical deflation pairs, which an f32
Lanczos does not reproduce across implementations), which separates solver
parity from build parity in the tests.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.layout import RowLayout
from prealps_tpu_torch.direct.device_bj import block_groups
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
)
from prealps_tpu_torch.precond.block_jacobi import BlockJacobi
from prealps_tpu_torch.precond.chebyshev import Chebyshev
from prealps_tpu_torch.precond.lorasc_scale import ArrowBandPlan, ScalableLorasc
from prealps_tpu_torch.solvers.ecg import ECGOptions


def solver_from_reference(arrays: dict, meta: dict, device="cuda") -> DistributedECG:
    """Port solver on a reference build's operands.

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
      * "ell": ``ell_vals``, ``ell_cols`` (n_pad, L);
      * "block_ell" / "block_ell_xla": ``bell_blocks`` (nrb, S, 8, bk),
        ``bell_blkcols`` (nrb, S);
      * "dia": ``dia_diags`` (D, n_pad) promoted diagonals (or the JAX
        lane-major build's (D, 1, 1, n_pad)), ``dia_rem_vals``,
        ``dia_rem_cols`` (n_pad, L) ELL remainder (the JAX driver keeps an
        all-zero slot where there is none); on ``meta["layout"] == "tbn"``
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
      ``n``, ``n_pad``, ``rows_per_shard``, ``opts`` (dict of ECGOptions
      fields, as the reference solver holds them after build),
      ``target_tol``; ``fmt``; for the stencil ``stencil_offsets`` (S node
      offsets) and ``br``; for DIA ``dia_offsets`` and ``layout`` ("nt" or
      "tbn"); for block-ELL ``ncols_pad``; for the row-major formats
      ``bj_mode`` ("inverse" or "cholesky").
    ``pre_perm`` in arrays (fmt="auto"'s row permutation) is kept.

    The operands' dtype (float32 or float64) is the solve's dtype.
    """
    device = resolve_device(device)
    strict_fp32()
    fmt = meta.get("fmt", "stencil")

    def dev(name, dtype=None):
        # copies: arrays handed over from another framework may be read-only
        return torch.from_numpy(np.array(arrays[name], dtype=dtype, order="C")).to(device)

    n_pad = int(meta["n_pad"])
    if fmt == "stencil":
        br = int(meta["br"])
        offsets = tuple(int(o) for o in meta["stencil_offsets"])
        blocks = np.asarray(arrays["blocks"])
        blocks_flat = blocks.reshape(len(offsets) * br * br, blocks.shape[-1])
        dtype = blocks_flat.dtype
        bj2l = arrays.get("yq3") is not None
        operands = StencilOperands(
            blocks_flat=torch.from_numpy(np.array(blocks_flat, order="C")).to(device),
            offsets=offsets, br=br,
            inv_f=dev("inv_f", dtype) if arrays.get("inv_f") is not None else None,
            yq3=dev("yq3", dtype) if bj2l else None,
            ac_inv=dev("ac_inv", dtype) if bj2l else None)
    elif fmt == "dia" and meta.get("layout") == "tbn":
        offsets = tuple(int(o) for o in meta["dia_offsets"])
        diags = np.asarray(arrays["dia_diags"])
        dtype = diags.dtype
        operands = DiaLaneOperands(
            blocks_flat=torch.from_numpy(np.array(
                diags.reshape(len(offsets), n_pad), order="C")).to(device),
            offsets=offsets, br=1,
            inv_f=dev("inv_f", dtype) if arrays.get("inv_f") is not None else None,
            rem_vals=dev("dia_rem_vals", dtype),
            rem_cols=dev("dia_rem_cols", np.int64))
    else:
        bj = None
        if arrays.get("bj_factors") is not None:
            bj = BlockJacobi(factors=dev("bj_factors"),
                             gather_idx=dev("bj_gather_idx", np.int64),
                             inv_perm=dev("bj_inv_perm", np.int64),
                             mode=meta["bj_mode"])
        if fmt == "ell":
            operands = EllOperands(
                mat=EllMatrix(dev("ell_vals"), dev("ell_cols", np.int32),
                              (n_pad, n_pad)),
                bj=bj)
            dtype = np.asarray(arrays["ell_vals"]).dtype
        elif fmt in ("block_ell", "block_ell_xla"):
            operands = BlockEllOperands(
                mat=BlockEllMatrix(dev("bell_blocks"), dev("bell_blkcols", np.int32),
                                   (n_pad, int(meta["ncols_pad"]))),
                bj=bj, kernel=fmt == "block_ell")
            dtype = np.asarray(arrays["bell_blocks"]).dtype
        elif fmt == "dia":
            rem = EllMatrix(dev("dia_rem_vals"), dev("dia_rem_cols", np.int32),
                            (n_pad, n_pad))
            operands = DiaOperands(
                mat=DiaEllMatrix(offsets=tuple(int(o) for o in meta["dia_offsets"]),
                                 diags=dev("dia_diags"), rem=rem,
                                 shape=(n_pad, n_pad)),
                bj=bj)
            dtype = np.asarray(arrays["dia_diags"]).dtype
        else:
            raise ValueError(f"unknown fmt {fmt!r}")
    if arrays.get("inv_u") is not None:
        operands.inv_u = dev("inv_u", dtype)
        operands.groups = block_groups(meta["groups"], device)
    if arrays.get("inv5") is not None:
        bits = np.array(np.asarray(arrays["inv5"]).view(np.uint16), order="C")
        operands.inv5 = torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if arrays.get("inv_panel") is not None:
        lam_min, lam_max, degree = meta["cheb"]
        operands.cheb = Chebyshev(
            inv_diag=dev("inv_panel", dtype), lam_min=float(lam_min),
            lam_max=float(lam_max), degree=int(degree),
            a_apply=operands.a_apply, lane_major=operands.layout == "tbn")
    layout = RowLayout(
        n=int(meta["n"]), n_pad=n_pad, nshards=1,
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
        pre_perm=arrays.get("pre_perm"),
    )


_LORASC_INDEX_OPERANDS = ("int_nodes", "sep_nodes")


def lorasc_from_reference(plan_fields: dict, operands_np: dict, meta: dict,
                          device="cuda") -> ScalableLorasc:
    """Port ``ScalableLorasc`` on a reference build's plan and operands.

    plan_fields: the ``ArrowBandPlan`` fields (ints and numpy arrays).
    operands_np: numpy arrays by the operand names of the JAX build —
      ``blocks_t`` (the stencil table of ``a_stencil``), ``int_nodes``,
      ``sep_nodes``, ``aii_linv``, ``aii_moff``, ``aii_failed``,
      ``agg_linv``, ``agg_moff``, ``agg_failed``, ``sep_mask``, ``e_mat``,
      ``sigma``, and for the balancing correction ``w_lift``, ``aw_sep``,
      ``coarse_linv``; ``a_lo_blocks`` where the solve refines in f32.
    meta: ``offsets`` (stencil node offsets), ``shape`` (n, n) and
      ``deflated``.
    """
    device = resolve_device(device)
    strict_fp32()
    ops = {}
    for name, arr in operands_np.items():
        if name == "blocks_t":
            continue
        dtype = np.int64 if name in _LORASC_INDEX_OPERANDS else None
        ops[name] = torch.from_numpy(np.array(arr, dtype=dtype, order="C")).to(device)
    ops["a_stencil"] = StencilBsrTMatrix(
        blocks_t=torch.from_numpy(np.array(operands_np["blocks_t"], order="C")).to(device),
        offsets=tuple(int(o) for o in meta["offsets"]),
        shape=tuple(int(v) for v in meta["shape"]))
    return ScalableLorasc(plan=ArrowBandPlan(**plan_fields), operands=ops,
                          deflated=int(meta["deflated"]))
