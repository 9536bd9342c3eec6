"""Enlarged Conjugate Gradient (ECG): omin, odir and odir_fused.

The PyTorch counterpart of ``prealps_tpu/solvers/ecg.py``. Two state forms:

* unstacked (``_iter_omin``, ``_iter_odir``, ``_iter_odir_fused``): the
  panels X, R, P, AP, P_prev, AP_prev, Z are separate tensors and every
  layout-dependent step goes through ``panels.NT`` (rows-major (m, t), the
  general-sparse path) or ``panels.TBN`` (lane-major);
* stacked ODIR-fused (the default for layout "tbn" + "odir_fused", the
  headline stencil path): the seven panels [X, R, P, P_prev, AP, AP_prev, Z]
  live in ONE flat (7t, N) tensor, so an iteration is

    G  = W Wᵀ                      one (7t)² Gram (all five t×t reductions)
    W' = Cᵀ W                      one coefficient GEMM composing the update
    AP', Z' slots <- A·P', M⁻¹AP'  operator + preconditioner callbacks

  with the t×t algebra (masked Cholesky, triangular inverse, corrections,
  optional adaptive SVD rotation) in between;
* stacked omin (``stacked=True`` with omin, lane-major only): the five
  panels [X, R, P, AP, Z] in one flat (5t, N) tensor, with the unstacked
  omin's operation order (normalise P first, then alpha on the normalised
  panel) and its three reductions.

``lax.while_loop`` becomes a Python loop with the same stop rules (residual
vs tol, maxiter, active block size, breakdown, stall window); evaluating
them costs one host synchronisation per iteration. ``ecg_solve(x0=...)``
warm-starts by solving the shifted system A·dx = b − A·x0.

Sharded (``group=``, one process per shard): every reduction — the Grams,
``normb``, the initial column norms, the adaptive reduction's pivoted
Cholesky — is a ``psum`` over the group, as ``axis_name`` makes it in the
JAX solver, so the t×t algebra and the stop tests are replicated.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional

import torch

from prealps_tpu_torch.ops.blockops import (
    chol_masked,
    pivoted_cholesky,
    psum,
    tri_inv,
)
from prealps_tpu_torch.solvers.panels import LAYOUTS, TBN


@dataclass(frozen=True)
class ECGOptions:
    t: int = 8                   # enlarging factor (number of rhs splits)
    tol: float = 1e-5            # relative residual tolerance ||R||_F/||b||
    maxiter: int = 10000
    variant: str = "odir_fused"  # omin | odir | odir_fused
    adaptive: bool = False       # dynamic search-direction reduction
    adaptive_mode: str = "truncate"  # truncate (drop reduced directions) |
                                 # freeze (keep them as a frozen basis)
    record_history: bool = True
    layout: str = "nt"           # nt | tbn (lane-major)
    stall_window: int = 0        # >0: stop after this many consecutive
                                 # iterations improving by less than
                                 # stall_rtol (refinement inner solves: 250)
    stall_rtol: float = 5e-4
    stacked: Optional[bool] = None  # None = auto (tbn + odir_fused)

    def __post_init__(self):
        if self.t < 1:
            raise ValueError(f"enlarging factor t must be >= 1, got {self.t}")
        if self.maxiter < 1:
            raise ValueError(f"maxiter must be >= 1, got {self.maxiter}")
        if not (self.tol > 0):
            raise ValueError(f"tol must be positive, got {self.tol}")
        if self.variant not in ("omin", "odir", "odir_fused"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.layout not in ("nt", "tbn"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.adaptive_mode not in ("truncate", "freeze"):
            raise ValueError(
                f"unknown adaptive_mode {self.adaptive_mode!r}")
        if self.stacked and self.variant == "odir":
            raise ValueError(
                "stacked fast paths exist for omin and odir_fused only")
        if self.stacked and self.layout != "tbn":
            raise ValueError("stacked=True requires layout='tbn'")


class ECGResult(NamedTuple):
    x: torch.Tensor          # solution panel space (*space)
    iters: int
    res: torch.Tensor        # final ||R||_F (0-d)
    normb: torch.Tensor
    bs: int                  # final active block size
    breakdown: bool          # True if PᵀAP lost positive definiteness
    history: torch.Tensor    # ||R||_F per iteration (maxiter,), -1 padded


@dataclass
class ECGState:
    """Stacked solver state. ``w`` is (7t, N) with slots _SX.._SZ
    (odir_fused) or (5t, N) with slots _OX.._OZ (omin); the scalars stay on the device so an iteration needs no host round trip
    beyond the loop's stop test."""

    w: torch.Tensor
    panel_shape: tuple       # (t, *space) at the operator boundary
    mask: torch.Tensor       # (t,) active-direction mask (1.0 prefix)
    it: int
    res: torch.Tensor
    breakdown: torch.Tensor  # 0-d bool
    history: torch.Tensor
    best_res: torch.Tensor
    stall: torch.Tensor      # 0-d int32: iterations since real progress


@dataclass
class ECGPanelState:
    """Unstacked solver state: one tensor per panel, in the layout's panel
    shape ((m, t) for "nt", (t, *space) for "tbn")."""

    x_blk: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    ap: torch.Tensor
    p_prev: torch.Tensor
    ap_prev: torch.Tensor
    z: torch.Tensor
    mask: torch.Tensor
    it: int
    res: torch.Tensor
    breakdown: torch.Tensor
    history: torch.Tensor
    best_res: torch.Tensor
    stall: torch.Tensor


_SX, _SR, _SP, _SPP, _SAP, _SAPP, _SZ = range(7)
_OX, _OR, _OP, _OAP, _OZ = range(5)      # stacked omin slots (X first in both)


def _use_stacked(opts: ECGOptions) -> bool:
    # omin stays unstacked unless asked for, as in the JAX package
    if opts.stacked is not None:
        return opts.stacked
    return opts.layout == "tbn" and opts.variant == "odir_fused"


def _track_stall(state, res, stall_rtol):
    # an improvement below stall_rtol does not count as progress
    improved = res < (1.0 - stall_rtol) * state.best_res
    best = torch.minimum(state.best_res, res)
    stall = torch.where(improved, torch.zeros_like(state.stall), state.stall + 1)
    return best, stall


def split_rhs(b: torch.Tensor, t: int, assign=None, ops=LAYOUTS["nt"]) -> torch.Tensor:
    """Split rhs b into t disjoint groups; default: contiguous equal split of
    the flattened entries."""
    if assign is None:
        m = b.numel()
        assign = ((torch.arange(m, device=b.device) * t) // m).reshape(b.shape)
    return ops.split(b, t, assign)


def _record(state, res, opts):
    history = state.history
    if opts.record_history:
        history = history.clone()
        history[state.it] = res
    return history


def _cholqr_factor(mu, mask, dtype):
    """Masked upper Cholesky of PᵀAP and its inverse; a failed factor
    (breakdown) is replaced by the identity."""
    u = chol_masked(mu, mask)
    breakdown = torch.isnan(u).any()
    eye = torch.eye(mu.shape[0], dtype=dtype, device=mu.device)
    u = torch.where(breakdown, eye, u)
    return tri_inv(u), breakdown


def _rotate_reduce(ops, alpha, p, ap, z, mask, red_tol):
    """Adaptive search-direction reduction (prealps_tpu/solvers/ecg.py:173-196).

    SVD of alpha = U Σ Vᵀ; directions rotated by U, those with σ ≤ red_tol
    deactivated. ``jax.lax.cond`` becomes a host branch here: deciding it
    costs one host synchronisation per iteration (adaptive runs only)."""
    t = alpha.shape[0]
    u_svd, sig, _ = torch.linalg.svd(alpha * mask[:, None])
    t1 = torch.sum(sig > red_tol)
    bs = torch.sum(mask).to(t1.dtype)
    do_red = (t1 > 0) & (t1 < bs)
    new_mask = (torch.arange(t, device=alpha.device)
                < torch.where(do_red, t1, bs)).to(alpha.dtype)
    if bool(do_red):
        alpha = u_svd.T @ alpha
        p, ap, z = ops.rotate(p, u_svd), ops.rotate(ap, u_svd), ops.rotate(z, u_svd)
    alpha = alpha * new_mask[:, None]
    return alpha, p, ap, ops.scale_dirs(z, new_mask), new_mask


def _iter_omin(state: ECGPanelState, a_apply, m_apply, opts, normb, red_tol, ops,
               group=None):
    """One orthomin iteration (prealps_tpu/solvers/ecg.py:199-242)."""
    p, ap, r, x_blk, mask = state.p, state.ap, state.r, state.x_blk, state.mask
    dtype = state.res.dtype
    # A-CholQR of P against AP
    u_inv, breakdown = _cholqr_factor(psum(ops.gram(ap, p), group), mask, dtype)
    p = ops.mix(p, u_inv)
    ap = ops.mix(ap, u_inv)
    # alpha and update
    alpha = psum(ops.gram(p, r), group)
    x_blk = ops.update(x_blk, p, alpha)
    r = ops.downdate(r, ap, alpha)
    res = torch.sqrt(torch.trace(psum(ops.gram(r, r), group)))
    # new direction: Z = M⁻¹R, A-orthogonalised against P
    z = m_apply(r)
    beta = psum(ops.gram(ap, z), group)
    p_new = ops.downdate(z, p, beta)
    if opts.adaptive:
        # rank-revealing pivoted Cholesky of PᵀP (BF-Omin)
        u2, piv, rank = pivoted_cholesky(psum(ops.gram(p_new, p_new), group), -1.0)
        bs = torch.sum(mask).to(rank.dtype)
        t1 = torch.minimum(rank, bs)
        new_mask = (torch.arange(mask.shape[0], device=mask.device) < t1).to(dtype)
        u2 = u2 + torch.diag((torch.diagonal(u2).abs() == 0).to(dtype))
        p_new = ops.scale_dirs(ops.right_solve(u2, ops.take_dirs(p_new, piv)),
                               new_mask)
        mask = new_mask
    p_new = ops.scale_dirs(p_new, mask)
    ap_new = a_apply(p_new)
    best_res, stall = _track_stall(state, res, opts.stall_rtol)
    return replace(
        state, x_blk=x_blk, r=r, p=p_new, ap=ap_new, z=z, mask=mask,
        it=state.it + 1, res=res, breakdown=state.breakdown | breakdown,
        history=_record(state, res, opts), best_res=best_res, stall=stall)


def _iter_odir(state: ECGPanelState, a_apply, m_apply, opts, normb, red_tol, ops,
               group=None):
    """One orthodir iteration (prealps_tpu/solvers/ecg.py:245-297)."""
    p, ap, r, x_blk, mask = state.p, state.ap, state.r, state.x_blk, state.mask
    p_prev, ap_prev = state.p_prev, state.ap_prev
    dtype = state.res.dtype
    u_inv, breakdown = _cholqr_factor(psum(ops.gram(ap, p), group), mask, dtype)
    p = ops.mix(p, u_inv)
    ap = ops.mix(ap, u_inv)
    alpha = psum(ops.gram(p, r), group)
    if opts.adaptive:
        alpha, p, ap, _, mask = _rotate_reduce(
            ops, alpha, p, ap, torch.zeros_like(p), mask, red_tol)
        if opts.adaptive_mode == "truncate":
            # drop the reduced directions, like the reference
            p = ops.scale_dirs(p, mask)
            ap = ops.scale_dirs(ap, mask)
    x_blk = ops.update(x_blk, p, alpha)
    r = ops.downdate(r, ap, alpha)
    res = torch.sqrt(torch.trace(psum(ops.gram(r, r), group)))
    # new direction: Z = M⁻¹AP, A-orthogonalised against [P, P_prev]
    z = m_apply(ap)
    beta1 = psum(ops.gram(ap, z), group)
    beta2 = psum(ops.gram(ap_prev, z), group)
    z = ops.downdate(z, p, beta1)
    z = ops.downdate(z, p_prev, beta2)
    z = ops.scale_dirs(z, mask)
    p_new = z
    if opts.adaptive and opts.adaptive_mode == "freeze":
        p_new = z + ops.scale_dirs(p, 1.0 - mask)
    ap_new = a_apply(p_new)
    best_res, stall = _track_stall(state, res, opts.stall_rtol)
    return replace(
        state, x_blk=x_blk, r=r, p=p_new, ap=ap_new,
        p_prev=ops.scale_dirs(p, mask), ap_prev=ops.scale_dirs(ap, mask),
        z=z, mask=mask, it=state.it + 1, res=res,
        breakdown=state.breakdown | breakdown,
        history=_record(state, res, opts), best_res=best_res, stall=stall)


def _iter_odir_fused(state: ECGPanelState, a_apply, m_apply, opts, normb,
                     red_tol, ops, group=None):
    """One ODIR-fused iteration with a single fused reduction of five t×t
    blocks (prealps_tpu/solvers/ecg.py:300-368): the Gram blocks are taken on
    the raw P/AP and corrected through the Cholesky factor afterwards."""
    p, ap, r, x_blk, mask = state.p, state.ap, state.r, state.x_blk, state.mask
    p_prev, ap_prev, z = state.p_prev, state.ap_prev, state.z
    dtype = state.res.dtype
    fused = psum(torch.stack([ops.gram(p, r), ops.gram(ap, z),
                              ops.gram(ap_prev, z), ops.gram(ap, p),
                              ops.gram(r, r)]), group)
    alpha, beta1, beta2, mu, rtr = fused.unbind(0)
    res = torch.sqrt(torch.trace(rtr))
    u_inv, breakdown = _cholqr_factor(mu, mask, dtype)
    p = ops.mix(p, u_inv)
    ap = ops.mix(ap, u_inv)
    z = ops.mix(z, u_inv)
    alpha = (u_inv.T @ alpha) * mask[:, None]
    beta1 = u_inv.T @ beta1 @ u_inv
    beta2 = beta2 @ u_inv
    # Z -= V beta
    z = ops.downdate(z, p, beta1)
    z = ops.downdate(z, p_prev, beta2)
    if opts.adaptive:
        alpha, p, ap, z, mask = _rotate_reduce(ops, alpha, p, ap, z, mask, red_tol)
    x_blk = ops.update(x_blk, p, alpha)
    r = ops.downdate(r, ap, alpha)
    # roll V; dropped directions are truncated unless adaptive_mode="freeze"
    z = ops.scale_dirs(z, mask)
    p_new = z
    if opts.adaptive and opts.adaptive_mode == "freeze":
        p_new = z + ops.scale_dirs(p, 1.0 - mask)
    ap_new = a_apply(p_new)
    z_new = m_apply(ap_new)
    best_res, stall = _track_stall(state, res, opts.stall_rtol)
    return replace(
        state, x_blk=x_blk, r=r, p=p_new, ap=ap_new,
        p_prev=ops.scale_dirs(p, mask), ap_prev=ops.scale_dirs(ap, mask),
        z=z_new, mask=mask, it=state.it + 1, res=res,
        breakdown=state.breakdown | breakdown,
        history=_record(state, res, opts), best_res=best_res, stall=stall)


_ITER_FNS = {
    "omin": _iter_omin,
    "odir": _iter_odir,
    "odir_fused": _iter_odir_fused,
}


def _iter_odir_fused_stacked(state: ECGState, a_apply, m_apply, opts: ECGOptions,
                             normb, red_tol, group=None) -> ECGState:
    """One stacked ODIR-fused iteration (prealps_tpu/solvers/ecg.py:413-505)."""
    w2 = state.w
    mask = state.mask
    dtype = w2.dtype
    dev = w2.device
    t = mask.shape[0]

    # --- ONE Gram: all five t×t reductions at once ---
    g = psum(w2 @ w2.T, group)
    gb = g.reshape(7, t, 7, t)
    alpha_raw = gb[_SP, :, _SR, :]      # PᵀR
    beta1_raw = gb[_SAP, :, _SZ, :]     # APᵀZ
    beta2_raw = gb[_SAPP, :, _SZ, :]    # AP_prevᵀZ
    mu = gb[_SAP, :, _SP, :]            # APᵀP
    rtr = gb[_SR, :, _SR, :]
    res = torch.sqrt(torch.trace(rtr))

    # --- factor + corrections ---
    ui, breakdown = _cholqr_factor(mu, mask, dtype)
    eye = torch.eye(t, dtype=dtype, device=dev)
    alpha = (ui.T @ alpha_raw) * mask[:, None]
    beta1 = ui.T @ beta1_raw @ ui
    beta2 = beta2_raw @ ui

    # --- adaptive reduction: the SVD rotation composes into C ---
    ui_b1 = ui @ beta1
    if opts.adaptive:
        u_svd, sig, _ = torch.linalg.svd(alpha)
        t1 = torch.sum(sig > red_tol)
        bs = torch.sum(mask).to(torch.int64)
        do_red = (t1 > 0) & (t1 < bs)
        new_bs = torch.where(do_red, t1, bs)
        mask = (torch.arange(t, device=dev) < new_bs).to(dtype)
        rot = torch.where(do_red, u_svd, eye)
        alpha = (rot.T @ alpha) * mask[:, None]
        ui = ui @ rot
        ui_b1 = ui_b1 @ rot
        beta2 = beta2 @ rot

    # --- compose the panel algebra into C: W'_a = Σ_b W_b C[b, a] ---
    ui_a = ui @ alpha
    act = mask[None, :]
    c = torch.zeros((7, t, 7, t), dtype=dtype, device=dev)
    c[_SX, :, _SX, :] = eye                      # X' = X + P̂ alpha
    c[_SP, :, _SX, :] = ui_a
    c[_SR, :, _SR, :] = eye                      # R' = R − AP̂ alpha
    c[_SAP, :, _SR, :] = -ui_a
    c[_SZ, :, _SP, :] = ui * act                 # P' = (Z Ui − P Ui β₁ − P_prev β₂)·mask
    p_from_p = -ui_b1 * act
    if opts.adaptive and opts.adaptive_mode == "freeze":
        p_from_p = p_from_p + ui * (1.0 - act)
    c[_SP, :, _SP, :] = p_from_p
    c[_SPP, :, _SP, :] = -beta2 * act
    c[_SP, :, _SPP, :] = ui * act                # P_prev' = P̂·mask
    c[_SAP, :, _SAPP, :] = ui * act              # AP_prev' = AP̂·mask
    wn = c.reshape(7 * t, 7 * t).T @ w2

    # --- operator + preconditioner fill the AP / Z slots ---
    p_new = wn[_SP * t:(_SP + 1) * t].reshape(state.panel_shape)
    ap_new = a_apply(p_new)
    z_new = m_apply(ap_new)
    wn[_SAP * t:(_SAP + 1) * t] = ap_new.reshape(t, -1)
    wn[_SZ * t:(_SZ + 1) * t] = z_new.reshape(t, -1)

    best_res, stall = _track_stall(state, res, opts.stall_rtol)
    return ECGState(
        w=wn, panel_shape=state.panel_shape, mask=mask, it=state.it + 1,
        res=res, breakdown=state.breakdown | breakdown,
        history=_record(state, res, opts), best_res=best_res, stall=stall,
    )


def _iter_omin_stacked(state: ECGState, a_apply, m_apply, opts: ECGOptions,
                       normb, red_tol, group=None) -> ECGState:
    """One stacked orthomin iteration (prealps_tpu/solvers/ecg.py:508-593).

    The flat (5t, N) state is storage only: the reductions are omin's own
    three (APᵀP with the entering RᵀR; PᵀR after normalising; APᵀZ), in the
    unstacked order. Taking alpha as Uiᵀ(PᵀR) off one big Gram instead (the
    odir_fused form) amplifies the raw Gram's f32 rounding by κ(U) and loses
    the true-residual tracking that makes omin the variant robust in f32."""
    w2 = state.w
    mask = state.mask
    dtype = w2.dtype
    t = mask.shape[0]

    # --- reduction 1: mu = APᵀP and the entering residual's RᵀR ---
    rows = w2[_OR * t:(_OAP + 1) * t]          # contiguous [R, P, AP] rows
    gb = psum(rows @ rows.T, group).reshape(3, t, 3, t)
    res = torch.sqrt(torch.trace(gb[0, :, 0, :]))
    ui, breakdown = _cholqr_factor(gb[2, :, 1, :], mask, dtype)
    # --- A-CholQR: P̂ = P·Ui, AP̂ = AP·Ui ---
    p_hat = ui.T @ w2[_OP * t:(_OP + 1) * t]
    ap_hat = ui.T @ w2[_OAP * t:(_OAP + 1) * t]

    # --- reduction 2: alpha on the normalised panel ---
    r_rows = w2[_OR * t:(_OR + 1) * t]
    alpha = psum(p_hat @ r_rows.T, group) * mask[:, None]
    x_rows = w2[_OX * t:(_OX + 1) * t] + alpha.T @ p_hat
    r_rows = r_rows - alpha.T @ ap_hat

    # --- Z = M⁻¹R' ---
    zf = m_apply(r_rows.reshape(state.panel_shape)).reshape(t, -1)

    # --- reduction 3: beta = AP̂ᵀZ; new direction P <- (Z − P̂β)·mask ---
    beta = psum(ap_hat @ zf.T, group)
    p_new = zf - beta.T @ p_hat
    if opts.adaptive:
        # BF-Omin rank test: pivoted Cholesky of PᵀP; the permutation and
        # the triangular solve compose into one t×t matrix
        u2, piv, rank = pivoted_cholesky(psum(p_new @ p_new.T, group), -1.0)
        t1 = torch.minimum(rank, torch.sum(mask).to(rank.dtype))
        mask = (torch.arange(t, device=w2.device) < t1).to(dtype)
        u2 = u2 + torch.diag((torch.diagonal(u2).abs() == 0).to(dtype))
        perm = torch.nn.functional.one_hot(piv, t).to(dtype)   # perm[r, piv[r]] = 1
        p_new = (perm.T @ tri_inv(u2)).T @ p_new
    p_new = p_new * mask[:, None]
    ap_new = a_apply(p_new.reshape(state.panel_shape)).reshape(t, -1)
    wn = torch.cat([x_rows, r_rows, p_new, ap_new, zf])

    best_res, stall = _track_stall(state, res, opts.stall_rtol)
    return ECGState(
        w=wn, panel_shape=state.panel_shape, mask=mask, it=state.it + 1,
        res=res, breakdown=state.breakdown | breakdown,
        history=_record(state, res, opts), best_res=best_res, stall=stall,
    )


def ecg_init(a_apply, m_apply, b: torch.Tensor, opts: ECGOptions,
             split_assign=None, group=None):
    """Initial state + normb (prealps_tpu/solvers/ecg.py:602-655): stacked
    for tbn + odir_fused or when asked for, unstacked otherwise. With a
    process group, b is this shard's part and every reduction is summed
    over the group."""
    stacked = _use_stacked(opts)
    ops = LAYOUTS[opts.layout]
    t = opts.t
    dtype = b.dtype
    dev = b.device
    normb = torch.sqrt(psum(torch.sum(b * b), group))
    r0 = split_rhs(b, t, split_assign, ops)
    # exactly-zero split columns would make the first A-CholQR singular:
    # move them behind the active prefix (stable order) and start with a
    # reduced mask; the column sum in ecg_finalize is order-invariant
    col2 = torch.diagonal(psum(ops.gram(r0, r0), group))
    nz = col2 > 0
    order = torch.argsort(torch.where(nz, 0, 1), stable=True)
    r0 = ops.take_dirs(r0, order)
    mask0 = (torch.arange(t, device=dev) < torch.sum(nz)).to(dtype)
    p0 = m_apply(r0)
    ap0 = a_apply(p0)
    z0 = m_apply(ap0) if opts.variant == "odir_fused" else torch.zeros_like(p0)
    zeros = torch.zeros_like(p0)
    common = dict(
        mask=mask0, it=0, res=normb.clone(),
        breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        history=torch.full((opts.maxiter,), -1.0, dtype=dtype, device=dev),
        best_res=normb.clone(),
        stall=torch.zeros((), dtype=torch.int32, device=dev))
    if stacked:
        slots = ([zeros, r0, p0, ap0, zeros] if opts.variant == "omin"
                 else [zeros, r0, p0, zeros, ap0, zeros, z0])
        w0 = torch.stack(slots).reshape(len(slots) * t, -1)
        return ECGState(w=w0, panel_shape=tuple(p0.shape), **common), normb
    return ECGPanelState(x_blk=zeros, r=r0, p=p0, ap=ap0, p_prev=zeros,
                         ap_prev=zeros, z=z0, **common), normb


def ecg_run(a_apply, m_apply, state, normb: torch.Tensor, opts: ECGOptions,
            max_steps: Optional[int] = None, group=None):
    """Iterate from ``state`` until convergence, maxiter, breakdown, an
    empty active block, a stall (stall_window > 0) or, with ``max_steps``,
    that many more iterations (the chunked-execution primitive)."""
    dtype = state.res.dtype
    sqrt_t = torch.sqrt(torch.tensor(float(opts.t), dtype=dtype, device=normb.device))
    red_tol = (opts.tol * normb / sqrt_t).to(dtype)
    tol_abs = (opts.tol * normb).to(dtype)
    if _use_stacked(opts):
        iter_fn = (_iter_omin_stacked if opts.variant == "omin"
                   else _iter_odir_fused_stacked)
        step = lambda s: iter_fn(s, a_apply, m_apply, opts, normb, red_tol,
                                 group)
    else:
        iter_fn, ops = _ITER_FNS[opts.variant], LAYOUTS[opts.layout]
        step = lambda s: iter_fn(s, a_apply, m_apply, opts, normb, red_tol, ops,
                                 group)

    it_stop = opts.maxiter if max_steps is None else min(opts.maxiter,
                                                          state.it + max_steps)
    while state.it < it_stop:
        ok = (state.res > tol_abs) & (torch.sum(state.mask) > 0) & ~state.breakdown
        if opts.stall_window > 0:
            ok = ok & (state.stall < opts.stall_window)
        # the one host synchronisation per step; with a group, ok is
        # computed from all-reduced values and so the same on every rank
        if not bool(ok):
            break
        state = step(state)
    return state


def ecg_finalize(state, normb: torch.Tensor, layout: str = "nt") -> ECGResult:
    """Sum the solution columns (a stacked state is always lane-major)."""
    if isinstance(state, ECGState):
        t = state.mask.shape[0]
        x = TBN.sum_dirs(state.w[_SX * t:(_SX + 1) * t].reshape(state.panel_shape))
    else:
        x = LAYOUTS[layout].sum_dirs(state.x_blk)
    return ECGResult(
        x=x,
        iters=state.it,
        res=state.res,
        normb=normb,
        bs=int(torch.sum(state.mask)),
        breakdown=bool(state.breakdown),
        history=state.history,
    )


def ecg_solve(
    a_apply: Callable[[torch.Tensor], torch.Tensor],
    m_apply: Optional[Callable[[torch.Tensor], torch.Tensor]],
    b: torch.Tensor,
    opts: ECGOptions,
    split_assign: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    group=None,
) -> ECGResult:
    """Solve A x = b from x = 0, or from ``x0`` (b's shape): then the
    solver works on the shifted system A·dx = b − A·x0 and returns x0 + dx.
    Panels are (m, t) for layout "nt" with b (m,), and (t, *space) for
    layout "tbn" with b (*space).

    a_apply / m_apply: panel -> panel operator callbacks (matrix-free).
    ``group``: the process group of a sharded solve (b, the panels and x
    are this shard's rows; ``split_assign`` gives global column ids), or
    None on one shard."""
    if m_apply is None:
        m_apply = lambda v: v
    if x0 is not None:
        x0 = x0.to(b.dtype)
        if opts.layout == "nt":
            r0 = b - a_apply(x0[:, None])[:, 0]
        else:
            r0 = b - a_apply(x0[None])[0]
        res = ecg_solve(a_apply, m_apply, r0, opts, split_assign, group=group)
        return res._replace(x=res.x + x0)
    state0, normb = ecg_init(a_apply, m_apply, b, opts, split_assign, group)
    final = ecg_run(a_apply, m_apply, state0, normb, opts, group=group)
    return ecg_finalize(final, normb, opts.layout)
