"""Enlarged Conjugate Gradient (ECG), stacked ODIR-fused variant.

The PyTorch counterpart of ``prealps_tpu/solvers/ecg.py`` for the path the
headline solve takes: layout "tbn", variant "odir_fused", stacked state.
The seven solver panels [X, R, P, P_prev, AP, AP_prev, Z] live in ONE flat
(7t, N) tensor, so an iteration is

    G  = W Wᵀ                      one (7t)² Gram (all five t×t reductions)
    W' = Cᵀ W                      one coefficient GEMM composing the update
    AP', Z' slots <- A·P', M⁻¹AP'  operator + preconditioner callbacks

with the t×t algebra (masked Cholesky, triangular inverse, corrections,
optional adaptive SVD rotation) in between. ``lax.while_loop`` becomes a
Python loop with the same stop rules (residual vs tol, maxiter, active
block size, breakdown, stall window); evaluating them costs one host
synchronisation per iteration.

Other variants (omin, odir, unstacked odir_fused) and the row-major "nt"
layout are not ported yet (ROADMAP.md queue A, item 1): ``ecg_solve``
raises NotImplementedError for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from prealps_tpu_torch.ops.blockops import chol_masked, psum, tri_inv
from prealps_tpu_torch.solvers.panels import TBN


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
    """Stacked solver state. ``w`` is (7t, N) with slots _SX.._SZ; the
    scalars stay on the device so an iteration needs no host round trip
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


_SX, _SR, _SP, _SPP, _SAP, _SAPP, _SZ = range(7)

_LATER = ("not ported yet (ROADMAP.md queue A, item 1): the PyTorch port "
          "runs the stacked odir_fused step on layout='tbn'")


def _check_supported(opts: ECGOptions) -> None:
    if opts.variant != "odir_fused" or opts.layout != "tbn" or opts.stacked is False:
        raise NotImplementedError(
            f"ECG variant={opts.variant!r} layout={opts.layout!r} "
            f"stacked={opts.stacked!r} is {_LATER}")


def _track_stall(state: ECGState, res, stall_rtol):
    # an improvement below stall_rtol does not count as progress
    improved = res < (1.0 - stall_rtol) * state.best_res
    best = torch.minimum(state.best_res, res)
    stall = torch.where(improved, torch.zeros_like(state.stall), state.stall + 1)
    return best, stall


def split_rhs(b: torch.Tensor, t: int, assign=None) -> torch.Tensor:
    """Split rhs b into t disjoint groups; default: contiguous equal split of
    the flattened entries."""
    if assign is None:
        m = b.numel()
        assign = ((torch.arange(m, device=b.device) * t) // m).reshape(b.shape)
    return TBN.split(b, t, assign)


def _iter_odir_fused_stacked(state: ECGState, a_apply, m_apply, opts: ECGOptions,
                             normb, red_tol) -> ECGState:
    """One stacked ODIR-fused iteration (prealps_tpu/solvers/ecg.py:413-505)."""
    w2 = state.w
    mask = state.mask
    dtype = w2.dtype
    dev = w2.device
    t = mask.shape[0]

    # --- ONE Gram: all five t×t reductions at once ---
    g = psum(w2 @ w2.T)
    gb = g.reshape(7, t, 7, t)
    alpha_raw = gb[_SP, :, _SR, :]      # PᵀR
    beta1_raw = gb[_SAP, :, _SZ, :]     # APᵀZ
    beta2_raw = gb[_SAPP, :, _SZ, :]    # AP_prevᵀZ
    mu = gb[_SAP, :, _SP, :]            # APᵀP
    rtr = gb[_SR, :, _SR, :]
    res = torch.sqrt(torch.trace(rtr))

    # --- factor + corrections ---
    u = chol_masked(mu, mask)
    breakdown = torch.isnan(u).any()
    eye = torch.eye(t, dtype=dtype, device=dev)
    u = torch.where(breakdown, eye, u)
    ui = tri_inv(u)
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
    history = state.history
    if opts.record_history:
        history = history.clone()
        history[state.it] = res
    return ECGState(
        w=wn, panel_shape=state.panel_shape, mask=mask, it=state.it + 1,
        res=res, breakdown=state.breakdown | breakdown, history=history,
        best_res=best_res, stall=stall,
    )


def ecg_init(a_apply, m_apply, b: torch.Tensor, opts: ECGOptions,
             split_assign=None):
    """Initial stacked state + normb (prealps_tpu/solvers/ecg.py:602-655)."""
    _check_supported(opts)
    t = opts.t
    dtype = b.dtype
    dev = b.device
    normb = torch.sqrt(psum(torch.sum(b * b)))
    r0 = split_rhs(b, t, split_assign)
    # exactly-zero split columns would make the first A-CholQR singular:
    # move them behind the active prefix (stable order) and start with a
    # reduced mask; the column sum in ecg_finalize is order-invariant
    col2 = torch.diagonal(psum(TBN.gram(r0, r0)))
    nz = col2 > 0
    order = torch.argsort(torch.where(nz, 0, 1), stable=True)
    r0 = TBN.take_dirs(r0, order)
    mask0 = (torch.arange(t, device=dev) < torch.sum(nz)).to(dtype)
    p0 = m_apply(r0)
    ap0 = a_apply(p0)
    z0 = m_apply(ap0)
    zeros = torch.zeros_like(p0)
    w0 = torch.stack([zeros, r0, p0, zeros, ap0, zeros, z0])
    w0 = w0.reshape(7 * t, -1)
    history = torch.full((opts.maxiter,), -1.0, dtype=dtype, device=dev)
    state0 = ECGState(
        w=w0, panel_shape=tuple(p0.shape), mask=mask0, it=0,
        res=normb.clone(), breakdown=torch.zeros((), dtype=torch.bool, device=dev),
        history=history, best_res=normb.clone(),
        stall=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return state0, normb


def ecg_run(a_apply, m_apply, state: ECGState, normb: torch.Tensor,
            opts: ECGOptions) -> ECGState:
    """Iterate from ``state`` until convergence, maxiter, breakdown, an
    empty active block or a stall (stall_window > 0)."""
    _check_supported(opts)
    dtype = state.res.dtype
    sqrt_t = torch.sqrt(torch.tensor(float(opts.t), dtype=dtype, device=normb.device))
    red_tol = (opts.tol * normb / sqrt_t).to(dtype)
    tol_abs = (opts.tol * normb).to(dtype)

    while state.it < opts.maxiter:
        ok = (state.res > tol_abs) & (torch.sum(state.mask) > 0) & ~state.breakdown
        if opts.stall_window > 0:
            ok = ok & (state.stall < opts.stall_window)
        if not bool(ok):            # the one host synchronisation per step
            break
        state = _iter_odir_fused_stacked(state, a_apply, m_apply, opts, normb,
                                         red_tol)
    return state


def ecg_finalize(state: ECGState, normb: torch.Tensor) -> ECGResult:
    """Sum the solution columns."""
    t = state.mask.shape[0]
    x_blk = state.w[_SX * t:(_SX + 1) * t].reshape(state.panel_shape)
    return ECGResult(
        x=TBN.sum_dirs(x_blk),
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
) -> ECGResult:
    """Solve A x = b from x = 0 on lane-major panels: b is (*space), panels
    (t, *space).

    a_apply / m_apply: panel -> panel operator callbacks (matrix-free)."""
    if m_apply is None:
        m_apply = lambda v: v
    state0, normb = ecg_init(a_apply, m_apply, b, opts, split_assign)
    final = ecg_run(a_apply, m_apply, state0, normb, opts)
    return ecg_finalize(final, normb)
