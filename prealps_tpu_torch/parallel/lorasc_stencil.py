"""Single-GPU ECG + scalable LORASC driver for stencil operators.

The PyTorch counterpart of ``prealps_tpu/parallel/lorasc_stencil.py``
(reference analog: examples/test_lorasc.c driving lorasc.c). The ECG loop
runs on lane-major (t, br, nrb) panels in the original ordering with the
stencil operator; the preconditioner (precond/lorasc_scale.py) works in
arrow coordinates through node-level gathers. Every operator product goes
through the lane-major stencil kernel (``ops/spmm.py::stencil_bsr_spmm_t``,
B2a): the ECG iteration, two per preconditioner apply, the build's Lanczos
and lift panels, and A·x_lo in the refinement finish; the finish's f32
matrix-rounding term A_lo·x_hi runs B2b on the pre-extended panel.

Solve:
  * float64 (or tol above ``inner_tol``): one ECG solve on the device; in
    f64 every operand is f64 and every product B2a's f64 instance on the
    card (the JAX driver's f64 solve, through XLA there).
  * float32 with tol below ``inner_tol``: device-resident double-float
    refinement. Each round runs ECG to ``inner_tol`` (stall window 250),
    folds the correction into x = x_hi + x_lo, and recomputes the residual
    with A·x_hi in double-float, A·x_lo in f32 and the rounding correction
    A_lo·x_hi, A_lo = A − f32(A) (``_stencil_lo_blocks``). Both halves of x
    are fetched once at the end and checked against a host f64 residual;
    host-f64 rounds (``solvers/refine.py::refine_solve``) polish a
    shortfall. ``solve(host_rounds=True)``, the port's counterpart of the JAX
    driver's ``PREALPS_HOST_REFINE=1``, runs that host loop from zero instead.

Operator storage (``a_store``, f32 builds only; the build always runs from
the f32 blocks): ``"bf16"`` attaches a bf16 copy ``a_stencil_m`` that the
preconditioner's two sweep products use (B2a's bf16-block instance), while
the iteration operator stays f32; ``"bf16_all"`` makes the iteration
operator bf16 too, with the finish's correction A_lo = A − bf16(A) in f32.
bf16(A) of the het operator is indefinite, so ``"bf16_all"`` breaks down:
it is kept for measurement, as in the JAX package.

Differences from the JAX driver: no jit caches, no chunked dispatch and no
speculative finish (``ecg_run`` runs each round to its stop and the finish
runs once per round), no rhs residency.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.scaling import sym_rac_scaling
from prealps_tpu_torch.ops.doublefloat import df_add
from prealps_tpu_torch.ops.formats import StencilBsrTMatrix, csr_to_stencil_bsr_t
from prealps_tpu_torch.ops.spmm import (
    extend_wrap,
    stencil_bsr_spmm_t,
    stencil_pallas_bs_ext,
    stencil_scan_accumulate_df,
)
from prealps_tpu_torch.precond.lorasc_scale import (
    ScalableLorasc,
    build_scalable_lorasc,
    lorasc_apply,
)
from prealps_tpu_torch.solvers.ecg import (
    ECGOptions,
    ECGResult,
    ecg_finalize,
    ecg_init,
    ecg_run,
)
from prealps_tpu_torch.solvers.refine import (INNER_TOL, STALL_RATIO, STALL_WINDOW,
                                              refine_solve)


@dataclass
class StencilLorascECG:
    """Build once, solve many. See module docstring."""

    n: int
    br: int
    nrb: int
    opts: ECGOptions
    scale_d: Optional[np.ndarray]
    precond: ScalableLorasc
    device: torch.device
    target_tol: float = 0.0
    a_scaled: Optional[sp.csr_matrix] = None   # kept when refining

    @classmethod
    def build(
        cls,
        a: sp.spmatrix,
        nparts: int = 8,
        br: int = 3,
        grid: tuple[int, int, int] | None = None,
        opts: ECGOptions = ECGOptions(layout="tbn"),
        deflation_tol: float = 1e-2,
        max_deflation: int = 64,
        ncv: int | None = None,
        scale: bool = True,
        dtype=None,
        refine: Optional[bool] = None,
        inner_tol: float = INNER_TOL,
        shift: float = 0.0,
        pencil: str = "agg",
        host_refine: bool | None = None,
        correction: str = "sigma",
        restarts: int = 5,
        node_part=None,
        in_sep=None,
        factor_store: str = "auto",
        a_store: str | None = None,
        device="cuda",
        precond: ScalableLorasc | None = None,
    ) -> "StencilLorascECG":
        """Scale ``a``, convert it to the lane-major stencil format on
        ``device`` and build the LORASC preconditioner (or take ``precond``,
        a preconditioner already built for the scaled operator, e.g. by
        ``interop.lorasc_from_reference``). Options are the JAX driver's
        (``a_store`` None is "f32")."""
        device = resolve_device(device)
        strict_fp32()
        if opts.layout != "tbn":
            raise ValueError("StencilLorascECG requires layout='tbn'")
        a_store = a_store or "f32"
        if a_store not in ("f32", "bf16", "bf16_all"):
            raise ValueError(f"a_store must be f32 | bf16 | bf16_all, got {a_store!r}")
        a = sp.csr_matrix(a)
        dtype = np.dtype(dtype) if dtype is not None else a.dtype
        scale_d = None
        if scale:
            a, scale_d = sym_rac_scaling(a)
        target_tol = opts.tol
        if refine is None:
            refine = dtype == np.float32 and opts.tol < inner_tol
        if refine:
            opts = replace(opts, tol=inner_tol,
                           stall_window=opts.stall_window or STALL_WINDOW)
        if precond is None:
            a_t = csr_to_stencil_bsr_t(a, br=br, dtype=dtype, device=device)
            if a_t is None:
                raise ValueError("matrix is not stencil-structured")
            precond = build_scalable_lorasc(
                a, nparts=nparts, br=br, grid=grid,
                deflation_tol=deflation_tol, max_deflation=max_deflation,
                ncv=ncv, dtype=dtype, shift=shift, a_stencil=a_t,
                pencil=pencil, host_refine=host_refine, correction=correction,
                restarts=restarts, node_part=node_part, in_sep=in_sep,
                factor_store=factor_store, device=device)
        ops = precond.operands
        store = torch.float32
        if a_store != "f32" and dtype == np.float32:
            a_t = ops["a_stencil"]
            a_bf = StencilBsrTMatrix(a_t.blocks_t.to(torch.bfloat16),
                                     a_t.offsets, a_t.shape)
            if a_store == "bf16_all":
                ops["a_stencil"], store = a_bf, torch.bfloat16
            else:
                ops["a_stencil_m"] = a_bf
        if refine and dtype == np.float32:
            # lo half of the f64 -> store operator rounding, A = A_st + A_lo:
            # without it the device residual reads below the true one
            ops["a_lo_blocks"] = _stencil_lo_blocks(
                a, ops["a_stencil"], br, store_dtype=store).to(device)
        n = a.shape[0]
        return cls(n=n, br=br, nrb=n // br, opts=opts, scale_d=scale_d,
                   precond=precond, device=device, target_tol=target_tol,
                   a_scaled=a if refine else None)

    def with_tol(self, tol: float, inner_tol: float = INNER_TOL,
                 refine: Optional[bool] = None) -> "StencilLorascECG":
        """A solver at another target tolerance sharing this built
        preconditioner (the LORASC build does not depend on the tolerance)."""
        dtype = self.precond.operands["sep_mask"].dtype
        if refine is None:
            refine = dtype == torch.float32 and tol < inner_tol
        if refine and self.a_scaled is None:
            raise ValueError("refined with_tol() needs a_scaled from a "
                             "refined original build")
        opts = replace(
            self.opts, tol=inner_tol if refine else tol,
            stall_window=self.opts.stall_window or (STALL_WINDOW if refine else 0))
        return replace(self, opts=opts, target_tol=tol,
                       a_scaled=self.a_scaled if refine else None)

    # --- operator callbacks -------------------------------------------------

    def _a_apply(self, x: torch.Tensor) -> torch.Tensor:
        return stencil_bsr_spmm_t(self.precond.operands["a_stencil"], x)

    def _m_apply(self, r: torch.Tensor) -> torch.Tensor:
        return lorasc_apply(self.precond.plan, self.precond.operands, r)

    def _split_assign(self) -> torch.Tensor:
        """(br, nrb) rhs split: dof r·br + k goes to column (dof·t) // n."""
        grow = (torch.arange(self.nrb, device=self.device)[None, :] * self.br
                + torch.arange(self.br, device=self.device)[:, None])
        return (grow * self.opts.t) // self.n

    def _ecg(self, b: torch.Tensor) -> ECGResult:
        """One ECG solve of the (br, nrb) lane-major rhs ``b``."""
        state, normb = ecg_init(self._a_apply, self._m_apply, b, self.opts,
                                split_assign=self._split_assign())
        state = ecg_run(self._a_apply, self._m_apply, state, normb, self.opts)
        return ecg_finalize(state, normb, self.opts.layout)

    # --- solves ---------------------------------------------------------------

    def _solve_scaled_once(self, b_eff: np.ndarray):
        dtype = self.precond.operands["sep_mask"].dtype
        b_lane = torch.from_numpy(np.ascontiguousarray(
            b_eff.reshape(self.nrb, self.br).T)).to(device=self.device, dtype=dtype)
        res = self._ecg(b_lane)
        x = res.x.T.reshape(-1).cpu().numpy().astype(np.float64)
        info = {"iters": int(res.iters), "res": float(res.res),
                "normb": float(res.normb), "breakdown": bool(res.breakdown),
                "deflated": self.precond.deflated}
        return x, info

    def _finish(self, res: ECGResult, x2: torch.Tensor, b2: torch.Tensor):
        """End of a refinement round on the device: fold the round's
        correction into the double-float solution x2 = (x_hi, x_lo) and
        recompute the double-float residual r = b − A x. Returns (x2, r2,
        rnorm) with rnorm = ‖r_hi‖ as a 0-d tensor."""
        ops = self.precond.operands
        a_t = ops["a_stencil"]
        halo = max(abs(o) for o in a_t.offsets)
        xh, xl = df_add((x2[0], x2[1]), (res.x, torch.zeros_like(res.x)))
        x_ext = extend_wrap(xh[None], halo).contiguous()
        yh, yl = stencil_scan_accumulate_df(a_t.blocks_t, a_t.offsets, x_ext, halo)
        y2 = stencil_bsr_spmm_t(a_t, xl[None])
        rh, rl = df_add((b2[0][None], b2[1][None]), (-yh, -yl))
        rh, rl = df_add((rh, rl), (-y2, torch.zeros_like(y2)))
        if "a_lo_blocks" in ops:
            # the matrix-rounding correction A_lo·x_hi (see _stencil_lo_blocks)
            y3 = stencil_pallas_bs_ext(ops["a_lo_blocks"], a_t.offsets, x_ext, halo)
            rh, rl = df_add((rh, rl), (-y3, torch.zeros_like(y3)))
        rnorm = torch.sqrt(torch.sum(rh[0] * rh[0]))
        return torch.stack([xh, xl]), torch.stack([rh[0], rl[0]]), rnorm

    def _solve_refined_device(self, b_eff: np.ndarray, max_refine_rounds: int = 8):
        """Mixed-precision refinement with device-resident state: x and the
        double-float residual stay on the device across rounds; per round
        the host reads the ECG stop and one residual norm. Both halves of x
        come back once at the end for the host f64 cross-check."""
        normb0 = float(np.linalg.norm(b_eff))
        b_pad = np.ascontiguousarray(b_eff.reshape(self.nrb, self.br).T)
        b_hi = b_pad.astype(np.float32)
        b_lo = (b_pad - b_hi.astype(np.float64)).astype(np.float32)
        b2 = torch.from_numpy(np.stack([b_hi, b_lo])).to(self.device)
        x2 = torch.zeros_like(b2)
        r2 = b2
        rnorm = normb0
        prev_relres = np.inf
        total_iters, rounds, breakdown = 0, 0, False
        for _ in range(max_refine_rounds):
            relres = rnorm / normb0 if normb0 else 0.0
            if relres <= self.target_tol or relres > STALL_RATIO * prev_relres:
                break
            prev_relres = relres
            res = self._ecg(r2[0])
            x2, r2, rnorm_t = self._finish(res, x2, b2)
            rnorm = float(rnorm_t)
            total_iters += int(res.iters)
            rounds += 1
            if res.breakdown:
                breakdown = True
                break
        x_np = x2.cpu().numpy().astype(np.float64)
        x = np.ascontiguousarray((x_np[0] + x_np[1]).T).reshape(-1)
        r = b_eff - self.a_scaled @ x        # host f64 cross-check
        res_norm = float(np.linalg.norm(r))
        info = {"iters": total_iters, "res": res_norm, "normb": normb0,
                "breakdown": breakdown, "refine_rounds": rounds,
                "device_rounds": rounds,
                "relres_scaled": res_norm / normb0 if normb0 else 0.0}
        return x, info

    def solve(self, b: np.ndarray, max_refine_rounds: int = 8,
              host_rounds: bool = False):
        """Solve A x = b (original scaling). Returns (x, info)."""
        b = np.asarray(b)
        b_eff = self.scale_d * b if self.scale_d is not None else b.astype(np.float64)
        if self.a_scaled is None:
            x, info = self._solve_scaled_once(b_eff)
        elif host_rounds:
            x, info = refine_solve(self.a_scaled, b_eff, self._solve_scaled_once,
                                   self.target_tol, max_rounds=max_refine_rounds)
            info["device_rounds"] = 0
        else:
            x, info = self._solve_refined_device(b_eff, max_refine_rounds)
            if info["relres_scaled"] > self.target_tol and not info["breakdown"]:
                # host-f64 polish after a device shortfall; like the JAX
                # driver's, it runs without the stall test
                x, polish = refine_solve(
                    self.a_scaled, b_eff, self._solve_scaled_once,
                    self.target_tol, max_rounds=max_refine_rounds,
                    stop_ratio=np.inf, x0=x, iters0=info["iters"],
                    rounds0=info["refine_rounds"])
                for key in ("iters", "refine_rounds", "breakdown", "res",
                            "relres_scaled"):
                    info[key] = polish[key]
        info["deflated"] = self.precond.deflated
        if self.scale_d is not None:
            x = self.scale_d * x
        return x, info


def _stencil_lo_blocks(a: sp.spmatrix, a_t: StencilBsrTMatrix, br: int,
                       store_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(S, br, br, nrb) f32 blocks of A_lo = A − store(A) for the stencil
    offsets of ``a_t`` (the layout of StencilBsrTMatrix.blocks_t), on the
    host; store() rounds to the type the solve's A blocks are kept in (f32,
    or bf16 for ``a_store="bf16_all"``; torch rounds to nearest even). The
    correction is kept in f32: its own rounding then sits far below the
    refinement's residual floor."""
    coo = sp.csr_matrix(a).tocoo()
    nrb = a.shape[0] // br
    offs = np.asarray(a_t.offsets)
    slot = np.searchsorted(offs, (coo.col // br) - (coo.row // br))
    vals_st = torch.from_numpy(coo.data).to(store_dtype).to(torch.float64).numpy()
    lo_vals = (coo.data - vals_st).astype(np.float32)
    lo = np.zeros((offs.size, br, br, nrb), dtype=np.float32)
    lo[slot, coo.row % br, coo.col % br, coo.row // br] = lo_vals
    return torch.from_numpy(lo)
