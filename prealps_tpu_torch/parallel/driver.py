"""DistributedECG on one GPU: stencil operator, two-level block Jacobi, ECG.

The PyTorch counterpart of ``prealps_tpu/parallel/driver.py`` for the path
of the headline solve: ``fmt="stencil"``, ``layout="tbn"``,
``precond="bj2l"``, one device (``nshards=1``), float32 or float64.

Build (host, then device):
  RAC scaling -> contiguous row layout with padded identity rows -> stencil
  block table (flat (S·br², nrb) on the device) -> device block-Jacobi
  inverses -> geometric rigid-body coarse space and its banded-Cholesky
  coarse inverse on the host.

Solve:
  * float64 (or tol above ``inner_tol``): one ECG solve on the device.
  * float32 with tol below ``inner_tol``: iterative refinement on the
    device. Each round runs an f32 ECG solve to ``inner_tol`` (with a stall
    window) and recomputes the residual in double-float (compensated
    stencil SpMM), so the rounds reach tolerances below the f32 floor. The
    result is then checked against a host f64 residual, and host-f64
    refinement rounds polish it if the device rounds fell short.

The operator apply attaches single-shard wrap halos and runs the flat
stencil kernel (``ops/spmm.py::stencil_flat_ext``: the CUDA kernel on the
card, plain PyTorch on the CPU).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.layout import (
    RowLayout,
    contiguous_row_layout,
    pad_to_padded,
    permute_and_pad_matrix,
    unpad_from_padded,
)
from prealps_tpu_torch.core.scaling import sym_rac_scaling
from prealps_tpu_torch.direct.device_bj import build_device_block_jacobi_flat
from prealps_tpu_torch.ops.doublefloat import df_add
from prealps_tpu_torch.ops.formats import (
    panel_from_flat_kmajor,
    panel_to_flat_kmajor,
    stencil_blocks_host,
)
from prealps_tpu_torch.ops.spmm import (
    extend_wrap,
    stencil_flat_ext,
    stencil_scan_accumulate_df,
)
from prealps_tpu_torch.precond.twolevel import (
    bj2l_apply,
    coarse_matrix_host,
    geometric_rbm_modes,
)
from prealps_tpu_torch.solvers.ecg import ECGOptions, ECGResult, ecg_solve

MAX_REFINE_ROUNDS = 8
Q_MODES = 6          # rigid-body coarse modes per block (3-D elasticity)


def coarse_inverse_host(ac: np.ndarray) -> np.ndarray:
    """Explicit inverse of the (banded, SPD) coarse matrix.

    A_c = Zᵀ A Z is banded for slab-ordered blocks (block b couples only to
    b±1 when the stencil halo is smaller than a block), so a banded Cholesky
    and banded back-substitution give the inverse cheaply; dense Cholesky
    (and then LU) are the fallbacks when the band is wide or A_c is not
    numerically SPD. Returns the symmetrised inverse in float64."""
    nc = ac.shape[0]
    ii, jj = np.nonzero(np.abs(ac) > 0)
    bw = int(np.abs(ii - jj).max()) if ii.size else 0
    ac_inv = None
    if bw <= max(64, nc // 8):
        try:
            ab = np.zeros((bw + 1, nc))
            for kd in range(bw + 1):
                ab[bw - kd, kd:] = np.diagonal(ac, kd)
            cb = sla.cholesky_banded(ab)
            ac_inv = sla.cho_solve_banded((cb, False), np.eye(nc))
        except np.linalg.LinAlgError:
            ac_inv = None
    if ac_inv is None:
        try:
            c_f = sla.cho_factor(ac, overwrite_a=False)
            ac_inv = sla.cho_solve(c_f, np.eye(nc))
        except np.linalg.LinAlgError:
            ac_inv = sla.inv(ac)
    return 0.5 * (ac_inv + ac_inv.T)


@dataclass
class StencilOperands:
    """Device operands of the stencil + bj2l solve."""

    blocks_flat: torch.Tensor   # (S·br², nrb) block table
    offsets: tuple              # S node offsets
    br: int
    inv_f: torch.Tensor         # (nb, mb, mb) block inverses
    yq3: torch.Tensor           # (nb, q, mb) coarse modes
    ac_inv: torch.Tensor        # (nb·q, nb·q) coarse inverse

    @property
    def nrb(self) -> int:
        return int(self.blocks_flat.shape[1])

    @property
    def halo(self) -> int:
        return max(abs(o) for o in self.offsets)

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        """A·x for a lane-major panel x (t, br, nrb)."""
        x_ext = extend_wrap(panel_to_flat_kmajor(x), self.halo)
        yf = stencil_flat_ext(self.blocks_flat, self.offsets, x_ext, self.halo,
                              self.br)
        return panel_from_flat_kmajor(yf, self.br)

    def a_apply_df(self, x: torch.Tensor):
        """A·x in double-float for a lane-major panel: (y_hi, y_lo)."""
        blocks_t = self.blocks_flat.reshape(len(self.offsets), self.br,
                                            self.br, self.nrb)
        return stencil_scan_accumulate_df(blocks_t, self.offsets,
                                          extend_wrap(x, self.halo), self.halo)

    def m_apply(self, z: torch.Tensor) -> torch.Tensor:
        return bj2l_apply(self.inv_f, self.yq3, self.ac_inv, z)

    def split_assign(self, t: int, n_pad: int) -> torch.Tensor:
        """rhs split (br, nrb): global row (r·br + k) goes to column
        (row·t) // n_pad — a contiguous split into t chunks."""
        dev = self.blocks_flat.device
        r_idx = torch.arange(self.nrb, device=dev)[None, :]
        k_idx = torch.arange(self.br, device=dev)[:, None]
        return ((r_idx * self.br + k_idx) * t) // n_pad


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class DistributedECG:
    """Build once, solve many times (see module docstring)."""

    layout: RowLayout
    opts: ECGOptions
    scale_d: Optional[np.ndarray]          # RAC scaling vector
    operands: StencilOperands
    device: torch.device
    dtype: np.dtype
    target_tol: float = 0.0
    a_scaled: Optional[sp.csr_matrix] = None   # set when refining
    timings: dict = field(default_factory=dict)  # build stage wall times (s)

    @classmethod
    def build(
        cls,
        a: sp.spmatrix,
        nshards: Optional[int] = 1,
        opts: ECGOptions = ECGOptions(),
        precond: str = "bj2l",
        scale: bool = True,
        block_size: Optional[int] = None,
        dtype=None,
        fmt: str = "stencil",
        br: int = 3,
        refine: Optional[bool] = None,
        inner_tol: float = 1e-3,
        grid: Optional[tuple] = None,
        device="cuda",
    ) -> "DistributedECG":
        """Build the solver on ``device`` (default "cuda", which raises
        when there is no card; pass device="cpu" to run on the host)."""
        device = resolve_device(device)
        strict_fp32()
        if nshards not in (None, 1):
            raise NotImplementedError(
                f"nshards={nshards}: the multi-GPU driver is not ported yet "
                "(ROADMAP.md queue A, item 4)")
        if fmt != "stencil":
            raise NotImplementedError(
                f"fmt={fmt!r} is not ported yet (ROADMAP.md queue A, item 2); "
                "the port runs fmt='stencil'")
        if precond not in ("bj2l", "block_jacobi_2l"):
            raise NotImplementedError(
                f"precond={precond!r} is not ported yet (ROADMAP.md queue A, "
                "item 2); the port runs precond='bj2l'")
        if opts.layout != "tbn":
            raise ValueError("precond='bj2l' requires layout='tbn' "
                             f"(got {opts.layout!r})")
        if grid is None:
            raise NotImplementedError(
                "bj2l without grid= (translation-only coarse modes) is not "
                "ported yet (ROADMAP.md queue A, item 2); pass the node grid")
        a = sp.csr_matrix(a)
        tb: dict = {}
        mark = [time.perf_counter()]

        def stage(name):
            now = time.perf_counter()
            tb[name] = tb.get(name, 0.0) + (now - mark[0])
            mark[0] = now

        dtype = np.dtype(dtype) if dtype is not None else a.dtype
        if dtype not in (np.float32, np.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        scale_d = None
        if scale:
            a, scale_d = sym_rac_scaling(a)
        target_tol = opts.tol
        if refine is None:
            refine = dtype == np.float32 and opts.tol < inner_tol
        if refine:
            # inner solves stop on stagnation: an early stop just hands the
            # remaining work to the next refinement round
            opts = replace(opts, tol=inner_tol,
                           stall_window=opts.stall_window or 250)

        # device block Jacobi: node-block size, a multiple of 8 nodes
        mbn = max(8, (int(block_size or 1024) // br // 8) * 8)
        mult = math.lcm(math.lcm(8, br), mbn * br)
        layout = contiguous_row_layout(a.shape[0], 1, row_multiple=mult)
        a_pad = permute_and_pad_matrix(a, layout)
        stage("layout")

        host = stencil_blocks_host(a_pad, br=br, dtype=dtype)
        if host is None:
            raise ValueError("matrix is not stencil-structured")
        blocks_host, offsets = host
        s_off = len(offsets)
        n_pad = layout.n_pad
        nrb = n_pad // br
        if max(abs(o) for o in offsets) > nrb:
            raise ValueError(f"stencil halo exceeds the node count {nrb}")
        # flat (S·br², nrb) table: row s·br² + m·br + k
        blocks_flat = torch.from_numpy(np.ascontiguousarray(
            blocks_host.transpose(1, 2, 3, 0).reshape(s_off * br * br, nrb)
        )).to(device)
        del blocks_host
        _sync(device)
        stage("fmt_convert")

        blocks_t = blocks_flat.reshape(s_off, br, br, nrb)
        inv_f = build_device_block_jacobi_flat(blocks_t, offsets, mbn=mbn)
        nb = inv_f.shape[0]
        mb = br * mbn
        d_pad = pad_to_padded(layout, scale_d) if scale_d is not None else None
        y5 = geometric_rbm_modes(grid, br, nrb, mbn, scale_d=d_pad, q=Q_MODES)
        ac = coarse_matrix_host(a_pad, y5, br)
        # padded rows carry identity blocks; their modes can make A_c
        # ill-conditioned — regularise lightly
        nc = ac.shape[0]
        ac += 1e-10 * np.trace(ac) / nc * np.eye(nc)
        ac_inv = coarse_inverse_host(ac).astype(dtype)
        yq3 = np.ascontiguousarray(
            y5.transpose(0, 3, 1, 2).reshape(nb, -1, mb)).astype(dtype)
        operands = StencilOperands(
            blocks_flat=blocks_flat, offsets=offsets, br=br, inv_f=inv_f,
            yq3=torch.from_numpy(yq3).to(device),
            ac_inv=torch.from_numpy(ac_inv).to(device))
        _sync(device)
        stage("precond")
        return cls(
            layout=layout, opts=opts, scale_d=scale_d, operands=operands,
            device=device, dtype=dtype, target_tol=target_tol,
            a_scaled=a if refine else None, timings=tb,
        )

    # --- panels <-> host vectors ------------------------------------------

    def _to_lane_major(self, v_pad: np.ndarray) -> np.ndarray:
        """(n_pad,) padded vector -> (br, nrb)."""
        return np.ascontiguousarray(v_pad.reshape(-1, self.operands.br).T)

    def _from_lane_major(self, v: np.ndarray) -> np.ndarray:
        """(br, nrb) -> original-order vector."""
        return unpad_from_padded(self.layout,
                                 np.ascontiguousarray(v.T).reshape(-1))

    def _ecg(self, rhs: torch.Tensor) -> ECGResult:
        ops = self.operands
        return ecg_solve(ops.a_apply, ops.m_apply, rhs, self.opts,
                         split_assign=ops.split_assign(self.opts.t,
                                                       self.layout.n_pad))

    # --- solves ---------------------------------------------------------

    def _solve_scaled_once(self, b_eff: np.ndarray):
        """One device ECG solve of the scaled, padded system."""
        b_pad = pad_to_padded(self.layout, b_eff.astype(self.dtype))
        rhs = torch.from_numpy(self._to_lane_major(b_pad)).to(self.device)
        res = self._ecg(rhs)
        x = self._from_lane_major(res.x.cpu().numpy())
        info = {
            "iters": int(res.iters),
            "res": float(res.res),
            "normb": float(res.normb),
            "bs": int(res.bs),
            "breakdown": bool(res.breakdown),
            "history": res.history.cpu().numpy(),
        }
        return x.astype(np.float64), info

    def local_refine(self, b_hi: torch.Tensor, b_lo: torch.Tensor):
        """Mixed-precision iterative refinement on the device.

        b = b_hi + b_lo (double-float, lane-major (br, nrb)). Each round
        runs an f32 ECG solve on the current residual, adds the correction
        to x in double-float, and recomputes r = b − A·x with the
        compensated SpMM (A·x_hi in double-float, A·x_lo in f32). Stops
        when the target is reached, a round gains less than 10 %, the
        residual is NaN, the inner solve broke down, or after
        MAX_REFINE_ROUNDS rounds. Returns (x_hi, x_lo, info)."""
        ops = self.operands

        def resid(xh, xl):
            yh, yl = ops.a_apply_df(xh[None])
            y2 = ops.a_apply(xl[None])[0]
            rh, rl = df_add((b_hi, b_lo), (-yh[0], -yl[0]))
            return df_add((rh, rl), (-y2, torch.zeros_like(y2)))

        def gnorm(v):
            return torch.sqrt(torch.sum(v * v))

        normb = gnorm(b_hi)
        tol_s = torch.tensor(self.target_tol, dtype=b_hi.dtype,
                             device=b_hi.device)
        xh = torch.zeros_like(b_hi)
        xl = torch.zeros_like(b_hi)
        r = b_hi
        relres = torch.ones((), dtype=b_hi.dtype, device=b_hi.device)
        it_tot, rounds, brk, bs = 0, 0, False, self.opts.t
        history = torch.full((self.opts.maxiter,), -1.0, dtype=b_hi.dtype,
                             device=b_hi.device)
        stop = bool(relres <= tol_s)
        while rounds < MAX_REFINE_ROUNDS and not stop:
            res = self._ecg(r)
            xh, xl = df_add((xh, xl), (res.x, torch.zeros_like(res.x)))
            r, _ = resid(xh, xl)
            relres2 = gnorm(r) / normb
            stop = bool((relres2 <= tol_s) | (relres2 > 0.9 * relres)
                        | torch.isnan(relres2)) or res.breakdown
            relres = relres2
            it_tot += res.iters
            rounds += 1
            brk, bs, history = res.breakdown, res.bs, res.history
        info = {
            "iters": it_tot,
            "res": float(relres * normb),
            "normb": float(normb),
            "bs": int(bs),
            "breakdown": bool(brk),
            "refine_rounds": rounds,
            "history": history.cpu().numpy(),
        }
        return xh, xl, info

    def _solve_refined_device(self, b_eff: np.ndarray):
        """Device-resident refinement, then a host f64 cross-check."""
        b_pad = self._to_lane_major(pad_to_padded(self.layout, b_eff))  # f64
        b_hi = b_pad.astype(np.float32)
        b_lo = (b_pad - b_hi.astype(np.float64)).astype(np.float32)
        xh, xl, info = self.local_refine(
            torch.from_numpy(b_hi).to(self.device),
            torch.from_numpy(b_lo).to(self.device))
        x_np = (xh.cpu().numpy().astype(np.float64)
                + xl.cpu().numpy().astype(np.float64))
        x = self._from_lane_major(x_np)
        r = b_eff - self.a_scaled @ x
        info["res"] = float(np.linalg.norm(r))
        info["relres_scaled"] = float(info["res"] / np.linalg.norm(b_eff))
        return x, info

    def solve(self, b: np.ndarray, max_refine_rounds: int = MAX_REFINE_ROUNDS):
        """Solve A x = b (original ordering and scaling). Returns (x, info)."""
        b = np.asarray(b)
        b_eff = self.scale_d * b if self.scale_d is not None else b.astype(np.float64)

        if self.a_scaled is None:
            x, info = self._solve_scaled_once(b_eff)
        else:
            x0, info0 = None, None
            if self.dtype == np.float32:
                x0, info0 = self._solve_refined_device(b_eff)
                if (info0["relres_scaled"] <= self.target_tol
                        or info0["breakdown"]):
                    if self.scale_d is not None:
                        x0 = self.scale_d * x0
                    return x0, info0
            # the device rounds stopped above the target (or refinement was
            # requested in f64): host f64 residuals, device solves
            a = self.a_scaled
            normb = np.linalg.norm(b_eff)
            x = np.zeros_like(b_eff) if x0 is None else x0
            total_iters = 0 if info0 is None else info0["iters"]
            rounds = 0 if info0 is None else info0["refine_rounds"]
            info = {}
            prev_relres = np.inf
            for _ in range(max_refine_rounds):
                r = b_eff - a @ x
                relres = np.linalg.norm(r) / normb
                if relres <= self.target_tol:
                    break
                if relres > 0.9 * prev_relres:
                    break  # no meaningful progress: at the f32 floor
                prev_relres = relres
                dx, info = self._solve_scaled_once(r)
                x = x + dx
                total_iters += info["iters"]
                rounds += 1
                if info["breakdown"]:
                    break
            r = b_eff - a @ x
            info = dict(info or info0 or {})
            info["iters"] = total_iters
            info["refine_rounds"] = rounds
            info["res"] = float(np.linalg.norm(r))
            info["relres_scaled"] = float(np.linalg.norm(r) / normb)

        if self.scale_d is not None:
            x = self.scale_d * x
        return x, info
