"""High-level single-device solver API for general sparse matrices.

The PyTorch counterpart of ``prealps_tpu/api.py`` (reference:
examples/test_ecg_prealps_op.c, test_lorasc.c): scale the operator
(``sym_rac_scaling``), build the preconditioner (block Jacobi, LORASC,
PRESC or none) and order the operator as it needs (the block-arrow
permutation), hold it in ELL on ``device`` and run ECG through
``ell_spmm``; ``solve`` undoes the permutation and the scaling.

float32 builds asked for a tolerance below 1e-3 run mixed-precision
iterative refinement, as the JAX package does: each inner ECG solve runs
to 1e-3 (stall window 250 unless set), and the residual of each round is
computed on the host in f64; rounds stop at the target tolerance, when a
round improves the residual by less than 10 %, or on a breakdown.

``device`` defaults to "cuda" and raises without a card (pass
device="cpu" to run on the host); every operand of the solve lives there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.partition import permute
from prealps_tpu_torch.core.scaling import sym_rac_scaling
from prealps_tpu_torch.ops.formats import EllMatrix, csr_to_ell
from prealps_tpu_torch.ops.spmm import ell_spmm
from prealps_tpu_torch.solvers.ecg import ECGOptions, ecg_solve
from prealps_tpu_torch.solvers.refine import INNER_TOL, STALL_WINDOW, refine_solve


@dataclass
class ECGSolver:
    """Build once, solve many, on one device."""

    opts: ECGOptions
    ell: EllMatrix                   # the scaled (and permuted) operator
    precond: object                  # the preconditioner object, or None
    dtype: np.dtype
    device: torch.device
    n: int
    target_tol: float
    perm: Optional[np.ndarray] = None
    scale_d: Optional[np.ndarray] = None
    a_solver: Optional[sp.csr_matrix] = None   # host f64 matrix of the rounds
    timings: dict = field(default_factory=dict)

    @classmethod
    def build(cls, a: sp.spmatrix, opts: ECGOptions = ECGOptions(),
              precond: str = "block_jacobi", scale: bool = True, dtype=None,
              device="cuda", **precond_kwargs) -> "ECGSolver":
        dev = resolve_device(device)
        strict_fp32()
        t_all = time.perf_counter()
        a = sp.csr_matrix(a)
        dtype = np.dtype(dtype) if dtype is not None else a.dtype
        target_tol = opts.tol
        refine = dtype == np.float32 and opts.tol < INNER_TOL
        if refine:
            opts = replace(opts, tol=INNER_TOL,
                           stall_window=opts.stall_window or STALL_WINDOW)
        timings = {}
        t0 = time.perf_counter()
        scale_d = None
        if scale:
            a, scale_d = sym_rac_scaling(a)
        timings["scale"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        perm, m_obj, a_solver = None, None, a
        if precond in ("block_jacobi", "bj"):
            from prealps_tpu_torch.precond.block_jacobi import build_block_jacobi

            m_obj = build_block_jacobi(a, dtype=dtype, device=dev, **precond_kwargs)
        elif precond in ("lorasc", "presc"):
            if precond == "lorasc":
                from prealps_tpu_torch.precond.lorasc import build_lorasc as build_precond
            else:
                from prealps_tpu_torch.precond.presc import build_presc as build_precond
            m_obj, arrow = build_precond(a, dtype=dtype, device=dev, **precond_kwargs)
            perm = arrow.perm
            a_solver = permute(a, perm)
        elif precond not in ("none", "identity", "noprec"):
            raise ValueError(f"unknown preconditioner {precond!r}")
        timings["precond"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ell = csr_to_ell(a_solver, dtype=dtype, device=dev)
        timings["ell"] = time.perf_counter() - t0
        timings["total"] = time.perf_counter() - t_all
        return cls(opts=opts, ell=ell, precond=m_obj, dtype=dtype, device=dev,
                   n=a.shape[0], target_tol=target_tol, perm=perm,
                   scale_d=scale_d, a_solver=a_solver if refine else None,
                   timings=timings)

    def operands(self) -> dict:
        """Every tensor the solve reads, by name (the ELL operator's and the
        preconditioner's, nested dataclasses flattened)."""
        out = {}

        def walk(prefix, obj):
            if isinstance(obj, torch.Tensor):
                out[prefix] = obj
            elif is_dataclass(obj):
                for f in fields(obj):
                    walk(f"{prefix}.{f.name}", getattr(obj, f.name))

        walk("ell", self.ell)
        walk("precond", self.precond)
        return out

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmm(self.ell, x)

    def _solve_permuted(self, b_perm: np.ndarray):
        """One device solve in the scaled and permuted space."""
        b_t = torch.from_numpy(b_perm.astype(self.dtype)).to(self.device)
        m_apply = self.precond.apply if self.precond is not None else None
        res = ecg_solve(self.a_apply, m_apply, b_t, self.opts)
        info = {"iters": int(res.iters), "res": float(res.res),
                "normb": float(res.normb), "bs": int(res.bs),
                "breakdown": bool(res.breakdown),
                "history": res.history.cpu().numpy()}
        return res.x.cpu().numpy().astype(np.float64), info

    def solve(self, b: np.ndarray, max_refine_rounds: int = 8):
        """x (original ordering, f64) and the info dict of the JAX package:
        iters, res, normb, bs, breakdown, history, and refine_rounds for a
        refined f32 build."""
        b = np.asarray(b)
        b_eff = (self.scale_d * b if self.scale_d is not None else b).astype(np.float64)
        if self.perm is not None:
            b_eff = b_eff[self.perm]

        if self.a_solver is None:
            x, info = self._solve_permuted(b_eff)
        else:
            x, info = refine_solve(self.a_solver, b_eff, self._solve_permuted,
                                   self.target_tol, max_rounds=max_refine_rounds,
                                   host_res=False)

        if self.perm is not None:
            x_out = np.empty_like(x)
            x_out[self.perm] = x
            x = x_out
        if self.scale_d is not None:
            x = self.scale_d * x
        return x, info
