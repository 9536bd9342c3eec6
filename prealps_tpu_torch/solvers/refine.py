"""Mixed-precision iterative refinement around an inner solver.

Numpy copy of ``prealps_tpu/solvers/refine.py``: float64 residuals on the
host, float32 inner solves on the device, until the f64 relative residual
of the scaled system meets the target tolerance. The LORASC driver
(parallel/lorasc_stencil.py) runs it from zero with ``host_rounds=True`` and,
from its device result, to polish a shortfall of its device-resident rounds."""

from __future__ import annotations

from typing import Callable

import numpy as np

# the mixed-precision rule of every refined f32 build: inner solves run to
# INNER_TOL and stop on STALL_WINDOW iterations without progress; rounds
# stop once a round cuts the f64 residual by less than STALL_RATIO
INNER_TOL = 1e-3
STALL_WINDOW = 250
STALL_RATIO = 0.9


def refine_solve(
    a_scaled,
    b_eff: np.ndarray,
    inner_solve: Callable[[np.ndarray], tuple[np.ndarray, dict]],
    target_tol: float,
    max_rounds: int = 8,
    stop_ratio: float = STALL_RATIO,
    x0: np.ndarray | None = None,
    iters0: int = 0,
    rounds0: int = 0,
    host_res: bool = True,
):
    """Iterate x += inner_solve(b − A x) from x0 (zero by default) until the
    f64 relative residual meets target_tol, progress stalls (relres >
    stop_ratio × previous; ``np.inf`` turns the test off), or max_rounds
    rounds are spent, ``rounds0`` of them (and ``iters0`` inner iterations)
    before the call. Returns (x, info) with info aggregating the inner
    iterations and the rounds, and ``breakdown`` from the last inner solve;
    ``res`` and ``relres_scaled`` are the final f64 residual's unless
    ``host_res`` is False, which keeps the last inner solve's ``res`` and
    adds no key (the single-device ECGSolver's info, as JAX's)."""
    normb = np.linalg.norm(b_eff)
    x = np.zeros_like(b_eff) if x0 is None else x0
    total_iters, rounds = iters0, rounds0
    info: dict = {}
    prev_relres = np.inf
    for _ in range(max_rounds - rounds0):
        r = b_eff - a_scaled @ x
        relres = np.linalg.norm(r) / normb
        if relres <= target_tol or relres > stop_ratio * prev_relres:
            break
        prev_relres = relres
        dx, info = inner_solve(r)
        x = x + dx
        total_iters += info.get("iters", 0)
        rounds += 1
        if info.get("breakdown"):
            break
    info = dict(info or {})
    info["iters"] = total_iters
    info["refine_rounds"] = rounds
    if not host_res:
        return x, info
    info["breakdown"] = bool(info.get("breakdown", False))
    r = b_eff - a_scaled @ x
    info["res"] = float(np.linalg.norm(r))
    info["relres_scaled"] = float(np.linalg.norm(r) / normb) if normb else 0.0
    return x, info
