"""The driver's route of a sparse product, checked and timed: what the
format scripts (``examples/bench_fmt_auto.py``, ``bench_spmm_general.py``)
measure.

``driver_operator`` builds a matrix's operator in one format as the port's
driver holds it (the operands of a ``DistributedECG`` build with
``precond="none"`` and ``scale=False``, or ``BlockEllOperands`` at bk 8 for
the Morton 8×8 block-ELL) and ``product_ms`` checks its product against
scipy's ``a @ x`` and times it (``timing.py::call_ms``: device time on the
card, the host clock on the CPU).
"""

from __future__ import annotations

import numpy as np

from prealps_tpu_torch.timing import call_ms


def driver_operator(a, fmt: str, dtype, device, br: int = 3):
    """The port driver's operator of ``a`` in format ``fmt`` (a already in
    the order the format is built on): (fn, to_arg, from_out), fn the
    operands' ``a_apply``, to_arg an (n, t) numpy panel to fn's device
    argument, from_out fn's result to an (n, t) numpy panel in a's
    order."""
    import torch

    from prealps_tpu_torch.core.layout import pad_to_padded, unpad_from_padded
    from prealps_tpu_torch.ops.formats import (
        csr_to_block_ell,
        panel_from_lane_major,
        panel_to_lane_major,
    )
    from prealps_tpu_torch.parallel.driver import BlockEllOperands, DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    n = a.shape[0]
    if fmt == "block_ell_morton":
        ops = BlockEllOperands(mat=csr_to_block_ell(a, bm=8, bk=8, dtype=dtype,
                                                    device=device), bj=None)
        return (ops.a_apply, lambda x: torch.from_numpy(x).to(device),
                lambda y: y[:n].cpu().numpy())
    lane = fmt in ("stencil", "dia")
    s = DistributedECG.build(a, fmt=fmt, br=br, precond="none", scale=False,
                             dtype=dtype, device=device,
                             opts=ECGOptions(layout="tbn" if lane else "nt"))
    ops, lay = s.operands, s.layout

    def to_arg(x):
        xp = torch.from_numpy(pad_to_padded(lay, x)).to(device)
        return panel_to_lane_major(xp, ops.br).contiguous() if lane else xp

    def from_out(y):
        y = panel_from_lane_major(y) if lane else y
        return unpad_from_padded(lay, y.cpu().numpy())

    return ops.a_apply, to_arg, from_out


def err_tol(dtype) -> float:
    """The relative error a product may have against scipy's."""
    return 1e-4 if np.dtype(dtype) == np.float32 else 1e-10


def product_ms(what, fn, to_arg, from_out, a, x, reps, device):
    """(ms, relative error against scipy) of one format's product; raises
    where the error exceeds ``err_tol``."""
    arg = to_arg(x)
    y = from_out(fn(arg))
    ref = a @ x
    err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
    if not err <= err_tol(x.dtype):
        raise RuntimeError(f"{what}: relative error {err:.3e} against scipy > "
                           f"{err_tol(x.dtype):.0e}")
    return call_ms(fn, arg, reps, device), err
