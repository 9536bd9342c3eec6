"""Entry ``stencil_ecg``: ``DistributedECG`` on one card in the stencil
format (``parallel/driver.py``), built once, then ``solve(b)``.

The configuration's ``options`` are ``DistributedECG.build``'s keyword
arguments, with ``ecg`` the ``ECGOptions`` and ``dtype`` a NumPy type name;
the node grid comes from the problem. Spans: the operator product
(``operands.a_apply``, with its panel width) and the preconditioner
(``operands.m_apply``), both looked up by the solve at call time.
"""

from __future__ import annotations

import numpy as np


class Entry:
    def __init__(self, solver):
        self.solver = solver

    def solve(self, b: np.ndarray):
        return self.solver.solve(b)

    def build_stages(self) -> dict:
        return dict(self.solver.timings)

    def instrument(self, spans) -> None:
        ops = self.solver.operands
        spans.wrap(ops, "a_apply", "spmm", args=lambda x: {"t": int(x.shape[0])})
        spans.wrap(ops, "m_apply", "precond")

    def product(self, x):
        """The operator product the solve calls, on a (t, br, nrb) panel."""
        return self.solver.operands.a_apply(x)

    def operator(self) -> dict:
        """The operator product's shapes, for its kernel's bound."""
        ops = self.solver.operands
        return {"format": "stencil", "s": len(ops.offsets), "br": int(ops.br),
                "nrb": int(ops.nrb), "block_bytes": ops.blocks_flat.element_size(),
                "panel_bytes": 4 if self.solver.dtype == np.float32 else 8}


def build(a, meta: dict, options: dict, device) -> Entry:
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    o = dict(options)
    opts = ECGOptions(**o.pop("ecg"))
    dtype = np.dtype(o.pop("dtype"))
    return Entry(DistributedECG.build(a, nshards=1, grid=meta["grid"], opts=opts,
                                      dtype=dtype, device=device, **o))
