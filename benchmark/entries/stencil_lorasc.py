"""Entry ``stencil_lorasc``: ``StencilLorascECG`` on one card
(``parallel/lorasc_stencil.py``), built once, then ``solve(b)``.

The configuration's ``options`` are ``StencilLorascECG.build``'s keyword
arguments, with ``ecg`` the ``ECGOptions`` and ``dtype`` a NumPy type name;
the node grid comes from the problem. Spans: the operator product
(``solver._a_apply``, with its panel width), the preconditioner
(``solver._m_apply``, with its panel width) and, inside it, the banded
interior and separator solves (``lorasc_scale._aii_solve`` and
``_agg_solve``, which the apply looks up at call time), as
``precond.banded``. A checkout whose solver keeps no ``timings`` gives the
preconditioner's.
"""

from __future__ import annotations

import numpy as np

BANDED = ("_aii_solve", "_agg_solve")


def _width(x, *rest, **kw):
    return {"t": int(x.shape[0])}


class Entry:
    def __init__(self, solver):
        self.solver = solver

    def solve(self, b: np.ndarray):
        return self.solver.solve(b)

    def build_stages(self) -> dict:
        timings = getattr(self.solver, "timings", None)
        return dict(timings if timings else self.solver.precond.timings)

    def instrument(self, spans) -> None:
        from prealps_tpu_torch.precond import lorasc_scale

        s = self.solver
        spans.wrap(s, "_a_apply", "spmm", args=_width)
        spans.wrap(s, "_m_apply", "precond", args=_width)
        for name in BANDED:
            spans.wrap(lorasc_scale, name, "precond.banded")

    def product(self, x):
        """The operator product the solve calls, on a (t, br, nrb) panel."""
        return self.solver._a_apply(x)

    def operator(self) -> dict:
        """The operator product's shapes, for its kernel's bound (B2a: the
        iteration's product and the apply's two sweeps, at the solve's
        panel width ``t``), and the build's stages."""
        a_t = self.solver.precond.operands["a_stencil"]
        return {"format": "stencil", "s": len(a_t.offsets), "br": int(a_t.blocks_t.shape[1]),
                "nrb": int(a_t.blocks_t.shape[3]), "block_bytes": a_t.blocks_t.element_size(),
                "panel_bytes": 4 if self.solver.precond.operands["sep_mask"].element_size() == 4
                else 8, "t": int(self.solver.opts.t), "stages": self.build_stages()}


def build(a, meta: dict, options: dict, device) -> Entry:
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    o = dict(options)
    opts = ECGOptions(**o.pop("ecg"))
    dtype = np.dtype(o.pop("dtype"))
    return Entry(StencilLorascECG.build(a, grid=meta["grid"], opts=opts, dtype=dtype,
                                        device=device, **o))
