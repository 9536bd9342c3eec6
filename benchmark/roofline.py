"""The yardstick of the kernel metrics: the card's published peaks and the
operations and bytes a kernel call needs, from its shapes.

The rule is frozen here: each input byte is read once and each output byte
written once, whatever the kernel reads again; halo columns and padding of
the panels are not counted. A call's bound is the larger of its bytes over
the memory bandwidth and its operations over the arithmetic peak of its
value type; a roofline share is the bound over the measured device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, dense rates at 700 W
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "flops_per_s": {4: 67e12, 8: 34e12},   # f32 / f64 outside the tensor cores
}


def stencil_bytes(s: int, br: int, nrb: int, t: int, block_bytes: int = 4,
                  panel_bytes: int = 4) -> int:
    """Bytes one stencil product y = A x needs (B1, B2a, B2b): the S offset
    blocks of br x br values for each of nrb block rows, the (t, br, nrb)
    panel x read and y written."""
    return s * br * br * nrb * block_bytes + 2 * t * br * nrb * panel_bytes


def stencil_flops(s: int, br: int, nrb: int, t: int) -> int:
    """A multiply and an add for every block value and panel column."""
    return 2 * s * br * br * nrb * t


def ell_bytes(n: int, width: int, t: int, value_bytes: int = 4,
              index_bytes: int = 4) -> int:
    """Bytes one ELL product y = A X needs: n rows of ``width`` values and
    column indices, the (n, t) panel X read and Y written."""
    return n * width * (value_bytes + index_bytes) + 2 * n * t * value_bytes


def ell_flops(nnz: int, t: int) -> int:
    """A multiply and an add for every stored nonzero and panel column."""
    return 2 * nnz * t


def bound_s(nbytes: int, flops: int, value_bytes: int = 4) -> float:
    """The least time the card could take: bytes or operations, whichever
    binds."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               flops / PEAKS["flops_per_s"][value_bytes])


def stencil_bound_s(op: dict, t: int) -> float:
    """Bound of one stencil product on the operator described by ``op``
    (``s``, ``br``, ``nrb``, ``block_bytes``, ``panel_bytes``)."""
    return bound_s(stencil_bytes(op["s"], op["br"], op["nrb"], t, op["block_bytes"],
                                 op["panel_bytes"]),
                   stencil_flops(op["s"], op["br"], op["nrb"], t),
                   op["panel_bytes"])
