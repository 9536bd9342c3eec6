"""SpMM format sweep: the port of ``examples/bench_spmm.py``.

The analog of the reference's SpMM benchmark driver (examples/
test_bench_spmm.c sweeps t = 1..28 against PETSc MatMatMult): elasticity3d
(nel³), RAC-scaled, applied to an (n, t) panel for each enlarging factor t
and each format, one JSON line per (format, t) with the JAX sweep's keys
``format t n nnz ms gnnz_per_s platform``.

Formats and what runs them:

* ``stencil_t``        lane-major stencil (S = 27, br = 3), B2a
  (``stencil_bsr_spmm_t``);
* ``stencil_t_pallas`` the same operator through B3
  (``stencil_bsr_spmm_t_pallas``);
* ``ell``              ``ell_spmm`` (plain gather);
* ``dia``              ``dia_ell_spmm`` on ``csr_to_dia_ell_auto``
  (promoted diagonals + remainder, plain);
* ``dia_tbn``          the same diagonals as a br = 1 stencil through B2b on
  the lane-major panel, plus the remainder through one transposed gather.

On the card (``--device cuda``, the default) it runs f32 and times each
call by its device time: ``--reps`` back-to-back calls between CUDA
events, enqueued behind a spin kernel that outlasts their enqueueing
(events around calls issued as they go would time the host's launch path,
~40-50 µs a wrapper call, where the kernels are shorter); on the CPU
(``--device cpu``) f64 with the host clock, where the kernels' wrappers
run their plain versions.

    python -m prealps_tpu_torch.examples.bench_spmm --nel 16 --t 1,4,8,12,16
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.generators import elasticity3d
from prealps_tpu_torch.core.scaling import sym_rac_scaling
from prealps_tpu_torch.ops.formats import (
    csr_to_dia_ell_auto,
    csr_to_ell,
    csr_to_stencil_bsr_t,
    panel_from_lane_major,
    panel_to_lane_major,
)
from prealps_tpu_torch.ops.spmm import (
    dia_ell_spmm,
    ell_spmm,
    extend_wrap,
    stencil_bsr_spmm_t,
    stencil_bsr_spmm_t_pallas,
    stencil_pallas_bs_ext,
)
from prealps_tpu_torch.timing import call_ms

FORMATS = ("stencil_t", "stencil_t_pallas", "ell", "dia", "dia_tbn")


def _dia_tbn_fn(de):
    """The lane-major DIA product: br = 1 stencil of the diagonals (B2b on
    a wrap-extended panel) plus the transposed remainder gather."""
    d_t = de.diags[:, None, None, :].contiguous()
    halo = max(abs(o) for o in de.offsets)

    def fn(v):                                  # v: (t, 1, n)
        y = stencil_pallas_bs_ext(d_t, de.offsets,
                                  extend_wrap(v, halo).contiguous(), halo)
        if de.rem is not None:
            g = v[:, 0, :].T[de.rem.cols]
            y = y + torch.einsum("ml,mlt->mt", de.rem.vals, g).T[:, None]
        return y

    return fn


def sweep_matrix(nel: int):
    """The sweep's operator: elasticity3d(nel³), RAC-scaled."""
    return sym_rac_scaling(elasticity3d(nel, nel, nel))[0]


def operators(a, formats, dtype, device):
    """{format: (fn, to_arg, from_out)} for the scaled matrix a: each fn
    applies the operator in its format; to_arg maps an (n, t) panel to fn's
    argument and from_out fn's result back to (n, t)."""
    ops = {}
    if "ell" in formats:
        ell = csr_to_ell(a, dtype=dtype, device=device)
        ops["ell"] = (lambda v: ell_spmm(ell, v), lambda x: x, lambda y: y)
    if "dia" in formats or "dia_tbn" in formats:
        de, _ = csr_to_dia_ell_auto(a, min_fill=0.05, dtype=dtype, device=device)
        ops["dia"] = (lambda v: dia_ell_spmm(de, v), lambda x: x, lambda y: y)
        ops["dia_tbn"] = (_dia_tbn_fn(de), lambda x: x.T.contiguous()[:, None, :],
                          lambda y: y[:, 0, :].T)
    if "stencil_t" in formats or "stencil_t_pallas" in formats:
        sb = csr_to_stencil_bsr_t(a, br=3, dtype=dtype, device=device)
        to_lane = lambda x: panel_to_lane_major(x, 3).contiguous()
        ops["stencil_t"] = (lambda v: stencil_bsr_spmm_t(sb, v), to_lane,
                            panel_from_lane_major)
        ops["stencil_t_pallas"] = (lambda v: stencil_bsr_spmm_t_pallas(sb, v),
                                   to_lane, panel_from_lane_major)
    return {f: ops[f] for f in formats}


def sweep(nel=16, ts=(1, 4, 8, 12, 16), reps=20, formats=FORMATS,
          device="cuda", a=None):
    """Yield (record, x, y) for each t and format: the JSON record, the
    (n, t) panel x and the product y = A x as an (n, t) tensor on the
    device. ``a``: the scaled matrix if the caller has it
    (``sweep_matrix(nel)``)."""
    device = resolve_device(device)
    strict_fp32()
    dtype = np.float32 if device.type == "cuda" else np.float64
    if a is None:
        a = sweep_matrix(nel)
    ops = operators(a, formats, dtype, device)
    n, nnz = a.shape[0], a.nnz
    rng = np.random.default_rng(0)
    platform = "gpu" if device.type == "cuda" else "cpu"
    for t in ts:
        x = torch.from_numpy(rng.standard_normal((n, t)).astype(dtype)).to(device)
        for name, (fn, to_arg, from_out) in ops.items():
            arg = to_arg(x)
            y = from_out(fn(arg))
            ms = call_ms(fn, arg, reps, device)
            yield ({"format": name, "t": t, "n": n, "nnz": nnz, "ms": ms,
                    "gnnz_per_s": nnz / ms / 1e6, "platform": platform}, x, y)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nel", type=int, default=16)
    ap.add_argument("--t", default="1,4,8,12,16")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--formats", default=",".join(FORMATS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    formats = args.formats.split(",")
    unknown = sorted(set(formats) - set(FORMATS))
    if unknown:
        ap.error(f"unknown formats {unknown}; choose from {list(FORMATS)}")
    for rec, _, _ in sweep(args.nel, [int(v) for v in args.t.split(",")],
                           args.reps, formats, args.device):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
