"""Time LORASC's banded solve (``direct/banded.py::block_banded_solve_t``) on
the card with f32 and with bf16 factors, at the shapes of the het LORASC
and PRESC builds (elasticity3d 36³, 8 box parts):

* interiors: P 8, nblk 17, bs 1032;
* separator: P 1, nblk 15, bs 840;

each at t 12 (the ECG panel) and t 1. The factors are random (their values
do not change the time); the bf16 factors are the f32 ones rounded. Each
pair is timed in turns (f32, bf16, bf16, f32) by device time
(``prealps_tpu_torch/timing.py::device_ms`` of the script's own checkout).
Bound: the bytes the solve needs, each factor tensor read once (2 or 4
bytes an entry), the panel read once and the result written once, over
3.35 TB/s (an H100 SXM's HBM rate); its flops (4·P·nblk·bs²·t) over 67
TFLOP/s are far less.

    PYTHONPATH=<checkout> python prealps_tpu_torch/examples/bench_banded.py

It prints one line per shape and, last, one JSON line with the package it
loaded, the card and its power limit, and every record.
"""

from __future__ import annotations

import json
import math
import pathlib
import runpy

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
SHAPES = (("interiors", 8, 17, 1032), ("separator", 1, 15, 840))


def main() -> int:
    import prealps_tpu_torch
    from prealps_tpu_torch.direct.banded import BlockBandedCholesky, block_banded_solve_t

    if not torch.cuda.is_available():
        raise SystemExit("bench_banded.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    timing = runpy.run_path(str(pathlib.Path(__file__).resolve().parents[1]
                                / "timing.py"))
    device_ms = timing["device_ms"]
    gen = torch.Generator(device=dev).manual_seed(0)
    recs = []
    for name, p, nblk, bs in SHAPES:
        scale = 0.5 / math.sqrt(bs)
        l_inv = torch.randn((p, nblk, bs, bs), generator=gen, device=dev) * scale
        m_off = torch.randn((p, nblk, bs, bs), generator=gen, device=dev) * scale
        failed = torch.zeros((), dtype=torch.bool, device=dev)
        facs = {"f32": BlockBandedCholesky(l_inv, m_off, failed),
                "bf16": BlockBandedCholesky(l_inv.to(torch.bfloat16),
                                            m_off.to(torch.bfloat16), failed)}
        for t in (12, 1):
            v = torch.randn((nblk, p, t, bs), generator=gen, device=dev)
            times = {"f32": [], "bf16": []}
            for store in ("f32", "bf16", "bf16", "f32"):
                ms, _ = device_ms(lambda: block_banded_solve_t(facs[store], v), reps=10)
                times[store].append(ms)
            for store, ms_list in times.items():
                esize = 4 if store == "f32" else 2
                nbytes = 2 * esize * l_inv.numel() + 2 * 4 * v.numel()
                ms = float(np.median(ms_list))
                rec = {"solve": name, "P": p, "nblk": nblk, "bs": bs, "t": t,
                       "factors": store, "ms": ms, "runs_ms": ms_list,
                       "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
                rec["share_of_bound"] = rec["bound_ms"] / ms
                recs.append(rec)
                print(f"[banded] {name} P{p} nblk{nblk} bs{bs} t{t} {store} factors: "
                      f"{ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                      f"({100 * rec['share_of_bound']:.0f} %)", flush=True)
        del l_inv, m_off, facs
    card = timing["card_line"]()
    print(json.dumps({"package": prealps_tpu_torch.__file__, "card": card,
                      "records": recs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
