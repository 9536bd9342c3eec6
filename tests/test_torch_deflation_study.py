"""The port's f64 deflation study (``examples/deflation_study_f64.py``)
against the JAX package's f64 ``StencilLorascECG`` on the CPU, at
heterogeneous elasticity3d(6³) with max_deflation 8 and 16 (the study's
configuration otherwise: 8 box parts, t 12 odir_fused to 1e-5):

* each row of the script's ``main``: the same deflated pairs as the JAX
  build and iterations within ±1 of its solve;
* the JAX f64 build carried over by ``interop.lorasc_from_reference`` and
  solved by the port's ``StencilLorascECG``: iterations within ±1, x
  within 1e-8 relative of JAX's;
* the chip_smoke ``[lorasc_f64]`` anchor's configuration is the study's
  (``tests/test_torch_anchors.py --path lorasc_f64``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG as JaxStencilLorasc
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.examples import deflation_study_f64 as study
from prealps_tpu_torch.interop import lorasc_from_reference
from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

NEL = 6
DEFLATIONS = (8, 16)


@pytest.fixture(scope="module")
def jax_rows():
    """max_deflation -> (JAX solver, x, info)."""
    a, b = study.problem(NEL)
    out = {}
    for defl in DEFLATIONS:
        s = JaxStencilLorasc.build(a, opts=JaxOptions(**study.OPTS),
                                   **study.build_kwargs(NEL, defl))
        out[defl] = (s, *s.solve(b))
    return out


def test_study_rows_match_jax(jax_rows, capsys):
    assert study.main(["--nel", str(NEL), "--deflations",
                       ",".join(map(str, DEFLATIONS)), "--device", "cpu"]) == 0
    lines = [json.loads(v) for v in capsys.readouterr().out.splitlines()]
    head, *rows, last = lines
    assert head == {"card": "cpu", "nel": NEL, "dtype": "float64"}
    assert last["rows"] == rows and [r["defl_requested"] for r in rows] == list(DEFLATIONS)
    for row in rows:
        _, _, info_j = jax_rows[row["defl_requested"]]
        assert row["defl_kept"] == info_j["deflated"], row
        assert abs(row["iters"] - info_j["iters"]) <= 1, (row, info_j["iters"])
        assert not row["breakdown"] and row["relres"] < 1e-4
        assert row["device_ms"] is None and row["build_s"] > 0 and row["solve_s"] > 0


def test_f64_reference_build_carried_over(jax_rows):
    s_j, x_j, info_j = jax_rows[16]
    pc = s_j.precond
    ops = {("blocks_t" if k == "a_stencil" else k):
           np.asarray(v.blocks_t if k == "a_stencil" else v)
           for k, v in pc.operands.items()}
    assert ops["blocks_t"].dtype == ops["e_mat"].dtype == np.float64
    a, b = study.problem(NEL)
    fields = {f.name: getattr(pc.plan, f.name) for f in dataclasses.fields(pc.plan)}
    port_pc = lorasc_from_reference(
        fields, ops, dict(offsets=tuple(pc.operands["a_stencil"].offsets),
                          shape=a.shape, deflated=pc.deflated), device="cpu")
    s = StencilLorascECG.build(a, opts=ECGOptions(**study.OPTS), device="cpu",
                               precond=port_pc, **study.build_kwargs(NEL, 16))
    assert s.precond.operands["a_stencil"].blocks_t.dtype == torch.float64
    x, info = s.solve(b)
    assert info["deflated"] == info_j["deflated"] and not info["breakdown"]
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def test_chip_smoke_anchor_is_the_study_row():
    import chip_smoke

    assert chip_smoke.LORASC_F64_DEFLATION in study.DEFLATIONS
    assert study.NEL == 36 and study.OPTS == dict(
        t=12, tol=1e-5, maxiter=3000, variant="odir_fused", layout="tbn")
    kw = study.build_kwargs(36, 256)
    assert kw == dict(nparts=8, br=3, grid=(37, 37, 36), dtype=np.float64,
                      max_deflation=256)


def test_f64_build_keeps_every_operand_f64():
    """``StencilLorascECG.build(a)`` takes the matrix's f64 by default: the
    stencil table, the banded factors (``factor_store="auto"`` keeps the
    build's type, the JAX rule off a TPU), the Lanczos basis and σ are f64,
    and the solve runs without refinement."""
    a, _ = study.problem(NEL)
    s = StencilLorascECG.build(a, nparts=8, br=3, grid=(NEL + 1, NEL + 1, NEL),
                               opts=ECGOptions(**study.OPTS), max_deflation=8,
                               device="cpu")
    ops = s.precond.operands
    floats = {k: v.dtype for k, v in ops.items()
              if isinstance(v, torch.Tensor) and v.is_floating_point()}
    assert {"aii_linv", "agg_linv", "e_mat", "sigma", "sep_mask"} <= set(floats)
    assert set(floats.values()) == {torch.float64}
    assert ops["a_stencil"].blocks_t.dtype == torch.float64
    assert s.a_scaled is None and "a_lo_blocks" not in ops
