"""fmt="dia" through DistributedECG in both packages, on the CPU.

The JAX package's own DIA tests (tests/test_distributed.py::TestDiaLaneMajor):
heterogeneous elasticity3d(8, 7, 7), ``precond="block_jacobi"`` with
120-row blocks, ECG t = 4 odir_fused, on row-major (nt: ``dia_ell_spmm``,
host block Jacobi) and lane-major panels (tbn: the diagonals as a br = 1
stencil through B1's plain version, device block Jacobi from the
diagonals), and the banded matrix with random stragglers (an ELL
remainder) on tbn.

* f64: iteration counts within ±1 of the JAX driver's and x within 1e-8
  relative (the same operators, products summed in the same order).

The carried-over operands and the f32 refinement are in
tests/test_torch_dia_refine.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import (
    DiaLaneOperands,
    DiaOperands,
    DistributedECG,
)
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

BUILD = dict(nshards=1, fmt="dia", precond="block_jacobi", block_size=120)


def _opts(cls, tol, layout):
    return cls(t=4, tol=tol, maxiter=4000, variant="odir_fused", layout=layout)


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def _stragglers():
    rng = np.random.default_rng(3)
    n = 1200
    main = sp.diags(
        [np.full(n - 1, -1.0), np.full(n, 6.0), np.full(n - 1, -1.0),
         np.full(n - 40, -0.5), np.full(n - 40, -0.5)],
        offsets=[-1, 0, 1, 40, -40], format="csr")
    pts = rng.choice(n * n, 300, replace=False)
    extra = sp.coo_matrix((np.full(300, -0.05), (pts // n, pts % n)), shape=(n, n))
    return sp.csr_matrix(main + extra + extra.T), rng.standard_normal(n)


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(8, 7, 7, heterogeneous=True)
    return a, np.random.default_rng(1).standard_normal(a.shape[0])


@pytest.fixture(scope="module")
def jax_f64(problem):
    a, b = problem
    out = {}
    for layout in ("nt", "tbn"):
        s = JaxECG.build(a, opts=_opts(JaxOptions, 1e-8, layout),
                         dtype=np.float64, **BUILD)
        out[layout] = (s,) + s.solve(b)
    return out


@pytest.mark.parametrize("layout", ["nt", "tbn"])
def test_f64_solve_matches(problem, jax_f64, layout):
    a, b = problem
    _, x_j, info_j = jax_f64[layout]
    s = DistributedECG.build(a, opts=_opts(ECGOptions, 1e-8, layout),
                             dtype=np.float64, device="cpu", **BUILD)
    ops = s.operands
    assert isinstance(ops, DiaLaneOperands if layout == "tbn" else DiaOperands)
    assert ops.precond_kind == ("bj_flat" if layout == "tbn" else "bj")
    if layout == "tbn":
        assert ops.br == 1 and len(ops.offsets) > 64 and s.layout.n_pad % 120 == 0
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert not info["breakdown"]
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    assert _relres(a, x, b) < 1e-7


def test_stragglers_on_lane_major_panels_match():
    a, b = _stragglers()
    kw = dict(BUILD, block_size=64)
    sj = JaxECG.build(a, opts=_opts(JaxOptions, 1e-8, "tbn"), dtype=np.float64, **kw)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, opts=_opts(ECGOptions, 1e-8, "tbn"),
                             dtype=np.float64, device="cpu", **kw)
    assert s.operands.rem_vals is not None          # the stragglers' ELL
    x, info = s.solve(b)
    assert _relres(a, x, b) < 1e-7 and _relres(a, x_j, b) < 1e-7
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
