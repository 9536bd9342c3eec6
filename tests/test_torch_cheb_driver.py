"""The port's Chebyshev preconditioner in the driver against the JAX
driver's, in f64, on the formats test_torch_cheb.py leaves out: the stencil
on row-major panels, DIA on both layouts, and ``fmt="auto"``, which builds
Chebyshev on the detected format. Equal iteration counts (±1) and x within
1e-8 relative.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def _opts(cls, layout):
    return cls(t=4, tol=1e-8, maxiter=2000, variant="odir_fused", layout=layout)


@pytest.mark.parametrize("fmt,layout,jax_fmt", [
    ("stencil", "nt", "stencil"),
    ("dia", "tbn", "dia"),
    ("dia", "nt", "dia"),
])
def test_chebyshev_solve_matches_jax(problem, fmt, layout, jax_fmt):
    a, b = problem
    kw = dict(precond="chebyshev", cheb_degree=5, cheb_kappa=25.0,
              dtype=np.float64)
    sj = JaxECG.build(a, nshards=1, opts=_opts(JaxOptions, layout), fmt=jax_fmt,
                      **kw)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions, layout), fmt=fmt,
                             device="cpu", **kw)
    assert s.operands.precond_kind == "chebyshev" and s.operands.cheb.degree == 5
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert not info["breakdown"]
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    assert np.linalg.norm(b - a @ x) <= 1e-7 * np.linalg.norm(b)


def test_chebyshev_auto_detects_before_building(problem):
    """fmt="auto" builds Chebyshev on whatever the detection picks (the
    stencil here) in both packages."""
    a, b = problem
    kw = dict(precond="cheby", dtype=np.float64, fmt="auto")
    sj = JaxECG.build(a, nshards=1, opts=_opts(JaxOptions, "nt"), **kw)
    s = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions, "nt"),
                             device="cpu", **kw)
    assert s.fmt_info["chosen"] == sj.fmt_info["chosen"] == "stencil"
    assert s.opts.layout == sj.opts.layout
    x_j, info_j = sj.solve(b)
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
