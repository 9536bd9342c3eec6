"""The port's Chebyshev preconditioner against the JAX package's, in f64.

* ``cheby_recurrence`` on a dense SPD operator, degrees 1 to 8, and
  ``Chebyshev.apply`` / ``build_chebyshev`` (its power-iteration λ_max
  through the operator) to 1e-12 relative;
* ``power_lam_max_host``: the host copy bitwise equal to the original;
* the driver's ``precond="chebyshev"`` on the stencil (lane-major), ELL
  and block-ELL formats: equal iteration counts (±1) and x within 1e-8
  relative of the JAX driver's f64 solve (block-ELL against the JAX
  ``block_ell_xla``, whose Pallas kernel sums in f32 even in f64). The
  other formats and ``fmt="auto"`` are in test_torch_cheb_driver.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.precond import chebyshev as jcheb
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.precond import chebyshev as tcheb
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)
RTOL = 1e-12


@pytest.fixture(scope="module")
def spd():
    """A dense SPD matrix with a spread spectrum, its diagonal, and a
    panel."""
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    a = (q * np.geomspace(0.05, 3.0, 40)) @ q.T
    return a, np.diag(a).copy(), rng.standard_normal((40, 3))


@pytest.mark.parametrize("degree", [1, 2, 3, 8])
def test_cheby_recurrence_matches_jax(spd, degree):
    a, _, b = spd
    lam_min, lam_max = 0.1, 3.2
    a_t, a_j = torch.from_numpy(a), jnp.asarray(a)
    got = tcheb.cheby_recurrence(lambda v: a_t @ v, torch.from_numpy(b), degree,
                                 lam_min, lam_max).numpy()
    want = np.asarray(jcheb.cheby_recurrence(lambda v: a_j @ v, jnp.asarray(b),
                                             degree, lam_min, lam_max))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    if degree > 1:
        # the polynomial really approximates A⁻¹: closer than the first step
        err = np.linalg.norm(a @ got - b) / np.linalg.norm(b)
        err1 = np.linalg.norm(a @ (b / ((lam_min + lam_max) / 2)) - b) / np.linalg.norm(b)
        assert err < err1


def test_build_chebyshev_and_apply_match_jax(spd):
    a, diag, r = spd
    a_t, a_j = torch.from_numpy(a), jnp.asarray(a)
    ct = tcheb.build_chebyshev(lambda v: a_t @ v, torch.from_numpy(diag), degree=6,
                               kappa_bound=20.0)
    cj = jcheb.build_chebyshev(lambda v: a_j @ v, jnp.asarray(diag), degree=6,
                               kappa_bound=20.0)
    np.testing.assert_allclose(ct.lam_max, float(cj.lam_max), rtol=RTOL)
    np.testing.assert_allclose(ct.lam_min, float(cj.lam_min), rtol=RTOL)
    got = ct.apply(torch.from_numpy(r)).numpy()
    want = np.asarray(cj.apply(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    # lane-major: the same preconditioner on a (t, 1, m) panel
    cl = tcheb.Chebyshev(inv_diag=ct.inv_diag[None], lam_min=ct.lam_min,
                         lam_max=ct.lam_max, degree=6, lane_major=True,
                         a_apply=lambda v: (a_t @ v[:, 0].T).T[:, None])
    got_l = cl.apply(torch.from_numpy(np.ascontiguousarray(r.T))[:, None]).numpy()
    np.testing.assert_allclose(got_l[:, 0].T, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_power_lam_max_host_bitwise():
    a, _ = sym_rac_scaling(elasticity3d(4, 4, 4, heterogeneous=True))
    assert tcheb.power_lam_max_host(a) == jcheb.power_lam_max_host(a)
    assert tcheb.power_lam_max_host(a, iters=7) == jcheb.power_lam_max_host(a, iters=7)


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def _opts(cls, layout):
    return cls(t=4, tol=1e-8, maxiter=2000, variant="odir_fused", layout=layout)


@pytest.mark.parametrize("fmt,layout,jax_fmt", [
    ("stencil", "tbn", "stencil"),
    ("ell", "nt", "ell"),
    ("block_ell", "nt", "block_ell_xla"),
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
