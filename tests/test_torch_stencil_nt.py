"""fmt="stencil" on row-major panels (layout="nt") in both packages, on the CPU.

* The operator: the port's nt product (a roll of the (nrb, br, t) panel and
  a block einsum per offset) equals A @ x in f64 to 1e-12 relative.
* f64 solves against the JAX driver's nt stencil path, host block Jacobi
  and no preconditioner: iterations within ±1, x within 1e-8 relative.
* f32 with tol below inner_tol refines with host-f64 rounds (no
  double-float product on nt, as the JAX driver's ``df_ok``) and reaches
  the tolerance; bj2l stays lane-major only.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import DistributedECG, StencilNtOperands
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


def _system(seed=0):
    a = elasticity3d(4, 4, 3, heterogeneous=True)
    return a, np.random.default_rng(seed).standard_normal(a.shape[0])


def test_nt_stencil_apply_is_a_times_x():
    a, _ = _system()
    s = DistributedECG.build(a, nshards=1, fmt="stencil", precond="none",
                             scale=False, dtype=np.float64, device="cpu",
                             opts=ECGOptions(t=3, layout="nt"))
    ops = s.operands
    assert isinstance(ops, StencilNtOperands) and not ops.df_ok
    n_pad = s.layout.n_pad
    x = np.random.default_rng(3).standard_normal((n_pad, 3))
    y = ops.a_apply(torch.from_numpy(x)).numpy()
    n = a.shape[0]
    want = a @ x[:n]
    assert np.abs(y[:n] - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("precond,t", [("block_jacobi", 4), ("none", 2)])
def test_nt_stencil_f64_matches_jax(precond, t):
    a, b = _system()
    kw = dict(nshards=1, fmt="stencil", precond=precond, block_size=48,
              dtype=np.float64)
    sj = JaxECG.build(a, opts=JaxOptions(t=t, tol=1e-10, maxiter=2000,
                                         layout="nt"), **kw)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, device="cpu", opts=ECGOptions(
        t=t, tol=1e-10, maxiter=2000, layout="nt"), **kw)
    assert s.opts.layout == "nt" and s.operands.layout == "nt"
    assert s.layout.n_pad == sj.layout.n_pad
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert not info["breakdown"]
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def test_nt_stencil_f32_refines_on_the_host():
    a, b = _system(seed=1)
    s = DistributedECG.build(a, nshards=1, fmt="stencil", precond="block_jacobi",
                             block_size=48, dtype=np.float32, device="cpu",
                             opts=ECGOptions(t=4, tol=1e-8, maxiter=2000,
                                             layout="nt"))
    x, info = s.solve(b)
    assert np.linalg.norm(b - a @ x) < 1e-8 * np.linalg.norm(b)
    assert info["device_rounds"] == 0 and info["refine_rounds"] >= 2


def test_nt_stencil_refuses_bj2l():
    a, _ = _system()
    with pytest.raises(ValueError, match="lane-major"):
        DistributedECG.build(a, nshards=1, fmt="stencil", precond="bj2l",
                             grid=(5, 5, 3), device="cpu",
                             opts=ECGOptions(t=4, layout="nt"))
