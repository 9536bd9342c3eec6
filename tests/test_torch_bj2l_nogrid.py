"""Two-level block Jacobi without ``grid=`` against the JAX driver: the
translation-only coarse space (one constant per component and block,
divided by the scaling, QR per block; prealps_tpu/parallel/driver.py:
541-564). The port's coarse operands equal the JAX build's to 1e-12, and
the f64 solve takes the same iterations (±1) to x within 1e-8 relative.
"""

import numpy as np
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.precond.twolevel import translation_modes
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)
RTOL = 1e-12


def test_translation_modes_and_solve_match_jax():
    a = elasticity3d(5, 5, 6, heterogeneous=True)
    b = np.random.default_rng(2).standard_normal(a.shape[0])
    opts = dict(t=4, tol=1e-8, maxiter=3000, variant="odir_fused", layout="tbn")
    kw = dict(fmt="stencil", br=3, precond="bj2l", block_size=24, grid=None,
              dtype=np.float64)
    sj = JaxECG.build(a, nshards=1, opts=JaxOptions(**opts), **kw)
    s = DistributedECG.build(a, nshards=1, opts=ECGOptions(**opts), device="cpu",
                             **kw)
    _, (inv_f, yq3, ac_inv) = sj._operands
    ops = s.operands
    assert ops.precond_kind == "bj2l" and s.layout.n_pad == sj.layout.n_pad
    assert ops.yq3.shape == np.asarray(yq3).shape and ops.yq3.shape[1] == 3
    for got, want in ((ops.yq3, yq3), (ops.ac_inv, ac_inv), (ops.inv_f, inv_f)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    x_j, info_j = sj.solve(b)
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert not info["breakdown"]
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def test_translation_modes_are_orthonormal_translations():
    """Each block's modes span the scaled translations and are orthonormal;
    zero scaling entries (padded rows) count as 1."""
    nb, mbn, br = 3, 8, 3
    d = np.random.default_rng(4).uniform(0.5, 2.0, nb * mbn * br)
    d[-br:] = 0.0
    y5 = translation_modes(nb, mbn, br, d)
    assert y5.shape == (nb, br, mbn, br)
    dd = np.where(d == 0.0, 1.0, d).reshape(nb, mbn, br)
    for b in range(nb):
        q = y5[b].transpose(1, 0, 2).reshape(mbn * br, br)
        np.testing.assert_allclose(q.T @ q, np.eye(br), atol=1e-13)
        raw = np.zeros((mbn, br, br))
        for k in range(br):
            raw[:, k, k] = 1.0 / dd[b, :, k]
        raw = raw.reshape(mbn * br, br)
        # the raw modes lie in the span of q
        np.testing.assert_allclose(q @ (q.T @ raw), raw, atol=1e-12)
