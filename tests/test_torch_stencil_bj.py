"""The stencil path with ``precond="bj"`` (the JAX driver's "bj_flat"):
device block Jacobi alone, applied as one batched GEMM on lane-major
panels. elasticity3d(6,6,6), 48-row blocks, ECG t = 4 odir_fused, f64 on the
CPU: iteration counts ±1 and x within 1e-8 relative of the JAX driver,
through a plain build and through the JAX build's own operands.
"""

import dataclasses

import numpy as np
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.interop import solver_from_reference
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


def _opts(cls, tol):
    return cls(t=4, tol=tol, maxiter=2000, variant="odir_fused", layout="tbn")


def test_stencil_bj_flat_matches():
    """precond="bj" on the stencil path (device block Jacobi alone), f64,
    through a plain build and through the JAX build's operands."""
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    kw = dict(fmt="stencil", br=3, precond="bj", block_size=48, nshards=1,
              dtype=np.float64)
    sj = JaxECG.build(a, opts=_opts(JaxOptions, 1e-8), **kw)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, opts=_opts(ECGOptions, 1e-8), device="cpu", **kw)
    assert s.operands.precond_kind == "bj_flat" and s.operands.yq3 is None
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    (blocks_t,), (inv_f,) = sj._operands
    lay = sj.layout
    ref = solver_from_reference(
        dict(blocks=np.asarray(blocks_t), inv_f=np.asarray(inv_f),
             scale_d=sj.scale_d, perm=lay.perm, inv_perm=lay.inv_perm,
             layout_offsets=lay.offsets, a_scaled=sj.a_scaled),
        dict(stencil_offsets=s.operands.offsets, br=3, n=lay.n, n_pad=lay.n_pad,
             rows_per_shard=lay.rows_per_shard, opts=dataclasses.asdict(sj.opts),
             target_tol=sj.target_tol), device="cpu")
    x_r, info_r = ref.solve(b)
    assert info_r["iters"] == info_j["iters"]
    assert np.linalg.norm(x_r - x_j) <= 1e-8 * np.linalg.norm(x_j)
