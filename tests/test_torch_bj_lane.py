"""``bj_dtype="bf16"`` ("bj_lane"): the bf16-stored 5-D block inverses with
the split-input apply, in the driver, against the JAX driver. In f32 with
refinement to 1e-6: the JAX test's rule against the f32 build
(tests/test_distributed.py::TestBf16BlockJacobi: iterations ≤ max(1.3×,
+12), relres < 5e-5), and the count within 25 % of the JAX driver's bf16
solve (the two f32 refinements differ: XLA:CPU contracts the
double-float transforms).
"""

import jax.numpy as jnp
import numpy as np
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


def _opts(cls, tol):
    return cls(t=4, tol=tol, maxiter=3000, variant="odir_fused", layout="tbn")


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def test_bf16_block_jacobi_like_jax():
    """tests/test_distributed.py::TestBf16BlockJacobi on one shard, and
    the JAX driver's bf16 count."""
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    common = dict(nshards=1, dtype=np.float32, fmt="stencil", br=3,
                  inner_tol=1e-3, block_size=24, precond="bj")
    s32 = DistributedECG.build(a, opts=_opts(ECGOptions, 1e-6), device="cpu",
                               **common)
    sbf = DistributedECG.build(a, opts=_opts(ECGOptions, 1e-6), device="cpu",
                               bj_dtype="bf16", **common)
    assert s32.operands.precond_kind == "bj_flat"
    assert sbf.operands.precond_kind == "bj_lane"
    assert sbf.operands.inv5.dtype == torch.bfloat16
    x32, i32 = s32.solve(b)
    xbf, ibf = sbf.solve(b)
    assert _relres(a, xbf, b) < 5e-5
    assert ibf["iters"] <= max(int(1.3 * i32["iters"]), i32["iters"] + 12)
    sj = JaxECG.build(a, opts=_opts(JaxOptions, 1e-6), bj_dtype="bf16", **common)
    assert sj._operands[1][0].dtype == jnp.bfloat16
    xj, ij = sj.solve(b)
    assert abs(ibf["iters"] - ij["iters"]) <= 0.25 * ij["iters"]
