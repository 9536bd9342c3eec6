"""``interop.solver_from_reference`` with the preconditioner kinds of the
rest of the one-GPU driver: the port solves on the JAX build's own
operands -- the unique inverses and groups of "bj_dedup", the bf16
inverses of "bj_lane", and D⁻¹ with (λ_min, λ_max, degree) of
"chebyshev" -- and takes the JAX driver's iterations (±1), x within 1e-8
relative. bj_lane solves to 1e-5 and its x is held to 1e-5 relative
(measured 1.5e-6): its apply sums in f32, in a different order in each
package, so the two preconditioners differ at ~1e-7 and the iterates
part at the solve's own accuracy, not at f64 rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.direct.device_bj import csr_slab_groups
from prealps_tpu.ops.formats import csr_to_stencil_bsr
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.precond.chebyshev import power_lam_max_host
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.interop import solver_from_reference

torch.set_num_threads(1)

CASES = {
    "bj_dedup": dict(precond="bj", grid=(7, 7, 8)),
    "bj_lane": dict(precond="bj", block_size=24, bj_dedupe=False, bj_dtype="bf16"),
    "chebyshev": dict(precond="chebyshev", cheb_degree=6, cheb_kappa=20.0),
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_port_solves_on_jax_operands(kind):
    a = elasticity3d(6, 6, 8, heterogeneous=False)
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    tol = 1e-5 if kind == "bj_lane" else 1e-8
    opts = JaxOptions(t=4, tol=tol, maxiter=3000, variant="odir_fused", layout="tbn")
    sj = JaxECG.build(a, nshards=1, opts=opts, fmt="stencil", br=3,
                      dtype=np.float64, **CASES[kind])
    x_j, info_j = sj.solve(b)
    (blocks_t,), (pc,) = sj._operands
    lay = sj.layout
    a_pad = permute_and_pad_matrix(sym_rac_scaling(a)[0], lay)
    arrays = dict(blocks=np.asarray(blocks_t), scale_d=sj.scale_d, perm=lay.perm,
                  inv_perm=lay.inv_perm, layout_offsets=lay.offsets,
                  a_scaled=sj.a_scaled)
    meta = dict(stencil_offsets=csr_to_stencil_bsr(a_pad, br=3).offsets, br=3,
                n=lay.n, n_pad=lay.n_pad, rows_per_shard=lay.rows_per_shard,
                opts=dataclasses.asdict(sj.opts), target_tol=sj.target_tol)
    if kind == "bj_dedup":
        # the JAX build keeps its groups in the apply's closure: recompute
        # them as it does, from the padded scaled matrix at slab rows
        mb = pc.shape[1] * pc.shape[2]
        arrays["inv_u"] = np.asarray(pc)
        meta["groups"] = csr_slab_groups(a_pad, mb)[1]
        assert len(meta["groups"]) == pc.shape[0]
    elif kind == "bj_lane":
        arrays["inv5"] = np.asarray(pc)
    else:
        lam_max = power_lam_max_host(a_pad) * 1.05
        arrays["inv_panel"] = np.asarray(pc)
        meta["cheb"] = (lam_max / 20.0, lam_max, 6)
    s = solver_from_reference(arrays, meta, device="cpu")
    assert s.operands.precond_kind == kind
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    rel = 1e-5 if kind == "bj_lane" else 1e-8
    assert np.linalg.norm(x - x_j) <= rel * np.linalg.norm(x_j)
    assert np.linalg.norm(b - a @ x) <= 10 * tol * np.linalg.norm(b)
