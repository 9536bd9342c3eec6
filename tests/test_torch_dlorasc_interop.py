"""``interop.distributed_lorasc_from_reference``: the port's 4 gloo ranks
on the operands of a JAX ``DistributedLorascECG.build(nshards=4)``
(elasticity3d(6,5,5), f64, Lanczos deflation), each rank keeping its slice
by the JAX build's shardings, apply the JAX preconditioner: M·v within
1e-12 relative of the JAX build's own apply (its solve with ``ecg_solve``
replaced by M·b while traced), with the dense separator inverse and the
balancing lift (``correction="deflate"``) and with the banded separator
and the σ correction. The solve on those operands: the JAX iteration count
±1, x within 1e-8 relative, the same bits on every rank.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG as JaxLorasc
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from sharded_cases import (
    LORASC_SPAWN_TIMEOUT,
    X_RTOL,
    jax_lorasc_applies,
    lorasc_reference,
    spawn_jobs,
)

torch.set_num_threads(1)

OPTS = dict(t=4, tol=1e-8, maxiter=600)
CASES = {
    "deflate_dense": dict(exact_schur=False, correction="deflate",
                          opts=dict(OPTS, variant="omin")),
    "sigma_banded": dict(exact_schur=False, agg_dense_max=64, opts=OPTS),
}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    a = elasticity3d(6, 5, 5)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])
    vectors = [rng.standard_normal(a.shape[0]) for _ in range(2)]
    refs, jax_res = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        for name, kw in CASES.items():
            kw = dict(kw)
            opts = JaxOptions(**kw.pop("opts"))
            s_m = JaxLorasc.build(a, nshards=4, dtype=np.float64, opts=opts, **kw)
            ys = jax_lorasc_applies(s_m, vectors)
            s = JaxLorasc.build(a, nshards=4, dtype=np.float64, opts=opts, **kw)
            refs[name] = lorasc_reference(s)
            jax_res[name] = (ys, *s.solve(b))
    port = spawn_jobs(4, [("lorasc_reference_applies", (refs, b, vectors))],
                      tmp_path_factory, timeout=LORASC_SPAWN_TIMEOUT)
    return refs, jax_res, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_matches_jax(both, case):
    refs, jax_res, port = both
    assert ("w_lift" in refs[case][0]) == (case == "deflate_dense")
    assert ("agg_l_inv" in refs[case][0]) == (case == "sigma_banded")
    for y, y_j in zip(port[0][0][case][0], jax_res[case][0]):
        assert np.linalg.norm(y - y_j) <= 1e-12 * np.linalg.norm(y_j)
    for r in port[1:]:
        for y, y0 in zip(r[0][case][0], port[0][0][case][0]):
            np.testing.assert_array_equal(y, y0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_on_reference_operands_matches_jax(both, case):
    _, jax_res, port = both
    _, x, info = port[0][0][case]
    _, x_j, info_j = jax_res[case]
    for r in port[1:]:
        np.testing.assert_array_equal(r[0][case][1], x)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert info["deflated"] == info_j["deflated"] > 0
    assert np.linalg.norm(x - x_j) <= X_RTOL * np.linalg.norm(x_j)
