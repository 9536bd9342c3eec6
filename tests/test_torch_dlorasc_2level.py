"""The port's DistributedLorascECG on a two-level (4, 2) mesh: 8 gloo
ranks, each pair sharing one group's interior solves (the two-level
banded solve, one all-gather in the pair per block step) and its Agi / Aig
rows, against the JAX driver on the conftest's 8 CPU devices.

The cases of tests/test_distributed.py's two-level tests
(``test_lorasc_two_level_matches_scipy``, ``test_one_and_two_level_agree``):
elasticity3d(6,5,5), b = default_rng(11), ECG t = 2 to 1e-8, f64,
max_deflation 16, over the (4, 2) mesh and over nshards 4: iterations
within ±1 of the JAX driver's at the same mesh, x within 1e-8 relative and
bitwise the same on every rank, the (4, 2) solve within 1e-5 of a scipy
direct solve. And the preconditioner on the (4, 2) mesh with Lanczos
deflation and the balancing lift, carried over from the JAX build
(``distributed_lorasc_from_reference``): M·v within 1e-12 of the JAX
apply.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
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

OPTS = dict(t=2, tol=1e-8, maxiter=600)
CASES = {"mesh42": dict(mesh_shape=(4, 2), dtype=np.float64, max_deflation=16,
                        opts=OPTS),
         "nshards4": dict(nshards=4, dtype=np.float64, max_deflation=16, opts=OPTS)}
LIFT = dict(mesh_shape=(4, 2), dtype=np.float64, exact_schur=False,
            correction="deflate", opts=dict(OPTS, variant="omin"))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    a = elasticity3d(6, 5, 5)
    b = np.random.default_rng(11).standard_normal(a.shape[0])
    v = np.random.default_rng(12).standard_normal(a.shape[0])
    jax_res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        for name, kw in CASES.items():
            kw = dict(kw)
            s = JaxLorasc.build(a, opts=JaxOptions(**kw.pop("opts")), **kw)
            jax_res[name] = s.solve(b)
        kw = dict(LIFT)
        s = JaxLorasc.build(a, opts=JaxOptions(**kw.pop("opts")), **kw)
        assert s.nlocal == 2 and "w_lift" in s._operands[0]
        y_j = jax_lorasc_applies(s, [v])[0]
        ref = lorasc_reference(s)
        # the ranks inherit the knob: the port partitions as JAX did
        port = spawn_jobs(8, [("lorasc_solves", (a, b, {"mesh42": CASES["mesh42"]})),
                              ("lorasc_reference_applies", ({"lift": ref}, b, [v]))],
                          tmp_path_factory, timeout=LORASC_SPAWN_TIMEOUT)
        # nshards 4 takes a group of 4 ranks
        port4 = spawn_jobs(4, [("lorasc_solves", (a, b, {"nshards4": CASES["nshards4"]}))],
                           tmp_path_factory, timeout=LORASC_SPAWN_TIMEOUT)
    for r, r4 in zip(port, port4 + [None] * 4):
        r[0].update(r4[0] if r4 else {})
    return a, b, jax_res, port, y_j


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax_at_the_same_mesh(both, case):
    a, b, jax_res, port, _ = both
    x, info = port[0][0][case][:2]
    for r in port[1:]:
        if case not in r[0]:
            continue
        np.testing.assert_array_equal(r[0][case][0], x)
        assert r[0][case][1] == info
    x_j, info_j = jax_res[case]
    assert not info["breakdown"] and info["deflated"] == info_j["deflated"]
    assert abs(info["iters"] - info_j["iters"]) <= 1, (info["iters"], info_j["iters"])
    assert np.linalg.norm(x - x_j) <= X_RTOL * np.linalg.norm(x_j)


def test_two_level_matches_scipy(both):
    a, b, _, port, _ = both
    x = port[0][0]["mesh42"][0]
    x_ref = spla.spsolve(sp.csc_matrix(a), b)
    assert np.linalg.norm(x - x_ref) < 1e-5 * np.linalg.norm(x_ref)
    # the two meshes pad the separator to their own multiples
    assert port[0][0]["mesh42"][2] % 2 == 0


def test_lift_apply_on_the_mesh_matches_jax(both):
    *_, port, y_j = both
    y = port[0][1]["lift"][0][0]
    assert np.linalg.norm(y - y_j) <= 1e-12 * np.linalg.norm(y_j)
    for r in port[1:]:
        np.testing.assert_array_equal(r[1]["lift"][0][0], y)
    info = port[0][1]["lift"][2]
    assert not info["breakdown"] and info["deflated"] > 0
