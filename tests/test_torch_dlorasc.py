"""The port's DistributedLorascECG over 4 gloo ranks against the JAX
driver at nshards 4 (the conftest's CPU devices), elasticity3d(6,5,5).

f64, ECG t = 4 to 1e-8: the default build (the exact Schur complement,
chosen automatically here: the separator holds more than a quarter of the
rows), Lanczos deflation (``exact_schur=False``), the banded separator
(``agg_dense_max=64``) and the balancing correction (``correction=
"deflate"``) with omin. Each: iterations within ±1, the same deflated
pairs, x within 1e-8 relative of JAX's and bitwise the same on every rank.
f32 with refinement: at least one round, relres < 1e-5, JAX's deflated
pairs (σ to 1e-3), JAX's count within ±10 % of 64, and the port's in a
band from 10 % under JAX's 64 to 10 % over its own measured 270, the
spread that f32 rounding alone gives it. The gap is f32 rounding, not a departure
(ROADMAP C, "Other behaviours" 7): both builds run the Lanczos and σ in
f32, x64 on or off, and agree on the pairs to ~3e-4; the third
refinement round sits at the edge of its 1e-3 inner tolerance, so a
1e-4 relative change of σ moves JAX from 64 to 106 and the port from
270 to 60 or 79. Fewer than 2
groups raises the JAX driver's error, as does a group of the wrong size.
The JAX side partitions with its Python algorithm
(``PREALPS_TPU_NO_NATIVE=1``), the one the port copies.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG as JaxLorasc
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from sharded_cases import LORASC_SPAWN_TIMEOUT, X_RTOL, relres, spawn_jobs

torch.set_num_threads(1)

TOL = 1e-8
OPTS = dict(t=4, tol=TOL, maxiter=600)
CASES = {
    "default": dict(nshards=4, dtype=np.float64, opts=OPTS),
    "deflation": dict(nshards=4, dtype=np.float64, exact_schur=False, opts=OPTS),
    "banded": dict(nshards=4, dtype=np.float64, exact_schur=False, agg_dense_max=64,
                   opts=OPTS),
    "deflate_omin": dict(nshards=4, dtype=np.float64, exact_schur=False,
                         correction="deflate", opts=dict(OPTS, variant="omin")),
}
F32 = {"f32": dict(nshards=4, dtype=np.float32, exact_schur=False, opts=OPTS)}
JAX_F32_ITERS = 64                            # JAX's measured count, ±10 %
PORT_F32_ITERS = (0.9 * JAX_F32_ITERS, 1.1 * 270)  # the port's band
REFUSED = {"one_group": dict(nshards=1), "mesh_1x4": dict(mesh_shape=(1, 4)),
           "wrong_size": dict(nshards=2)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    a = elasticity3d(6, 5, 5)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    jax_res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        for name, kw in CASES.items():
            kw = dict(kw)
            s = JaxLorasc.build(a, opts=JaxOptions(**kw.pop("opts")), **kw)
            jax_res[name] = (s.deflated, *s.solve(b))
        kw = dict(F32["f32"])
        s = JaxLorasc.build(a, opts=JaxOptions(**kw.pop("opts")), **kw)
        jax_res["f32"] = (s.deflated, *s.solve(b), np.asarray(s._operands[0]["sigma"]))
        with pytest.raises(ValueError, match=">= 2 interior parts") as err:
            JaxLorasc.build(a, nshards=1)
        # the ranks inherit the knob: the port partitions as JAX did
        port = spawn_jobs(4, [("lorasc_solves", (a, b, {**CASES, **F32})),
                              ("lorasc_refusals", (a, REFUSED))], tmp_path_factory,
                          timeout=LORASC_SPAWN_TIMEOUT)
    return a, b, jax_res, port, str(err.value)


@pytest.mark.parametrize("case", sorted(CASES))
def test_f64_solve_matches_jax(both, case):
    a, b, jax_res, port, _ = both
    x, info = port[0][0][case][:2]
    for r in port[1:]:
        np.testing.assert_array_equal(r[0][case][0], x)
        assert r[0][case][1] == info
    deflated, x_j, info_j = jax_res[case]
    assert info["deflated"] == deflated == info_j["deflated"]
    assert not info["breakdown"] and info["refine_rounds"] == 0
    assert abs(info["iters"] - info_j["iters"]) <= 1, (info["iters"], info_j["iters"])
    assert np.linalg.norm(x - x_j) <= X_RTOL * np.linalg.norm(x_j)
    # the stop test reads the scaled system: the unscaled relres sits
    # within a few times its tolerance, as JAX's does
    assert relres(a, x, b) < 10 * TOL


def test_cases_take_their_paths(both):
    a, _, jax_res, port, _ = both
    n = a.shape[0]
    assert jax_res["default"][0] > 0.25 * n      # exact Schur: every separator row
    assert 0 < jax_res["deflation"][0] < 0.25 * n
    assert port[0][0]["default"][2] == port[0][0]["deflation"][2]    # ng_max


def test_f32_solve_refines(both):
    a, b, jax_res, port, _ = both
    x, info, *_, sigma = port[0][0]["f32"]
    for r in port[1:]:
        np.testing.assert_array_equal(r[0]["f32"][0], x)
        np.testing.assert_array_equal(r[0]["f32"][-1], sigma)
    assert info["refine_rounds"] >= 1 and not info["breakdown"]
    assert info["deflated"] > 0
    assert relres(a, x, b) < 1e-5
    deflated_j, _, info_j, sigma_j = jax_res["f32"]
    assert info["deflated"] == deflated_j
    np.testing.assert_array_equal(sigma > 0, sigma_j > 0)
    np.testing.assert_allclose(sigma, sigma_j, rtol=0, atol=1e-3 * np.abs(sigma_j).max())
    assert abs(info_j["iters"] - JAX_F32_ITERS) <= 0.1 * JAX_F32_ITERS, info_j["iters"]
    assert PORT_F32_ITERS[0] <= info["iters"] <= PORT_F32_ITERS[1], info["iters"]


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(both, case):
    *_, port, jax_msg = both
    for r in port:
        kind, msg = r[1][case]
        assert kind == "ValueError"
        if case == "wrong_size":
            assert "needs a process group of 2 ranks" in msg
        else:
            assert msg == jax_msg
