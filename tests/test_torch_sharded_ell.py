"""The sharded general path (fmt="ell", row-major panels) at 2 and 4 gloo
ranks on the CPU against the JAX driver's ``build(nshards=N)`` on the
conftest's CPU devices.

elasticity3d(8,8,8), ECG t = 4 odir_fused to 1e-8 in f64: host block
Jacobi (30-row blocks) on the k-way row layout at 2 and 4 ranks, and at 2
ranks on a caller's layout (the stencil's contiguous one, as
tests/test_distributed.py:100-102 does), Chebyshev and none; iterations
±1 and x within 1e-8 relative. The JAX side partitions with its Python
algorithm (``PREALPS_TPU_NO_NATIVE=1``), the one the port copies. In f32
to 1e-6 the device double-float rounds run on the exchanged panel. The other sharded formats have files
of their own: ``test_torch_sharded_{block_ell,nt4,nt8,dia_tbn}.py``.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import contiguous_row_layout as jax_contiguous
from prealps_tpu_torch.core.layout import contiguous_row_layout
from sharded_cases import (
    assert_parity,
    jax_solve,
    relres,
    same_on_every_rank,
    spawn_jobs,
)

torch.set_num_threads(1)

TOL = 1e-8
OPTS = dict(t=4, tol=TOL, maxiter=3000, variant="odir_fused", layout="nt")
BJ = dict(fmt="ell", precond="bj", block_size=30, dtype=np.float64, opts=OPTS)
CASES2 = {
    "bj": BJ,
    "chebyshev": dict(BJ, precond="chebyshev"),
    "none": dict(BJ, precond="none"),
    "f32": dict(BJ, dtype=np.float32, opts=dict(OPTS, tol=1e-6)),
}
@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(8, 8, 8, heterogeneous=False)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


@pytest.fixture(scope="module", autouse=True)
def python_partitioner():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        yield


@pytest.fixture(scope="module")
def port2(problem, tmp_path_factory):
    a, b = problem
    lay = contiguous_row_layout(a.shape[0], 2, row_multiple=24)
    on_layout = {"on_layout": dict(BJ, layout=lay)}
    return spawn_jobs(2, [("solves", (a, b, CASES2)),
                          ("solves", (a, b, on_layout))],
                      tmp_path_factory)


@pytest.fixture(scope="module")
def port4(problem, tmp_path_factory):
    a, b = problem
    return spawn_jobs(4, [("solves", (a, b, {"bj": BJ}))], tmp_path_factory)


@pytest.mark.parametrize("name", ["bj", "chebyshev", "none"])
def test_sharded_ell_matches_jax(problem, port2, name):
    a, b = problem
    x, info, kind, n_pad, _ = same_on_every_rank(port2, name)
    sj, x_j, info_j = jax_solve(a, b, 2, CASES2[name])
    assert kind == {"bj": "bj", "chebyshev": "chebyshev", "none": None}[name]
    assert n_pad == sj.layout.n_pad
    assert_parity(a, b, (x, info), (sj, x_j, info_j), TOL)


def test_sharded_ell_at_4_ranks_matches_jax(problem, port4):
    a, b = problem
    x, info, _, n_pad, _ = same_on_every_rank(port4, "bj")
    sj, x_j, info_j = jax_solve(a, b, 4, BJ)
    assert n_pad == sj.layout.n_pad
    assert_parity(a, b, (x, info), (sj, x_j, info_j), TOL)


def test_sharded_ell_on_a_caller_layout_matches_jax(problem, port2):
    a, b = problem
    x, info = port2[0][1]["on_layout"][:2]
    for r in port2[1:]:
        np.testing.assert_array_equal(r[1]["on_layout"][0], x)
    lay = jax_contiguous(a.shape[0], 2, row_multiple=24)
    res_j = jax_solve(a, b, 2, BJ, layout=lay)
    assert_parity(a, b, (x, info), res_j, TOL)


def test_sharded_ell_f32_device_rounds(problem, port2):
    """f32 to 1e-6: device double-float rounds on the exchanged panel reach
    the tolerance; iterations within 25 % of JAX's (whose double-float
    rounds lose accuracy on the CPU, tests/test_torch_driver.py)."""
    a, b = problem
    x, info, _, _, _ = same_on_every_rank(port2, "f32")
    _, x_j, info_j = jax_solve(a, b, 2, CASES2["f32"])
    assert info["device_rounds"] >= 1 and not info["breakdown"]
    assert relres(a, x, b) < 1e-6 and relres(a, x_j, b) < 1e-6
    assert abs(info["iters"] - info_j["iters"]) <= 0.25 * info_j["iters"]
