"""The sharded stencil path in f32 through the device double-float rounds,
and on shards thinner than the stencil halo, against the JAX driver at the
same ``nshards`` on the conftest's CPU devices.

* f32 bj2l at 2 ranks, tol 1e-6 (refinement past the f32 floor): the same
  iterations (±1) and refinement rounds as JAX's, relres below tol;
  ``precond="bj"`` with ``bj_dtype="bf16"`` (bf16 inverses, "bj_lane")
  within 25 % of JAX's iterations and relres < 5e-5, as the one-shard
  test holds it.
* The all-gather branch of ``extend_ring`` (halo > nodes a shard), f64,
  Chebyshev: elasticity3d(6,6,3) at 4 ranks (40 nodes a shard, halo 57)
  against JAX's stencil at 4 shards; elasticity3d(6,6,2) at 2 ranks (56
  nodes a shard, halo 57, a window longer than the panel) against JAX's
  ELL on the same contiguous layout, because JAX's own stencil fails there
  (its gathered panel is shorter than the slice it takes: ROADMAP.md
  queue C).
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import contiguous_row_layout
from sharded_cases import (
    assert_parity,
    jax_solve,
    relres,
    same_on_every_rank,
    spawn_jobs,
)

torch.set_num_threads(1)

TOL32, TOL64 = 1e-6, 1e-8
OPTS32 = dict(t=4, tol=TOL32, maxiter=3000, variant="odir_fused", layout="tbn")
F32 = {
    "bj2l": dict(fmt="stencil", br=3, precond="bj2l", block_size=24,
                 grid=(9, 9, 8), dtype=np.float32, opts=OPTS32),
    "bj_lane": dict(fmt="stencil", br=3, precond="bj", block_size=24,
                    grid=(9, 9, 8), bj_dtype="bf16", dtype=np.float32,
                    opts=OPTS32),
}
CHEB = dict(fmt="stencil", br=3, precond="chebyshev", dtype=np.float64,
            opts=dict(OPTS32, tol=TOL64))


def _problem(*dims):
    a = elasticity3d(*dims, heterogeneous=False)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


@pytest.fixture(scope="module")
def problems():
    return {"ela8": _problem(8, 8, 8), "thin2": _problem(6, 6, 2),
            "thin4": _problem(6, 6, 3)}


@pytest.fixture(scope="module")
def port2(problems, tmp_path_factory):
    return spawn_jobs(2, [("solves", (*problems["ela8"], F32)),
                          ("solves", (*problems["thin2"], {"cheb": CHEB}))],
                      tmp_path_factory)


@pytest.fixture(scope="module")
def port4(problems, tmp_path_factory):
    return spawn_jobs(4, [("solves", (*problems["thin4"], {"cheb": CHEB}))],
                      tmp_path_factory)


def test_f32_device_rounds_match_jax(problems, port2):
    a, b = problems["ela8"]
    x, info, kind, _, _ = same_on_every_rank(port2, "bj2l")
    _, x_j, info_j = jax_solve(a, b, 2, F32["bj2l"])
    assert kind == "bj2l" and info["device_rounds"] >= 1
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert info["refine_rounds"] == info_j["refine_rounds"]
    assert relres(a, x, b) < TOL32 and relres(a, x_j, b) < TOL32


def test_f32_bf16_block_jacobi_within_band_of_jax(problems, port2):
    a, b = problems["ela8"]
    x, info, kind, _, _ = same_on_every_rank(port2, "bj_lane")
    _, x_j, info_j = jax_solve(a, b, 2, F32["bj_lane"])
    assert kind == "bj_lane" and not info["breakdown"]
    assert abs(info["iters"] - info_j["iters"]) <= 0.25 * info_j["iters"]
    assert relres(a, x, b) < 5e-5


def test_thin_shards_gather_at_4_ranks(problems, port4):
    a, b = problems["thin4"]
    x, info, _, n_pad, (halo, nrb_loc) = same_on_every_rank(port4, "cheb")
    assert (halo, nrb_loc) == (57, 40)        # the all-gather branch
    sj, x_j, info_j = jax_solve(a, b, 4, CHEB)
    assert n_pad == sj.layout.n_pad
    assert_parity(a, b, (x, info), (sj, x_j, info_j), TOL64)


def test_thin_shards_window_longer_than_the_panel(problems, port2):
    a, b = problems["thin2"]
    x, info, _, n_pad, (halo, nrb_loc) = [r[1]["cheb"] for r in port2][0]
    for r in port2[1:]:
        np.testing.assert_array_equal(r[1]["cheb"][0], x)
    assert (halo, nrb_loc) == (57, 56) and nrb_loc + 2 * halo > n_pad // 3
    lay = contiguous_row_layout(a.shape[0], 2, row_multiple=24)
    assert lay.n_pad == n_pad
    ell = dict(CHEB, fmt="ell", opts=dict(CHEB["opts"], layout="nt"))
    del ell["br"]
    sj, x_j, info_j = jax_solve(a, b, 2, ell, layout=lay)
    assert_parity(a, b, (x, info), (sj, x_j, info_j), TOL64)
