"""The sharded communication-avoiding kernels and the timing ablation at 4
gloo ranks on the CPU, against the JAX package on a 4-device mesh.

One ``mesh.spawn`` of 4 ranks (a FileStore, its own timeout) runs every
case (``torch_shard_workers.lx_sharded`` and ``.ablation``; the ranks make
their inputs from the same seeds, so the spawn's arguments stay small):

* ``tsqr_r_distributed`` (rows sharded), ``tournament_select_sharded`` and
  ``tp_qr_sharded`` (columns sharded) on tests/test_tournament_dist.py's
  and tests/test_kernels.py's inputs (seed 42), held to JAX's
  ``shard_map`` results: R and Q within 1e-10, the selections equal, every
  rank the same;
* the ablation (``PREALPS_TIMING_NO_COLLECTIVES``): a stencil ECG solve
  (Chebyshev, f64, 3 iterations at tol 1e-30) on a 2-rank subgroup; with
  the knob on it makes no all-reduce and no ring exchange, and its x
  equals the JAX driver's with the variable set before its build within
  1e-10; with the knob at 0, x is bitwise the ordinary solve's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

import torch_shard_workers
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.ops.tournament import tournament_select_sharded, tp_qr_sharded
from prealps_tpu.ops.tsqr import tsqr_r_distributed
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.parallel.mesh import make_mesh
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel import mesh

torch.set_num_threads(1)

WORLD = 4
AXIS = "shards"
TOL = 1e-10
SPAWN_TIMEOUT = 120
KNOB = "PREALPS_TIMING_NO_COLLECTIVES"
ABLATION_RANKS = 2
ABLATION = dict(fmt="stencil", br=3, precond="chebyshev", dtype=np.float64,
                refine=False,
                opts=dict(t=4, tol=1e-30, maxiter=3, variant="odir_fused",
                          layout="tbn"))


def _inputs():
    """Each JAX test's input from its own default_rng(42), made in numpy by
    the ranks' module (the ranks make them too)."""
    return torch_shard_workers.lx_inputs()


def _problem():
    """The ablation's problem, as the ranks make it with the port's
    generator (``torch_shard_workers.ablation``)."""
    a = elasticity3d(6, 5, 5)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    store = tmp_path_factory.mktemp("lx_store") / "store"
    jobs = [("lx_sharded", ()), ("ablation", (ABLATION_RANKS, ABLATION))]
    return mesh.spawn(torch_shard_workers.several, WORLD, args=(jobs,),
                      init_method=f"file://{store}", timeout=SPAWN_TIMEOUT)


def _jax_sharded(fn, x, in_spec, out_specs):
    f = jax.jit(_shard_map(fn, mesh=make_mesh(WORLD, AXIS), in_specs=(in_spec,),
                           out_specs=out_specs, check_vma=False))
    return f(jnp.asarray(x))


def _same_on_every_rank(port, key, part=None):
    """Rank 0's result of ``key`` (its ``part``-th entry), checked bitwise
    equal on every rank."""
    pick = (lambda v: v) if part is None else (lambda v: v[part])
    first = pick(port[0][0][key])
    for r in port[1:]:
        np.testing.assert_array_equal(pick(r[0][key]), first)
    return first


def test_tsqr_r_distributed(port):
    x = _inputs()[0]
    r = _same_on_every_rank(port, "tsqr_r")
    r_j = np.asarray(_jax_sharded(lambda xl: tsqr_r_distributed(xl, AXIS), x,
                                  P(AXIS), P()))
    np.testing.assert_allclose(r, r_j, rtol=TOL, atol=TOL)
    r_np = np.linalg.qr(x, mode="r")
    np.testing.assert_allclose(r, r_np * np.sign(np.diag(r_np))[:, None],
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", ["dominant", "quality"])
def test_tournament_select_sharded(port, name):
    _, select, _, pos = _inputs()
    a, k = select[name]
    cols = _same_on_every_rank(port, name)
    cols_j = np.asarray(_jax_sharded(
        lambda al: tournament_select_sharded(al, AXIS, k), a, P(None, AXIS), P()))
    assert cols.tolist() == cols_j.tolist()
    if name == "dominant":
        assert set(cols.tolist()) == set(pos.tolist())


def test_tp_qr_sharded(port):
    _, _, qr, _ = _inputs()
    a, k = qr["tp_qr"]
    q = _same_on_every_rank(port, "tp_qr", 0)
    cols = _same_on_every_rank(port, "tp_qr", 2)
    q_j, r_j, cols_j = _jax_sharded(lambda al: tp_qr_sharded(al, AXIS, k), a,
                                    P(None, AXIS), (P(), P(None, AXIS), P()))
    r = np.concatenate([rk[0]["tp_qr"][1] for rk in port], axis=1)
    assert cols.tolist() == np.asarray(cols_j).tolist()
    np.testing.assert_allclose(q, np.asarray(q_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r, np.asarray(r_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(q.T @ q, np.eye(k), atol=1e-8)
    assert np.linalg.norm(a - q @ r) / np.linalg.norm(a) < 1e-6
    assert np.unique(cols).size == k


def test_sharded_collectives(port):
    """tsqr_r_distributed one untiled all-gather; each selection a tiled and
    an untiled one."""
    assert all(r[0]["all_gather_calls"] == 1 + 2 * 2 + 2 for r in port)


@pytest.fixture(scope="module")
def jax_ablated():
    """The JAX driver at nshards 2 with the knob set before its build (its
    collectives are dropped when the solve is traced)."""
    a, b = _problem()
    kw = dict(ABLATION)
    opts = JaxOptions(**kw.pop("opts"))
    os.environ[KNOB] = "1"
    try:
        return JaxECG.build(a, nshards=ABLATION_RANKS, opts=opts, **kw).solve(b)
    finally:
        os.environ.pop(KNOB, None)


def test_ablation_drops_the_collectives(port, jax_ablated):
    x_on_j, info_on_j = jax_ablated
    res = [r[1] for r in port]
    assert all(r is None for r in res[ABLATION_RANKS:])
    for r in res[:ABLATION_RANKS]:
        x_on, iters_on, calls_on = r["on"]
        assert iters_on == int(info_on_j["iters"]) == 3
        assert calls_on["all_reduce"] == 0 and calls_on["ring_exchange"] == 0
        assert calls_on["all_gather"] >= 1                  # x, at the end
        np.testing.assert_allclose(x_on, x_on_j, rtol=TOL,
                                   atol=TOL * np.abs(x_on_j).max())
        x_plain, iters_plain, calls_plain = r["plain"]
        assert calls_plain["all_reduce"] > 0 and calls_plain["ring_exchange"] > 0
        assert iters_plain == 3
        # the knob at 0 is off: bitwise the ordinary solve
        np.testing.assert_array_equal(r["off"][0], x_plain)
        assert r["off"][2] == calls_plain
        # and wrong by construction with it on
        assert not np.allclose(x_on, x_plain)
    np.testing.assert_array_equal(res[0]["on"][0], res[1]["on"][0])
    assert KNOB not in os.environ
