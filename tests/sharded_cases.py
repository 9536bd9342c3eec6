"""Shared pieces of the sharded-driver tests (tests/test_torch_sharded_*.py):
the JAX package's solve at a given ``nshards`` on the conftest's CPU
devices, and one ``mesh.spawn`` of the port's ranks (gloo, a FileStore in
a fresh directory, its own timeout) running the jobs of
``torch_shard_workers``. The parent imports JAX; the ranks do not.
"""

import numpy as np

import torch_shard_workers
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel import mesh

SPAWN_TIMEOUT = 120        # seconds a spawn may take before its ranks are killed
X_RTOL = 1e-8              # f64: ‖x_port − x_jax‖ / ‖x_jax‖
ITERS = 1                  # iteration counts within ±1


def relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def jax_solve(a, b, nshards, case, **extra):
    """The JAX driver's build over ``nshards`` CPU devices and its solve;
    ``case`` the build keywords with ``opts`` a dict. Returns (solver, x,
    info)."""
    kw = dict(case)
    opts = JaxOptions(**kw.pop("opts"))
    s = JaxECG.build(a, nshards=nshards, opts=opts, **kw, **extra)
    x, info = s.solve(b)
    return s, x, info


def spawn_jobs(world, jobs, tmp_path_factory):
    """Run ``torch_shard_workers.several(jobs)`` on ``world`` gloo ranks;
    returns the per-rank lists of job results."""
    store = tmp_path_factory.mktemp(f"store{world}") / "store"
    return mesh.spawn(torch_shard_workers.several, world, args=(jobs,),
                      init_method=f"file://{store}", timeout=SPAWN_TIMEOUT)


def same_on_every_rank(results, name):
    """Every rank's (x, info) of solve ``name`` (in its first job) equal;
    returns rank 0's."""
    x0, info0 = results[0][0][name][:2]
    for r in results[1:]:
        x, info = r[0][name][:2]
        np.testing.assert_array_equal(x, x0)
        assert info == info0
    return results[0][0][name]


def assert_parity(a, b, port, jax_result, tol):
    """Iterations ±1, f64 x within X_RTOL of JAX's, relres below tol."""
    x, info = port[:2]
    _, x_j, info_j = jax_result
    assert not info["breakdown"]
    assert abs(info["iters"] - info_j["iters"]) <= ITERS, (info["iters"], info_j["iters"])
    assert np.linalg.norm(x - x_j) <= X_RTOL * np.linalg.norm(x_j)
    assert relres(a, x, b) < tol
