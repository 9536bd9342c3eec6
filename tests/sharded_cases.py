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
LORASC_SPAWN_TIMEOUT = 300  # the distributed LORASC's builds (8 ranks on 8 cores)
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


def spawn_jobs(world, jobs, tmp_path_factory, timeout=SPAWN_TIMEOUT):
    """Run ``torch_shard_workers.several(jobs)`` on ``world`` gloo ranks;
    returns the per-rank lists of job results."""
    store = tmp_path_factory.mktemp(f"store{world}") / "store"
    return mesh.spawn(torch_shard_workers.several, world, args=(jobs,),
                      init_method=f"file://{store}", timeout=timeout)


def lorasc_reference(s):
    """A JAX DistributedLorascECG's operands and sizes as
    ``interop.distributed_lorasc_from_reference`` takes them: (arrays,
    meta), numpy."""
    import dataclasses

    ops = s._operands[0]
    arrays = {k: np.asarray(v) for k, v in ops.items() if k not in ("fac", "agg_fac")}
    for name in ("l_inv", "w_fwd", "l_inv_t", "w_bwd"):
        arrays[name] = np.asarray(getattr(ops["fac"], name))
    if "agg_fac" in ops:
        arrays["agg_l_inv"] = np.asarray(ops["agg_fac"].l_inv)
        arrays["agg_m_off"] = np.asarray(ops["agg_fac"].m_off)
    arrays.update(scale_d=s.scale_d, arrow_perm=s.arrow_perm, row_of=s.row_of,
                  a_scaled=s.a_scaled)
    meta = dict(ngroups=s.ngroups, nlocal=s.nlocal, ni_max=s.ni_max,
                ng_max=s.ng_max, n=s.n, deflated=s.deflated,
                target_tol=s.target_tol, opts=dataclasses.asdict(s.opts))
    return arrays, meta


def jax_lorasc_applies(s, vectors):
    """The JAX build's preconditioner on each vector (original ordering,
    scaled space): its solve with ``ecg_solve`` replaced, while the solve
    is traced, by one that returns M·b. ``s`` must not have solved yet."""
    import jax.numpy as jnp

    from prealps_tpu.parallel import lorasc_driver
    from prealps_tpu.solvers.ecg import ECGResult

    def apply_only(a_apply, m_apply, b_loc, opts, axis_name=None, split_assign=None):
        z = jnp.zeros((), b_loc.dtype)
        return ECGResult(x=m_apply(b_loc[:, None])[:, 0], iters=jnp.int32(0), res=z,
                         normb=z, bs=jnp.int32(0), breakdown=jnp.bool_(False),
                         history=jnp.zeros((1,), b_loc.dtype))

    real = lorasc_driver.ecg_solve
    lorasc_driver.ecg_solve = apply_only
    try:
        return [s._solve_scaled_once(v)[0] for v in vectors]
    finally:
        lorasc_driver.ecg_solve = real


def jax_driver_applies(s, vectors):
    """The JAX DistributedECG's preconditioned product M·A·v for each
    vector (original ordering, scaled space): its ``_solve_scaled_once``
    with ``ecg_solve`` replaced, while the solve is traced, by one that
    returns M·A·b. ``s`` must not have solved yet."""
    import jax.numpy as jnp

    from prealps_tpu.parallel import driver
    from prealps_tpu.solvers.ecg import ECGResult

    def product_only(a_apply, m_apply, b_loc, opts, axis_name=None, split_assign=None):
        p = b_loc[:, None] if b_loc.ndim == 1 else b_loc[None]
        y = m_apply(a_apply(p))
        z = jnp.zeros((), b_loc.dtype)
        return ECGResult(x=y[:, 0] if b_loc.ndim == 1 else y[0], iters=jnp.int32(0),
                         res=z, normb=z, bs=jnp.int32(0), breakdown=jnp.bool_(False),
                         history=jnp.zeros((1,), b_loc.dtype))

    real = driver.ecg_solve
    driver.ecg_solve = product_only
    try:
        return [s._solve_scaled_once(v)[0] for v in vectors]
    finally:
        driver.ecg_solve = real


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
