"""The two-level block-banded solve against the JAX package, f64.

``prepare_two_level`` folds the factors of ``block_banded_cholesky`` for
the row-shared solve; ``block_banded_solve_two_level`` shares each step's
rows between the ranks of a group (2 gloo ranks here, each with bs/2 rows
of every factor block) with one all-gather per block step. Both are held
to the JAX versions to 1e-12: the JAX solve under a 2-device
``shard_map`` on the conftest's CPU devices. The one-rank form (no group)
is held to the plain banded solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from prealps_tpu.direct import banded as jb
from prealps_tpu_torch.direct import banded as tb
from sharded_cases import spawn_jobs

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

PARTS, NBLK, BS, T = 2, 5, 12, 3


def _spd_band(seed):
    """(d, e) of a batched SPD block-tridiagonal matrix."""
    rng = np.random.default_rng(seed)
    e = 0.3 * rng.standard_normal((PARTS, NBLK, BS, BS))
    e[:, 0] = 0.0
    g = rng.standard_normal((PARTS, NBLK, BS, BS))
    d = np.einsum("pnij,pnkj->pnik", g, g) / BS + 4.0 * np.eye(BS)
    return d, e


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d, e = _spd_band(0)
    v = np.random.default_rng(1).standard_normal((PARTS, NBLK, BS, T))
    fac2 = jb.prepare_two_level(jb.block_banded_cholesky(jnp.asarray(d), jnp.asarray(e)))
    mesh = Mesh(np.array(jax.devices()[:2]), ("loc",))
    specs = jax.tree_util.tree_map(lambda _: P(None, None, "loc", None), fac2)
    solve = jax.jit(shard_map(
        lambda f, x: jb.block_banded_solve_two_level(f, x, "loc", 2),
        mesh=mesh, in_specs=(specs, P()), out_specs=P(), check_vma=False))
    want = np.asarray(solve(fac2, jnp.asarray(v)))
    port = spawn_jobs(2, [("banded_two_level", (d, e, v))], tmp_path_factory)
    return d, e, v, fac2, want, port


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_prepare_two_level_matches_jax(case):
    d, e, _, fac2, _, _ = case
    got = tb.prepare_two_level(tb.block_banded_cholesky(torch.from_numpy(d),
                                                        torch.from_numpy(e)))
    for name in ("l_inv", "w_fwd", "l_inv_t", "w_bwd"):
        assert _rel(getattr(got, name).numpy(), np.asarray(getattr(fac2, name))) < 1e-12
    # the ranks' folded factors are the host's
    for name, arr in case[5][0][0][1].items():
        np.testing.assert_array_equal(arr, getattr(got, name).numpy())


def test_two_level_solve_over_two_ranks_matches_jax(case):
    d, e, v, _, want, port = case
    w0 = port[0][0][0]
    np.testing.assert_array_equal(port[1][0][0], w0)
    assert _rel(w0, want) < 1e-12
    # and it solves the system: A w = v
    av = tb.block_banded_matvec(torch.from_numpy(d), torch.from_numpy(e),
                                torch.from_numpy(w0)).numpy()
    assert _rel(av, v) < 1e-10


def test_two_level_solve_on_one_rank_is_the_banded_solve(case):
    d, e, v, _, want, _ = case
    fac = tb.block_banded_cholesky(torch.from_numpy(d), torch.from_numpy(e))
    got = tb.block_banded_solve_two_level(tb.prepare_two_level(fac), torch.from_numpy(v))
    assert _rel(got.numpy(), tb.block_banded_solve(fac, torch.from_numpy(v)).numpy()) < 1e-12
    assert _rel(got.numpy(), want) < 1e-12


def test_rows_slices_every_factor(case):
    d, e, *_ = case
    fac2 = tb.prepare_two_level(tb.block_banded_cholesky(torch.from_numpy(d),
                                                         torch.from_numpy(e)))
    part = fac2.rows(6, 12)
    for name in ("l_inv", "w_fwd", "l_inv_t", "w_bwd"):
        arr = getattr(part, name)
        assert arr.shape == (PARTS, NBLK, 6, BS) and arr.is_contiguous()
        torch.testing.assert_close(arr, getattr(fac2, name)[:, :, 6:12], rtol=0, atol=0)
