"""The port's batched block-banded Cholesky (direct/banded.py) against the
JAX package's, in f64.

A random SPD block-tridiagonal system (P = 3 parts, nblk = 4 blocks of
bs = 8) and random panels on both sides: factors, both solve layouts and
the matvec held to 1e-10 relative; the solves also against a dense numpy
solve. A system whose second block is indefinite fails on both sides, with
the same zeroed factors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prealps_tpu.direct import banded as jb
from prealps_tpu_torch.direct import banded as tb

torch.set_num_threads(1)

P, NBLK, BS, T = 3, 4, 8, 5


def _system(seed, indefinite=False):
    """(D, E) of P SPD block-tridiagonal matrices, and their dense forms."""
    rng = np.random.default_rng(seed)
    n = NBLK * BS
    dense = np.zeros((P, n, n))
    for p in range(P):
        m = rng.standard_normal((n, n))
        band = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) <= BS
        a = (m @ m.T) * band + n * np.eye(n)
        dense[p] = 0.5 * (a + a.T)
    if indefinite:
        dense[1, BS:2 * BS, BS:2 * BS] -= 4 * n * np.eye(BS)
    d = np.zeros((P, NBLK, BS, BS))
    e = np.zeros((P, NBLK, BS, BS))
    for i in range(NBLK):
        d[:, i] = dense[:, i * BS:(i + 1) * BS, i * BS:(i + 1) * BS]
        if i:
            e[:, i] = dense[:, i * BS:(i + 1) * BS, (i - 1) * BS:i * BS]
    return d, e, dense


@pytest.fixture(scope="module")
def factored():
    d, e, dense = _system(0)
    fj = jb.block_banded_cholesky(jnp.asarray(d), jnp.asarray(e))
    ft = tb.block_banded_cholesky(torch.from_numpy(d), torch.from_numpy(e))
    return d, e, dense, fj, ft


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("field", ["l_inv", "m_off"])
def test_cholesky_matches_jax(factored, field):
    *_, fj, ft = factored
    assert not bool(ft.failed) and not bool(fj.failed)
    assert _rel(getattr(ft, field).numpy(), np.asarray(getattr(fj, field))) < 1e-10


def test_cholesky_shift_matches_jax():
    d, e, _ = _system(1)
    fj = jb.block_banded_cholesky(jnp.asarray(d), jnp.asarray(e), shift=0.05)
    ft = tb.block_banded_cholesky(torch.from_numpy(d), torch.from_numpy(e), shift=0.05)
    assert _rel(ft.l_inv.numpy(), np.asarray(fj.l_inv)) < 1e-10


def test_solve_matches_jax_and_dense(factored):
    *_, dense, fj, ft = factored
    v = np.random.default_rng(2).standard_normal((P, NBLK, BS, T))
    wt = tb.block_banded_solve(ft, torch.from_numpy(v)).numpy()
    wj = np.asarray(jb.block_banded_solve(fj, jnp.asarray(v)))
    assert _rel(wt, wj) < 1e-10
    w_dense = np.linalg.solve(dense, v.reshape(P, NBLK * BS, T))
    assert _rel(wt.reshape(P, NBLK * BS, T), w_dense) < 1e-10


def test_solve_t_matches_jax_and_dense(factored):
    *_, dense, fj, ft = factored
    v3 = np.random.default_rng(3).standard_normal((NBLK, P, T, BS))
    wt = tb.block_banded_solve_t(ft, torch.from_numpy(v3)).numpy()
    wj = np.asarray(jb.block_banded_solve_t(fj, jnp.asarray(v3)))
    assert wt.shape == (NBLK, P, T, BS)
    assert _rel(wt, wj) < 1e-10
    rhs = v3.transpose(1, 0, 3, 2).reshape(P, NBLK * BS, T)
    w_dense = np.linalg.solve(dense, rhs)
    assert _rel(wt.transpose(1, 0, 3, 2).reshape(P, NBLK * BS, T), w_dense) < 1e-10


def test_matvec_matches_jax_and_dense(factored):
    d, e, dense, _, _ = factored
    v = np.random.default_rng(4).standard_normal((P, NBLK, BS, T))
    yt = tb.block_banded_matvec(torch.from_numpy(d), torch.from_numpy(e),
                                torch.from_numpy(v)).numpy()
    yj = np.asarray(jb.block_banded_matvec(jnp.asarray(d), jnp.asarray(e),
                                           jnp.asarray(v)))
    assert _rel(yt, yj) < 1e-12
    assert _rel(yt.reshape(P, -1, T), dense @ v.reshape(P, -1, T)) < 1e-12


def test_failed_factor_is_flagged_like_jax():
    """An indefinite block: both flag `failed`, zero that block's inverses
    in every part, and agree on every factor."""
    d, e, _ = _system(5, indefinite=True)
    fj = jb.block_banded_cholesky(jnp.asarray(d), jnp.asarray(e))
    ft = tb.block_banded_cholesky(torch.from_numpy(d), torch.from_numpy(e))
    assert bool(ft.failed) and bool(fj.failed)
    assert not ft.l_inv[:, 1].any()
    np.testing.assert_allclose(ft.l_inv.numpy(), np.asarray(fj.l_inv),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ft.m_off.numpy(), np.asarray(fj.m_off),
                               rtol=1e-10, atol=1e-12)
