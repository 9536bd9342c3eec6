"""The port's Lanczos eigensolvers (ops/lanczos.py) against the JAX
package's, in f64.

A small SPD pencil S u = λ B u (n = 64, B diagonally dominant SPD) with the
same closures on both sides (OP = B⁻¹S by a dense inverse). Scalar,
thick-restart and block thick-restart: the smallest Ritz values agree with
the JAX package's and with scipy.linalg.eigh(S, B) to 1e-8 relative, and
the residual estimates with the JAX package's. resolve_block_policy agrees
on a grid of inputs, and rayleigh_ritz_refine agrees in values, B-norms, residuals and (up to each
column's sign) vectors.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

from prealps_tpu.ops import lanczos as jl
from prealps_tpu_torch.ops import lanczos as tl

torch.set_num_threads(1)

N = 64


@pytest.fixture(scope="module")
def pencil():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    lam = np.concatenate([[1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 0.1, 0.2],
                          np.linspace(1.0, 1.5, N - 8)])
    s = (q * lam) @ q.T
    s = 0.5 * (s + s.T)
    m = 0.1 * rng.standard_normal((N, N))
    b = np.eye(N) + 0.5 * (m + m.T) * (np.abs(np.subtract.outer(range(N), range(N))) <= 2)
    b = 0.5 * (b + b.T)
    op = np.linalg.solve(b, s)
    ref = scipy.linalg.eigh(s, b, eigvals_only=True)
    return s, b, op, ref


def _closures(pencil, lib):
    _, b, op, _ = pencil
    if lib == "jax":
        opj, bj = jnp.asarray(op), jnp.asarray(b)
        return (lambda v: opj @ v), (lambda v: bj @ v)
    opt, bt = torch.from_numpy(op), torch.from_numpy(b)
    return (lambda v: opt @ v), (lambda v: bt @ v)


def _check(res_t, res_j, ref, k):
    """The k smallest Ritz values equal the JAX package's and the pencil's
    eigenvalues to 1e-8; the residual estimates equal the JAX package's
    (to 1e-12 absolute where both sit at rounding level)."""
    th_t, th_j = res_t.eigvalues.numpy(), np.asarray(res_j.eigvalues)
    np.testing.assert_allclose(th_t[:k], th_j[:k], rtol=1e-8)
    np.testing.assert_allclose(th_t[:k], ref[:k], rtol=1e-8)
    rs_t, rs_j = res_t.resid.numpy()[:k], np.asarray(res_j.resid)[:k]
    np.testing.assert_allclose(rs_t, rs_j, rtol=1e-4, atol=1e-12)


def test_lanczos_gen_matches_jax_and_scipy(pencil):
    ref = pencil[3]
    res_t = tl.lanczos_gen(*_closures(pencil, "torch"), N, 40, dtype=torch.float64,
                           device="cpu")
    res_j = jl.lanczos_gen(*_closures(pencil, "jax"), N, 40, dtype=jnp.float64)
    _check(res_t, res_j, ref, k=8)


def test_thick_restart_matches_jax_and_scipy(pencil):
    ref = pencil[3]
    res_t = tl.lanczos_thick_restart(*_closures(pencil, "torch"), N, 20, nev=6,
                                     restarts=4, dtype=torch.float64, device="cpu")
    res_j = jl.lanczos_thick_restart(*_closures(pencil, "jax"), N, 20, nev=6,
                                     restarts=4, dtype=jnp.float64)
    _check(res_t, res_j, ref, k=6)


def test_block_thick_restart_matches_jax_and_scipy(pencil):
    ref = pencil[3]
    op_t, b_t = _closures(pencil, "torch")
    op_j, b_j = _closures(pencil, "jax")
    res_t = tl.block_lanczos_thick_restart(op_t, b_t, N, nblocks=6, nev=6, bt=4,
                                           restarts=8, dtype=torch.float64,
                                           device="cpu")
    res_j = jl.block_lanczos_thick_restart(op_j, b_j, N, nblocks=6, nev=6, bt=4,
                                           restarts=8, dtype=jnp.float64)
    assert res_t.eigvectors.shape == (N, 24)
    _check(res_t, res_j, ref, k=6)


def test_block_thick_restart_needs_three_blocks(pencil):
    with pytest.raises(ValueError, match="nblocks"):
        tl.block_lanczos_thick_restart(*_closures(pencil, "torch"), N, nblocks=2,
                                       nev=2, bt=4, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("restarts,ncv,ndim,blk", [
    (5, 513, 11772, None), (5, 129, 600, None), (5, 341, 342, None),
    (0, 129, 600, None), (5, 129, 600, 1), (5, 20, 22, 8), (12, 513, 20000, 8),
    (5, 129, 600, 4)])
def test_resolve_block_policy_matches_jax(restarts, ncv, ndim, blk):
    assert (tl.resolve_block_policy(restarts, ncv, ndim, blk=blk)
            == jl.resolve_block_policy(restarts, ncv, ndim, blk=blk))


def test_rayleigh_ritz_refine_matches_jax(pencil):
    s, b, _, ref = pencil
    rng = np.random.default_rng(7)
    # candidates near the low eigenvectors, plus a duplicate column
    _, vec = scipy.linalg.eigh(s, b)
    vecs = vec[:, :8] + 1e-5 * rng.standard_normal((N, 8))
    vecs = np.concatenate([vecs, vecs[:, :1]], axis=1)
    sv, bv = s @ vecs, b @ vecs
    out_t = [v.numpy() for v in tl.rayleigh_ritz_refine(
        *(torch.from_numpy(a) for a in (vecs, sv, bv)))]
    out_j = [np.asarray(v) for v in jl.rayleigh_ritz_refine(
        *(jnp.asarray(a) for a in (vecs, sv, bv)))]
    theta_t, vecs_t, bn_t, rs_t = out_t
    theta_j, vecs_j, bn_j, rs_j = out_j
    keep = theta_j < 1e5           # the dropped duplicate surfaces at 1e6
    assert keep.sum() == 8
    np.testing.assert_allclose(theta_t, theta_j, rtol=1e-10)
    np.testing.assert_allclose(bn_t[keep], bn_j[keep], rtol=1e-10)
    np.testing.assert_allclose(rs_t[keep], rs_j[keep], rtol=1e-6, atol=1e-12)
    sign = np.sign(np.sum(vecs_t[:, keep] * vecs_j[:, keep], axis=0))
    np.testing.assert_allclose(vecs_t[:, keep] * sign, vecs_j[:, keep], atol=1e-9)
    # a 1e-5 perturbation of the eigenvectors moves the values by ~(1e-5)²
    np.testing.assert_allclose(theta_t[keep], ref[:8], rtol=0, atol=1e-8)
