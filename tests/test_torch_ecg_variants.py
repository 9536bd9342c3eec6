"""The port's unstacked ECG variants against the JAX package's, in f64.

Both sides get callbacks on the same numpy arrays: the scaled, padded
elasticity3d(6,6,6) in ELL with the host block Jacobi (f64 Cholesky, six
RCM-ordered blocks) — the general path's operators at a CPU size. Held to:
one step from the same JAX state to 1e-10; whole solves to equal iteration
counts (±1), residual histories within 1e-6 relative and x within 1e-8
relative, on row-major ("nt") panels and on unstacked lane-major ("tbn")
panels of shape (t, n_pad). Plus the small dense pieces the variants use:
NT panel operations, triangular panel solves and the pivoted Cholesky of
the adaptive omin step (same pivots on ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import build_row_layout, permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops import blockops as jblk
from prealps_tpu.ops.formats import csr_to_ell
from prealps_tpu.ops.spmm import ell_spmm
from prealps_tpu.precond.block_jacobi import build_block_jacobi
from prealps_tpu.solvers import ecg as jecg
from prealps_tpu.solvers.panels import NT as JNT
from prealps_tpu.solvers.panels import TBN as JTBN
from prealps_tpu_torch.ops import blockops as tblk
from prealps_tpu_torch.ops.formats import EllMatrix
from prealps_tpu_torch.ops.spmm import ell_spmm as t_ell_spmm
from prealps_tpu_torch.precond.block_jacobi import BlockJacobi
from prealps_tpu_torch.solvers import ecg as tecg
from prealps_tpu_torch.solvers.panels import NT as TNT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system():
    a, _ = sym_rac_scaling(elasticity3d(6, 6, 6, heterogeneous=False))
    lay = build_row_layout(a, 1, row_multiple=8)
    a_pad = permute_and_pad_matrix(a, lay)
    ell = csr_to_ell(a_pad, dtype=np.float64)
    bj = build_block_jacobi(a_pad, nblocks=6, dtype=np.float64)
    bj_t = BlockJacobi(
        factors=torch.from_numpy(np.array(bj.factors)),
        gather_idx=torch.from_numpy(np.array(bj.gather_idx, dtype=np.int64)),
        inv_perm=torch.from_numpy(np.array(bj.inv_perm, dtype=np.int64)),
        mode=bj.mode)
    ell_t = EllMatrix(torch.from_numpy(np.array(ell.vals)),
                      torch.from_numpy(np.array(ell.cols)), ell.shape)
    n_pad = lay.n_pad
    b = np.random.default_rng(11).standard_normal(n_pad)
    b[lay.n:] = 0.0
    return dict(
        a_j=lambda x: ell_spmm(ell, x), m_j=bj.apply,
        a_t=lambda x: t_ell_spmm(ell_t, x), m_t=bj_t.apply, b=b, n_pad=n_pad)


def _lane(fn):
    """A row-major callback on (t, n) lane-major panels."""
    return lambda p: fn(p.T).T


def _opts(**kw):
    base = dict(t=4, tol=1e-9, maxiter=300, variant="odir_fused", layout="nt")
    base.update(kw)
    return jecg.ECGOptions(**base), tecg.ECGOptions(**base)


def _assign(n_pad, t):
    return (np.arange(n_pad) * t) // n_pad


VARIANTS = [dict(variant=v) for v in ("odir_fused", "odir", "omin")] + [
    dict(variant="odir_fused", adaptive=True),
    dict(variant="odir", adaptive=True),
    dict(variant="odir", adaptive=True, adaptive_mode="freeze"),
    dict(variant="omin", adaptive=True),
]


def _solve_both(system, kw, layout):
    oj, ot = _opts(layout=layout, **kw)
    assign = _assign(system["n_pad"], ot.t)
    b = system["b"]
    fns_j = (system["a_j"], system["m_j"])
    fns_t = (system["a_t"], system["m_t"])
    if layout == "tbn":
        fns_j = tuple(_lane(f) for f in fns_j)
        fns_t = tuple(_lane(f) for f in fns_t)
    rj = jecg.ecg_solve(*fns_j, jnp.asarray(b), oj, split_assign=jnp.asarray(assign))
    rt = tecg.ecg_solve(*fns_t, torch.from_numpy(b), ot,
                        split_assign=torch.from_numpy(assign))
    return rj, rt, ot


@pytest.mark.parametrize("layout", ["nt", "tbn"])
@pytest.mark.parametrize("kw", VARIANTS)
def test_solve_matches(system, kw, layout):
    if layout == "tbn" and kw["variant"] == "odir_fused":
        kw = dict(kw, stacked=False)
    rj, rt, ot = _solve_both(system, kw, layout)
    it_j, it_t = int(rj.iters), rt.iters
    assert abs(it_t - it_j) <= 1, (it_t, it_j)
    assert not rt.breakdown and not bool(rj.breakdown)
    assert rt.bs == int(rj.bs)
    k = min(it_t, it_j)
    if kw.get("adaptive") and kw.get("adaptive_mode", "truncate") == "truncate":
        # the reference's truncating reduction collapses the block to one
        # direction (~iteration 50 here) and the stalled recurrence is
        # rounding-chaotic in any two f64 groupings: the same schedule and
        # solution, histories compared before the collapse (as
        # tests/test_parity.py does)
        k = min(k, 40)
    np.testing.assert_allclose(rt.history.numpy()[:k], np.asarray(rj.history)[:k],
                               rtol=1e-6)
    assert rt.history.numpy()[it_t:].tolist() == [-1.0] * (ot.maxiter - it_t)
    x_j = np.asarray(rj.x)
    assert rt.x.shape == x_j.shape
    assert np.linalg.norm(rt.x.numpy() - x_j) <= 1e-8 * np.linalg.norm(x_j)


def _port_state(sj):
    f = lambda v: torch.from_numpy(np.array(v))
    return tecg.ECGPanelState(
        x_blk=f(sj.x_blk), r=f(sj.r), p=f(sj.p), ap=f(sj.ap), p_prev=f(sj.p_prev),
        ap_prev=f(sj.ap_prev), z=f(sj.z), mask=f(sj.mask), it=int(sj.it),
        res=torch.tensor(float(sj.res), dtype=torch.float64),
        breakdown=torch.tensor(bool(sj.breakdown)), history=f(sj.history),
        best_res=torch.tensor(float(sj.best_res), dtype=torch.float64),
        stall=torch.tensor(int(sj.stall), dtype=torch.int32))


@pytest.mark.parametrize("kw", VARIANTS[:3] + [VARIANTS[4], VARIANTS[6]])
def test_one_step_matches(system, kw):
    oj, ot = _opts(**kw)
    assign = jnp.asarray(_assign(system["n_pad"], 4))
    sj, nj = jecg.ecg_init(system["a_j"], system["m_j"], jnp.asarray(system["b"]),
                           oj, split_assign=assign)
    red_tol = (oj.tol * nj / jnp.sqrt(jnp.asarray(4.0))).astype(nj.dtype)
    step_j = jecg._ITER_FNS[oj.variant]
    for _ in range(3):
        sj = step_j(sj, system["a_j"], system["m_j"], None, oj, nj, red_tol, JNT)
    st = _port_state(sj)
    st1 = tecg._ITER_FNS[ot.variant](
        st, system["a_t"], system["m_t"], ot, torch.tensor(float(nj)),
        torch.tensor(float(red_tol), dtype=torch.float64), TNT)
    sj1 = step_j(sj, system["a_j"], system["m_j"], None, oj, nj, red_tol, JNT)
    for name in ("x_blk", "r", "p", "ap", "p_prev", "ap_prev", "z"):
        want = np.asarray(getattr(sj1, name))
        np.testing.assert_allclose(getattr(st1, name).numpy(), want, rtol=1e-10,
                                   atol=1e-10 * max(np.abs(want).max(), 1e-300))
    np.testing.assert_allclose(float(st1.res), float(sj1.res), rtol=1e-12)
    np.testing.assert_array_equal(st1.mask.numpy(), np.asarray(sj1.mask))
    assert st1.it == int(sj1.it) == 4


@pytest.mark.parametrize("op", ["gram", "update", "downdate", "rotate",
                                "scale_dirs", "sum_dirs", "split", "take_dirs",
                                "zeros_like_panel", "right_solve"])
def test_nt_panel_ops_match(op):
    rng = np.random.default_rng(5)
    p, x = rng.standard_normal((2, 30, 4))
    coef = rng.standard_normal((4, 4))
    u = np.triu(rng.standard_normal((4, 4))) + 4 * np.eye(4)
    mask = np.array([1.0, 1.0, 0.0, 1.0])
    b = rng.standard_normal(30)
    assign = rng.integers(0, 4, 30)
    idx = np.array([2, 0, 3, 1])
    args = {"gram": (p, x), "update": (x, p, coef), "downdate": (x, p, coef),
            "rotate": (p, coef), "scale_dirs": (p, mask), "sum_dirs": (p,),
            "split": (b, 4, assign), "take_dirs": (p, idx),
            "zeros_like_panel": (b, 4), "right_solve": (u, p)}[op]
    got = getattr(TNT, op)(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                             else a for a in args))
    want = getattr(JNT, op)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)


def test_tbn_right_solve_matches():
    rng = np.random.default_rng(6)
    u = np.triu(rng.standard_normal((4, 4))) + 4 * np.eye(4)
    p = rng.standard_normal((4, 3, 10))
    from prealps_tpu_torch.solvers.panels import TBN as TTBN

    np.testing.assert_allclose(
        TTBN.right_solve(torch.from_numpy(u), torch.from_numpy(p)).numpy(),
        np.asarray(JTBN.right_solve(jnp.asarray(u), jnp.asarray(p))),
        rtol=1e-13, atol=1e-13)


def test_triangular_solves_match():
    rng = np.random.default_rng(7)
    u = np.triu(rng.standard_normal((5, 5))) + 5 * np.eye(5)
    x = rng.standard_normal((20, 5))
    np.testing.assert_allclose(
        tblk.right_tri_solve(torch.from_numpy(u), torch.from_numpy(x)).numpy(),
        np.asarray(jblk.right_tri_solve(jnp.asarray(u), jnp.asarray(x))),
        rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(
        tblk.left_trit_solve(torch.from_numpy(u), torch.from_numpy(x.T)).numpy(),
        np.asarray(jblk.left_trit_solve(jnp.asarray(u), jnp.asarray(x.T))),
        rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("case", ["full", "rank3", "ties"])
def test_pivoted_cholesky_matches(case):
    """Same pivots (first index on ties), rank and factor as the JAX loop."""
    rng = np.random.default_rng(8)
    if case == "full":
        g = rng.standard_normal((6, 9))
    elif case == "rank3":
        g = rng.standard_normal((6, 3)) @ rng.standard_normal((3, 9))
    else:
        g = np.kron(np.eye(3), np.ones((2, 1))) @ rng.standard_normal((3, 9))
    c = g @ g.T
    if case == "ties":
        c = c + np.diag(np.full(6, 2.0))          # exactly equal diagonal pairs
        c[np.arange(6), np.arange(6)] = 5.0
    u_t, piv_t, rank_t = tblk.pivoted_cholesky(torch.from_numpy(c), -1.0)
    u_j, piv_j, rank_j = jblk.pivoted_cholesky(jnp.asarray(c), jnp.asarray(-1.0))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    assert int(rank_t) == int(rank_j)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("variant", ["odir_fused", "omin"])
def test_x0_warm_start_nt_matches(system, variant):
    """ecg_solve(x0=...) on row-major panels (tests/test_ecg.py:216-239):
    the shifted system's rhs is the small initial residual, and the port
    takes the JAX iterations (±1) to the same x (1e-8 relative)."""
    oj, ot = _opts(variant=variant, tol=1e-8)
    b = system["b"]
    x_cold = tecg.ecg_solve(system["a_t"], system["m_t"], torch.from_numpy(b),
                            _opts(variant=variant, tol=1e-11)[1]).x.numpy()
    x0 = x_cold + 1e-4 * np.random.default_rng(1).standard_normal(b.shape)
    rj = jecg.ecg_solve(system["a_j"], system["m_j"], jnp.asarray(b), oj,
                        x0=jnp.asarray(x0))
    rt = tecg.ecg_solve(system["a_t"], system["m_t"], torch.from_numpy(b), ot,
                        x0=torch.from_numpy(x0))
    assert abs(rt.iters - int(rj.iters)) <= 1
    np.testing.assert_allclose(float(rt.normb), float(rj.normb), rtol=1e-12)
    assert float(rt.normb) < 1e-2 * np.linalg.norm(b)
    x_j = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - x_j) <= 1e-8 * np.linalg.norm(x_j)
