"""The port's stacked ODIR-fused ECG against the JAX package's, in f64.

Both sides get the same operator callbacks built from the same numpy
arrays: the stencil SpMM with single-shard wrap halos and the two-level
block-Jacobi preconditioner of the homogeneous elasticity3d(6,6,6) (the
headline operator's family). Held to: one step from the same state to
1e-10; whole solves to equal iteration counts (±1), residual histories
within 1e-6 relative and x within 1e-8 relative. f64 summation orders
differ between XLA and PyTorch and a Krylov solve amplifies those last-bit
differences: measured here to ~5e-8 at the last iteration. (On the
heterogeneous, contrast-1e3 operator the late residual norms drift apart by
up to ~9 % between the two packages — and between any two summation
orders — while x still agrees to ~1e-12.)
"""

import math
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import contiguous_row_layout, pad_to_padded, permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.direct.device_bj import build_device_block_jacobi_flat
from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
from prealps_tpu.ops.spmm import stencil_scan_accumulate
from prealps_tpu.precond import twolevel as jtwo
from prealps_tpu.solvers import ecg as jecg
from prealps_tpu.solvers.panels import TBN as JTBN
from prealps_tpu_torch.parallel.driver import StencilOperands, coarse_inverse_host
from prealps_tpu_torch.solvers import ecg as tecg
from prealps_tpu_torch.solvers.panels import TBN as TTBN

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system():
    """Scaled, padded elasticity3d(6,6,6) with bj2l operands, and both
    packages' (a_apply, m_apply) on them."""
    br, mbn = 3, 16
    a, d = sym_rac_scaling(elasticity3d(6, 6, 6, heterogeneous=False))
    lay = contiguous_row_layout(a.shape[0], 1,
                                row_multiple=math.lcm(math.lcm(8, br), mbn * br))
    a_pad = permute_and_pad_matrix(a, lay)
    st = csr_to_stencil_bsr_t(a_pad, br=br, dtype=np.float64)
    blocks_t = np.array(st.blocks_t)
    offsets, nrb = st.offsets, blocks_t.shape[-1]
    halo = max(abs(o) for o in offsets)
    inv_f = np.array(build_device_block_jacobi_flat(jnp.asarray(blocks_t), offsets,
                                                    mbn=mbn))
    nb, mb = inv_f.shape[:2]
    y5 = jtwo.geometric_rbm_modes((7, 7, 6), br, nrb, mbn,
                                  scale_d=pad_to_padded(lay, d), q=6)
    ac = jtwo.coarse_matrix_host(a_pad, y5, br)
    ac += 1e-10 * np.trace(ac) / ac.shape[0] * np.eye(ac.shape[0])
    ac_inv = coarse_inverse_host(ac)
    yq3 = np.ascontiguousarray(y5.transpose(0, 3, 1, 2).reshape(nb, -1, mb))

    blocks_j = jnp.asarray(blocks_t)
    op_j = [jnp.asarray(v) for v in (inv_f, yq3, ac_inv)]

    def a_j(x):
        x_ext = jnp.concatenate([x[:, :, nrb - halo:], x, x[:, :, :halo]], axis=2)
        return stencil_scan_accumulate(blocks_j, offsets, x_ext, halo)

    def m_j(z):
        return jtwo.bj2l_apply(*op_j, z)

    ops_t = StencilOperands(
        blocks_flat=torch.from_numpy(blocks_t.reshape(-1, nrb).copy()),
        offsets=offsets, br=br, inv_f=torch.from_numpy(inv_f),
        yq3=torch.from_numpy(yq3), ac_inv=torch.from_numpy(ac_inv))
    rng = np.random.default_rng(11)
    b = rng.standard_normal((br, nrb))
    b[:, lay.n // br:] = 0.0                # padded rows carry no rhs
    return dict(a_j=a_j, m_j=m_j, ops_t=ops_t, b=b, n_pad=lay.n_pad, br=br,
                nrb=nrb)


def _assign(sys_, t):
    return sys_["ops_t"].split_assign(t, sys_["n_pad"])


def _opts(**kw):
    base = dict(t=4, tol=1e-9, maxiter=600, variant="odir_fused", layout="tbn")
    base.update(kw)
    return jecg.ECGOptions(**base), tecg.ECGOptions(**base)


def _to_port_state(sj):
    return tecg.ECGState(
        w=torch.from_numpy(np.array(sj.x_blk)), panel_shape=tuple(sj.p.shape[1:]),
        mask=torch.from_numpy(np.array(sj.mask)), it=int(sj.it),
        res=torch.tensor(float(sj.res), dtype=torch.float64),
        breakdown=torch.tensor(bool(sj.breakdown)),
        history=torch.from_numpy(np.array(sj.history)),
        best_res=torch.tensor(float(sj.best_res), dtype=torch.float64),
        stall=torch.tensor(int(sj.stall), dtype=torch.int32))


def _init_both(sys_, oj, ot, b):
    assign = _assign(sys_, ot.t)
    sj, nj = jecg.ecg_init(sys_["a_j"], sys_["m_j"], jnp.asarray(b), oj,
                           split_assign=jnp.asarray(assign.numpy()))
    ops = sys_["ops_t"]
    st, nt = tecg.ecg_init(ops.a_apply, ops.m_apply, torch.from_numpy(b), ot,
                           split_assign=assign)
    return sj, nj, st, nt


def test_init_matches(system):
    oj, ot = _opts()
    sj, nj, st, nt = _init_both(system, oj, ot, system["b"])
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-14)
    w_j = np.asarray(sj.x_blk)
    np.testing.assert_allclose(st.w.numpy(), w_j, rtol=1e-11,
                               atol=1e-11 * np.abs(w_j).max())
    assert st.panel_shape == tuple(sj.p.shape[1:])


def test_init_moves_zero_columns_stably(system):
    """A rhs supported on part of the domain leaves split columns empty:
    they move behind the active prefix in stable order on both sides."""
    b = system["b"].copy()
    b[:, : system["nrb"] // 2] = 0.0        # columns 0 and 1 of t=4 empty
    oj, ot = _opts()
    sj, _, st, _ = _init_both(system, oj, ot, b)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    assert st.mask.tolist() == [1.0, 1.0, 0.0, 0.0]
    np.testing.assert_allclose(st.w.numpy(), np.asarray(sj.x_blk), rtol=1e-11,
                               atol=1e-11 * np.abs(np.asarray(sj.x_blk)).max())


@pytest.mark.parametrize("adaptive", [False, True])
def test_one_stacked_step_matches(system, adaptive):
    oj, ot = _opts(adaptive=adaptive)
    sj, nj, _, _ = _init_both(system, oj, ot, system["b"])
    # a few reference steps first, so the step starts from a generic state
    red_tol = (oj.tol * nj / jnp.sqrt(jnp.asarray(4.0))).astype(nj.dtype)
    for _ in range(3):
        sj = jecg._iter_odir_fused_stacked(sj, system["a_j"], system["m_j"], None,
                                           oj, nj, red_tol, JTBN)
    st = _to_port_state(sj)
    ops = system["ops_t"]
    nt = torch.tensor(float(nj), dtype=torch.float64)
    st1 = tecg._iter_odir_fused_stacked(st, ops.a_apply, ops.m_apply, ot, nt,
                                        torch.tensor(float(red_tol), dtype=torch.float64))
    sj1 = jecg._iter_odir_fused_stacked(sj, system["a_j"], system["m_j"], None,
                                        oj, nj, red_tol, JTBN)
    w_j = np.asarray(sj1.x_blk)
    np.testing.assert_allclose(st1.w.numpy(), w_j, rtol=1e-10,
                               atol=1e-10 * np.abs(w_j).max())
    np.testing.assert_allclose(float(st1.res), float(sj1.res), rtol=1e-12)
    np.testing.assert_array_equal(st1.mask.numpy(), np.asarray(sj1.mask))
    assert st1.it == int(sj1.it) == 4
    assert float(st1.history[3]) == pytest.approx(float(sj1.history[3]), rel=1e-12)
    assert not bool(st1.breakdown)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(t=8, tol=1e-8),
    dict(adaptive=True),
    dict(adaptive=True, adaptive_mode="freeze"),
])
def test_solve_matches(system, kw):
    oj, ot = _opts(**kw)
    assign = _assign(system, ot.t)
    b = system["b"]
    rj = jecg.ecg_solve(system["a_j"], system["m_j"], jnp.asarray(b), oj,
                        split_assign=jnp.asarray(assign.numpy()))
    ops = system["ops_t"]
    rt = tecg.ecg_solve(ops.a_apply, ops.m_apply, torch.from_numpy(b), ot,
                        split_assign=assign)
    it_j, it_t = int(rj.iters), rt.iters
    assert abs(it_t - it_j) <= 1, (it_t, it_j)
    assert not rt.breakdown and not bool(rj.breakdown)
    assert rt.bs == int(rj.bs)
    k = min(it_t, it_j)
    h_j = np.asarray(rj.history)[:k]
    np.testing.assert_allclose(rt.history.numpy()[:k], h_j, rtol=1e-6)
    assert rt.history.numpy()[it_t:].tolist() == [-1.0] * (ot.maxiter - it_t)
    x_j = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - x_j) <= 1e-8 * np.linalg.norm(x_j)
    # and it solved the system
    r = b - ops.a_apply(rt.x[None])[0].numpy()
    assert np.linalg.norm(r) <= 10 * ot.tol * np.linalg.norm(b)


def test_stall_window_stops_like_jax(system):
    """The stall stop rule (refinement inner solves rely on it)."""
    oj, ot = _opts(tol=1e-9, stall_window=3, stall_rtol=0.5)
    assign = _assign(system, 4)
    ops = system["ops_t"]
    b = torch.from_numpy(system["b"])
    rt = tecg.ecg_solve(ops.a_apply, ops.m_apply, b, ot, split_assign=assign)
    rj = jecg.ecg_solve(system["a_j"], system["m_j"], jnp.asarray(b.numpy()), oj,
                        split_assign=jnp.asarray(assign.numpy()))
    assert rt.iters == int(rj.iters) < 600     # stopped by the stall window
    assert float(rt.res) > ot.tol * float(rt.normb)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(rj.x)).max())


@pytest.mark.parametrize("op", ["gram", "update", "downdate", "rotate",
                                "scale_dirs", "sum_dirs", "split", "take_dirs",
                                "zeros_like_panel"])
def test_tbn_panel_ops_match(op):
    rng = np.random.default_rng(5)
    p, x = rng.standard_normal((2, 4, 3, 10))
    coef = rng.standard_normal((4, 4))
    mask = np.array([1.0, 1.0, 0.0, 1.0])
    b = rng.standard_normal((3, 10))
    assign = rng.integers(0, 4, (3, 10))
    idx = np.array([2, 0, 3, 1])
    args = {"gram": (p, x), "update": (x, p, coef), "downdate": (x, p, coef),
            "rotate": (p, coef), "scale_dirs": (p, mask), "sum_dirs": (p,),
            "split": (b, 4, assign), "take_dirs": (p, idx),
            "zeros_like_panel": (b, 4)}[op]
    got = getattr(TTBN, op)(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                              else a for a in args))
    want = getattr(JTBN, op)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("kw", [dict(variant="omin", stacked=True),
                                dict(variant="omin", stacked=True, adaptive=True),
                                dict(x0=True)])
def test_unported_variants_raise(system, kw):
    """The cases of the former refusal test, now held to the JAX package:
    the stacked omin state (with and without the BF-Omin rank test) and
    the x0 warm start. Equal iteration counts (±1) and x within 1e-8
    relative; the warm start solves the shifted system, whose rhs is the
    initial residual."""
    kw = dict(kw)
    warm = kw.pop("x0", False)
    oj, ot = _opts(tol=1e-8, **kw)
    assign = _assign(system, ot.t)
    ops = system["ops_t"]
    b = system["b"]
    x0 = None
    if warm:
        cold = tecg.ecg_solve(ops.a_apply, ops.m_apply, torch.from_numpy(b),
                              replace(ot, tol=1e-10), split_assign=assign)
        x0 = 0.5 * cold.x.numpy()
    rj = jecg.ecg_solve(system["a_j"], system["m_j"], jnp.asarray(b), oj,
                        split_assign=jnp.asarray(assign.numpy()),
                        x0=None if x0 is None else jnp.asarray(x0))
    rt = tecg.ecg_solve(ops.a_apply, ops.m_apply, torch.from_numpy(b), ot,
                        split_assign=assign,
                        x0=None if x0 is None else torch.from_numpy(x0))
    assert abs(rt.iters - int(rj.iters)) <= 1, (rt.iters, int(rj.iters))
    assert not rt.breakdown and rt.bs == int(rj.bs)
    x_j = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - x_j) <= 1e-8 * np.linalg.norm(x_j)
    if warm:
        np.testing.assert_allclose(float(rt.normb), float(rj.normb), rtol=1e-12)
        assert float(rt.normb) < 0.6 * np.linalg.norm(b)
    r = b - ops.a_apply(rt.x[None])[0].numpy()
    assert np.linalg.norm(r) <= 10 * ot.tol * np.linalg.norm(b)


@pytest.mark.parametrize("adaptive", [False, True])
def test_one_stacked_omin_step_matches(system, adaptive):
    """One stacked omin step from the same (5t, N) state as the JAX one."""
    oj, ot = _opts(variant="omin", stacked=True, adaptive=adaptive)
    sj, nj, st0, _ = _init_both(system, oj, ot, system["b"])
    np.testing.assert_allclose(st0.w.numpy(), np.asarray(sj.x_blk), rtol=1e-11,
                               atol=1e-11 * np.abs(np.asarray(sj.x_blk)).max())
    red_tol = (oj.tol * nj / jnp.sqrt(jnp.asarray(4.0))).astype(nj.dtype)
    for _ in range(3):
        sj = jecg._iter_omin_stacked(sj, system["a_j"], system["m_j"], None, oj,
                                     nj, red_tol, JTBN)
    st = _to_port_state(sj)
    assert st.w.shape[0] == 5 * 4
    ops = system["ops_t"]
    st1 = tecg._iter_omin_stacked(st, ops.a_apply, ops.m_apply, ot,
                                  torch.tensor(float(nj), dtype=torch.float64),
                                  torch.tensor(float(red_tol), dtype=torch.float64))
    sj1 = jecg._iter_omin_stacked(sj, system["a_j"], system["m_j"], None, oj, nj,
                                  red_tol, JTBN)
    w_j = np.asarray(sj1.x_blk)
    np.testing.assert_allclose(st1.w.numpy(), w_j, rtol=1e-10,
                               atol=1e-10 * np.abs(w_j).max())
    np.testing.assert_allclose(float(st1.res), float(sj1.res), rtol=1e-12)
    np.testing.assert_array_equal(st1.mask.numpy(), np.asarray(sj1.mask))
    assert st1.it == int(sj1.it) == 4


@pytest.mark.parametrize("adaptive", [False, True])
def test_split_stacked_step_matches_jax(system, adaptive):
    """The stacked step's three parts called in turn, as the CUDA-graph
    runner calls them: (a) the Gram, (b) the t×t algebra with the next stop
    flag, (c) the panel work; against JAX's step from the same state."""
    oj, ot = _opts(adaptive=adaptive)
    sj, nj, _, _ = _init_both(system, oj, ot, system["b"])
    red_tol = (oj.tol * nj / jnp.sqrt(jnp.asarray(4.0))).astype(nj.dtype)
    for _ in range(3):
        sj = jecg._iter_odir_fused_stacked(sj, system["a_j"], system["m_j"], None,
                                           oj, nj, red_tol, JTBN)
    st = _to_port_state(sj)
    ops = system["ops_t"]
    tol_abs = torch.tensor(oj.tol * float(nj), dtype=torch.float64)
    alg = tecg._step_algebra(tecg._gram(st.w), st.mask, st.best_res, st.stall,
                             st.breakdown, torch.tensor(float(red_tol), dtype=torch.float64),
                             ot, tol_abs)
    w = tecg._panel_update(st.w, alg.c, ops.a_apply, ops.m_apply, st.panel_shape)
    sj1 = jecg._iter_odir_fused_stacked(sj, system["a_j"], system["m_j"], None,
                                        oj, nj, red_tol, JTBN)
    w_j = np.asarray(sj1.x_blk)
    np.testing.assert_allclose(w.numpy(), w_j, rtol=1e-10, atol=1e-10 * np.abs(w_j).max())
    np.testing.assert_allclose(float(alg.res), float(sj1.res), rtol=1e-12)
    np.testing.assert_array_equal(alg.mask.numpy(), np.asarray(sj1.mask))
    assert bool(alg.breakdown) == bool(sj1.breakdown)
    assert int(alg.stall) == int(sj1.stall)
    np.testing.assert_allclose(float(alg.best_res), float(sj1.best_res), rtol=1e-12)
    go_on = (float(sj1.res) > oj.tol * float(nj)) and float(np.sum(sj1.mask)) > 0 \
        and not bool(sj1.breakdown)
    assert bool(alg.ok) == go_on


@pytest.mark.parametrize("variant", ["odir_fused", "omin"])
def test_ecg_run_max_steps_matches_jax(system, variant):
    """ecg_run(max_steps=5) stops after 5 more iterations like the JAX
    loop, and resuming in chunks of 5 ends where one run ends."""
    oj, ot = _opts(variant=variant)
    sj, nj, st, nt = _init_both(system, oj, ot, system["b"])
    ops = system["ops_t"]
    sj5 = jecg.ecg_run(system["a_j"], system["m_j"], sj, nj, oj, max_steps=5)
    st5 = tecg.ecg_run(ops.a_apply, ops.m_apply, st, nt, ot, max_steps=5)
    assert st5.it == int(sj5.it) == 5
    np.testing.assert_allclose(float(st5.res), float(sj5.res), rtol=1e-10)
    x_j = np.asarray(jecg.ecg_finalize(sj5, nj, "tbn").x)
    x_t = tecg.ecg_finalize(st5, nt, "tbn").x.numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-10, atol=1e-10 * np.abs(x_j).max())
    chunked = st5
    while True:
        nxt = tecg.ecg_run(ops.a_apply, ops.m_apply, chunked, nt, ot, max_steps=5)
        if nxt.it == chunked.it:
            break
        assert nxt.it - chunked.it <= 5
        chunked = nxt
    whole = tecg.ecg_run(ops.a_apply, ops.m_apply, st, nt, ot)
    assert chunked.it == whole.it < ot.maxiter
    np.testing.assert_array_equal(tecg.ecg_finalize(chunked, nt, "tbn").x.numpy(),
                                  tecg.ecg_finalize(whole, nt, "tbn").x.numpy())
