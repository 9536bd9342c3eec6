"""The port's single-device API (prealps_tpu_torch/api.py), its subdomain
solvers, preconditioner factory, scipy adapters and checkpoints, against
the JAX package on the CPU.

* ``ECGSolver`` with block Jacobi and with no preconditioner: iterations
  within ±1 and x within 1e-8 of JAX's in f64; in f32 the refinement
  rounds of both, held to the target; on JAX's fields
  (``ecg_solver_from_reference``) the same; the info keys are JAX's.
* ``make_preconditioner`` and ``Identity`` (tests/test_interop.py's
  factory names) against JAX's.
* ``direct/subdomain.py``: ``build_block_solver`` and ``DenseCholesky``
  factors bitwise JAX's in f32 and f64, their applies within 1e-12.
* ``interop``: ``as_scipy_linear_operator``, ``precond_as_scipy`` in
  scipy's CG, ``ecg_vs_scipy_cg`` (tests/test_interop.py).
* ``solvers/checkpoint.py``: a chunked solve equals the straight one,
  and a solve resumed from a snapshot written at iteration 30 equals the
  straight one and reaches JAX's count ±1 (tests/test_ecg.py:154-211);
  stacked and unstacked states round-trip (tests/test_ecg.py:286-300).
* ``ECGSolver.build(device="cuda")`` without a card raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from api_reference import jax_build, rel
from prealps_tpu.api import ECGSolver as JaxSolver
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.direct import subdomain as jsub
from prealps_tpu.ops.formats import csr_to_ell as j_csr_to_ell
from prealps_tpu.ops.spmm import ell_spmm as j_ell_spmm
from prealps_tpu.precond import api as japi
from prealps_tpu.solvers.checkpoint import ecg_solve_checkpointed as j_ckpt
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.api import ECGSolver
from prealps_tpu_torch.core.partition import nsplit
from prealps_tpu_torch.direct import subdomain as tsub
from prealps_tpu_torch.interop import (
    as_scipy_linear_operator,
    ecg_solver_from_reference,
    ecg_vs_scipy_cg,
    precond_as_scipy,
)
from prealps_tpu_torch.ops.formats import csr_to_ell, csr_to_stencil_bsr_t
from prealps_tpu_torch.ops.spmm import ell_spmm, stencil_bsr_spmm_t
from prealps_tpu_torch.precond import api as tapi
from prealps_tpu_torch.solvers.checkpoint import (
    ecg_solve_checkpointed,
    load_state,
    save_state,
)
from prealps_tpu_torch.solvers.ecg import (
    ECGOptions,
    ECGState,
    ecg_finalize,
    ecg_init,
    ecg_run,
    ecg_solve,
)

torch.set_num_threads(1)

OPTS = dict(t=4, tol=1e-8, maxiter=3000)
INFO_KEYS = {"iters", "res", "normb", "bs", "breakdown", "history"}


@pytest.mark.parametrize("precond,kw", [("block_jacobi", dict(nblocks=8)),
                                        ("none", {})])
def test_solver_matches_jax(ela_small, rng, precond, kw):
    b = rng.standard_normal(ela_small.shape[0])
    x, info = ECGSolver.build(ela_small, opts=ECGOptions(**OPTS), precond=precond,
                              device="cpu", **kw).solve(b)
    x_j, info_j = JaxSolver.build(ela_small, opts=JaxOptions(**OPTS), precond=precond,
                                  **kw).solve(b)
    assert set(info) == set(info_j) == INFO_KEYS
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert rel(x, x_j) < 1e-8
    h = info["history"]
    assert len(h[h >= 0]) == info["iters"]


def test_solver_f32_refines(ela_small, rng):
    b = rng.standard_normal(ela_small.shape[0])
    kw = dict(precond="block_jacobi", nblocks=8, dtype=np.float32)
    s = ECGSolver.build(ela_small, opts=ECGOptions(**OPTS), device="cpu", **kw)
    x, info = s.solve(b)
    x_j, info_j = JaxSolver.build(ela_small, opts=JaxOptions(**OPTS), **kw).solve(b)
    assert set(info) == set(info_j) == INFO_KEYS | {"refine_rounds"}
    assert s.opts.tol == 1e-3 and s.opts.stall_window == 250
    assert info["refine_rounds"] >= 2 and info_j["refine_rounds"] >= 2
    print(f"f32 block Jacobi: port {info['iters']} iterations in "
          f"{info['refine_rounds']} rounds, JAX {info_j['iters']} in "
          f"{info_j['refine_rounds']}")
    for xx in (x, x_j):
        assert np.linalg.norm(b - ela_small @ xx) / np.linalg.norm(b) < 1e-6


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solver_on_jax_fields(ela_small, rng, dtype):
    fields, meta, _ = jax_build(ela_small, JaxOptions(**OPTS), "block_jacobi",
                                dtype=dtype, nblocks=8)
    b = rng.standard_normal(ela_small.shape[0])
    s = ecg_solver_from_reference(fields, meta, device="cpu")
    assert s.precond.factors.dtype == getattr(torch, np.dtype(dtype).name)
    x, info = s.solve(b)
    x_j, info_j = JaxSolver.build(ela_small, opts=JaxOptions(**OPTS), dtype=dtype,
                                  precond="block_jacobi", nblocks=8).solve(b)
    if dtype == np.float64:
        assert abs(info["iters"] - info_j["iters"]) <= 1
        assert rel(x, x_j) < 1e-8
    else:
        assert info["refine_rounds"] >= 2
        assert np.linalg.norm(b - ela_small @ x) / np.linalg.norm(b) < 1e-6


def test_make_preconditioner_and_identity(ela_small, rng):
    a, _ = sym_rac_scaling(ela_small)
    v = rng.standard_normal((a.shape[0], 2))
    ident = tapi.make_preconditioner("none", a, device="cpu")
    assert isinstance(ident, tapi.Identity) and isinstance(ident, tapi.Preconditioner)
    assert isinstance(japi.make_preconditioner("noprec", a), japi.Identity)
    np.testing.assert_array_equal(ident.apply(torch.from_numpy(v)).numpy(), v)
    bj = tapi.make_preconditioner("bj", a, nblocks=4, device="cpu")
    bj_j = japi.make_preconditioner("bj", a, nblocks=4)
    assert rel(bj.apply(torch.from_numpy(v)).numpy(),
               np.asarray(bj_j.apply(jnp.asarray(v)))) < 1e-12
    lor, arrow = tapi.make_preconditioner("lorasc", a, nparts=4, device="cpu")
    lor_j, arrow_j = japi.make_preconditioner("lorasc", a, nparts=4)
    np.testing.assert_array_equal(arrow.perm, arrow_j.perm)
    vp = v[arrow.perm]
    assert rel(lor.apply(torch.from_numpy(vp)).numpy(),
               np.asarray(lor_j.apply(jnp.asarray(vp)))) < 1e-12
    assert isinstance(lor, tapi.Preconditioner)
    for make in (tapi.make_preconditioner, japi.make_preconditioner):
        with pytest.raises(ValueError, match="unknown preconditioner"):
            make("ilu", a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_subdomain_solvers_bitwise(ela_small, rng, dtype):
    a, _ = sym_rac_scaling(ela_small)
    off = nsplit(a.shape[0], 5)
    blk = sp.block_diag([a[off[i]:off[i + 1], off[i]:off[i + 1]] for i in range(5)],
                        format="csr")
    s = tsub.build_block_solver(blk, off, dtype=dtype)
    s_j = jsub.build_block_solver(blk, off, dtype=dtype)
    np.testing.assert_array_equal(s.factors.numpy(), np.asarray(s_j.factors))
    np.testing.assert_array_equal(s.gather_idx.numpy(), np.asarray(s_j.gather_idx))
    np.testing.assert_array_equal(s.inv_perm.numpy(), np.asarray(s_j.inv_perm))
    assert s.mode == "cholesky" and s.factors.dtype == getattr(torch, np.dtype(dtype).name)
    v = rng.standard_normal((a.shape[0], 3)).astype(dtype)
    w = s.apply(torch.from_numpy(v)).numpy()
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert rel(w, np.asarray(s_j.apply(jnp.asarray(v)))) < tol
    if dtype == np.float64:       # a direct solver of the block diagonal
        assert rel(blk @ w, v) < 1e-10
    g = a[:40, :40]
    c, c_j = tsub.DenseCholesky.build(g, dtype=dtype), jsub.DenseCholesky.build(g, dtype=dtype)
    np.testing.assert_array_equal(c.factor.numpy(), np.asarray(c_j.factor))
    z = v[:40]
    assert rel(c.apply(torch.from_numpy(z)).numpy(), np.asarray(c_j.apply(jnp.asarray(z)))) < tol


def test_scipy_linear_operator(ela_small, rng):
    b = rng.standard_normal(ela_small.shape[0])
    op = as_scipy_linear_operator(ECGSolver.build(
        ela_small, opts=ECGOptions(t=4, tol=1e-8, maxiter=3000), device="cpu"))
    x = op @ b
    assert np.linalg.norm(b - ela_small @ x) / np.linalg.norm(b) < 1e-6


def test_precond_in_scipy_cg(ela_small, rng):
    from prealps_tpu_torch.precond.block_jacobi import build_block_jacobi

    a, _ = sym_rac_scaling(ela_small)
    b = rng.standard_normal(a.shape[0])
    m_op = precond_as_scipy(build_block_jacobi(a, nblocks=8).apply, a.shape[0],
                            device="cpu")
    it = {"n": 0, "plain": 0}
    x, info = spla.cg(a, b, rtol=1e-8, maxiter=5000, M=m_op,
                      callback=lambda _: it.__setitem__("n", it["n"] + 1))
    spla.cg(a, b, rtol=1e-8, maxiter=5000,
            callback=lambda _: it.__setitem__("plain", it["plain"] + 1))
    assert info == 0
    assert it["n"] < it["plain"]


def test_ecg_vs_scipy_cg(ela_small, rng):
    from prealps_tpu.interop import ecg_vs_scipy_cg as j_ecg_vs_cg

    b = rng.standard_normal(ela_small.shape[0])
    out = ecg_vs_scipy_cg(ela_small, b, tol=1e-6, t=4, device="cpu")
    out_j = j_ecg_vs_cg(ela_small, b, tol=1e-6, t=4)
    assert set(out) == set(out_j)
    assert out["cg_iters"] == out_j["cg_iters"]
    assert abs(out["ecg_iters"] - out_j["ecg_iters"]) <= 1
    assert out["ecg_relres"] < 1e-4 and out["ecg_iters"] < out["cg_iters"]


@pytest.fixture(scope="module")
def ela_operator(ela_small):
    """The RAC-scaled ela_small in ELL, its block Jacobi (8 blocks) and the
    same pair in the JAX package."""
    from prealps_tpu.precond.block_jacobi import build_block_jacobi as j_bj
    from prealps_tpu_torch.precond.block_jacobi import build_block_jacobi

    a, _ = sym_rac_scaling(ela_small)
    b = np.random.default_rng(42).standard_normal(a.shape[0])
    ae, ae_j = csr_to_ell(a), j_csr_to_ell(a)
    return (a, b, (lambda x: ell_spmm(ae, x)), build_block_jacobi(a, nblocks=8).apply,
            (lambda x: j_ell_spmm(ae_j, x)), j_bj(a, nblocks=8).apply)


def test_checkpoint_resume_matches_straight_solve(ela_operator, tmp_path):
    a, b, a_apply, m_apply = ela_operator[:4]
    opts = ECGOptions(t=4, tol=1e-6, maxiter=2000)
    path = str(tmp_path / "state.npz")
    res = ecg_solve(a_apply, m_apply, torch.from_numpy(b), opts)
    chunks = []
    res_ck = ecg_solve_checkpointed(a_apply, m_apply, torch.from_numpy(b), opts, path,
                                    every=25, on_chunk=lambda it, r: chunks.append(it))
    assert res_ck.iters == res.iters and len(chunks) >= 2
    np.testing.assert_array_equal(res_ck.x.numpy(), res.x.numpy())
    # resuming at the final snapshot exits at once with the same state
    again = ecg_solve_checkpointed(a_apply, m_apply, torch.from_numpy(b), opts, path,
                                   every=25)
    assert again.iters == res_ck.iters
    np.testing.assert_array_equal(again.x.numpy(), res.x.numpy())


def test_resume_from_partial_state_matches_jax(ela_operator, tmp_path):
    a, b, a_apply, m_apply, a_apply_j, m_apply_j = ela_operator
    opts = ECGOptions(t=4, tol=1e-6, maxiter=2000)
    path = str(tmp_path / "partial.npz")
    bt = torch.from_numpy(b)
    state, normb = ecg_init(a_apply, m_apply, bt, opts)
    state = ecg_run(a_apply, m_apply, state, normb, opts, max_steps=30)
    assert state.it == 30
    save_state(path, state, normb)
    state2, normb2 = load_state(path, device="cpu")
    assert state2.it == 30 and float(normb2) == float(normb)
    for f in ("x_blk", "r", "p", "mask", "history"):
        np.testing.assert_array_equal(getattr(state2, f).numpy(), getattr(state, f).numpy())
    res = ecg_solve_checkpointed(a_apply, m_apply, bt, opts, path, every=50)
    straight = ecg_solve(a_apply, m_apply, bt, opts)
    assert res.iters == straight.iters > 30
    np.testing.assert_array_equal(res.x.numpy(), straight.x.numpy())
    res_j = j_ckpt(a_apply_j, m_apply_j, jnp.asarray(b),
                   JaxOptions(t=4, tol=1e-6, maxiter=2000), str(tmp_path / "j.npz"), every=50)
    assert abs(res.iters - int(res_j.iters)) <= 1


def test_checkpoint_roundtrip_stacked(ela_operator, tmp_path):
    """A stacked state written after 5 iterations and read back runs the
    next 20 exactly as the state in memory does."""
    a, b = ela_operator[:2]
    st = csr_to_stencil_bsr_t(a, br=3)
    nrb = a.shape[0] // 3
    b_lane = torch.from_numpy(np.ascontiguousarray(b.reshape(nrb, 3).T))
    opts = ECGOptions(t=4, tol=1e-9, maxiter=4000, layout="tbn")
    a_op = lambda v: stencil_bsr_spmm_t(st, v)
    m_op = lambda v: v
    s0, normb = ecg_init(a_op, m_op, b_lane, opts)
    s1 = ecg_run(a_op, m_op, s0, normb, opts, max_steps=5)
    assert isinstance(s1, ECGState)
    path = str(tmp_path / "stacked.npz")
    save_state(path, s1, normb)
    s1b, normb_b = load_state(path, device="cpu")
    assert isinstance(s1b, ECGState) and s1b.panel_shape == s1.panel_shape
    r1 = ecg_finalize(ecg_run(a_op, m_op, s1, normb, opts, max_steps=20), normb, "tbn")
    r2 = ecg_finalize(ecg_run(a_op, m_op, s1b, normb_b, opts, max_steps=20), normb_b, "tbn")
    assert r1.iters == r2.iters == 25
    np.testing.assert_array_equal(r1.x.numpy(), r2.x.numpy())
    np.testing.assert_array_equal(r1.history.numpy(), r2.history.numpy())


def test_build_on_cuda_without_card_raises(ela_small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ECGSolver.build(ela_small, opts=ECGOptions(t=2))
