"""The port's f32 LORASC solve with double-float refinement against the JAX
package's.

Heterogeneous elasticity3d(8³), 8 box parts, balancing ("deflate")
correction, ECG t = 12 omin, tol 1e-5 in f32: below ``inner_tol`` = 1e-3,
so both drivers refine. f32 Lanczos is not reproducible across
implementations, so the two builds are held loosely: deflated pairs within
±2, and the port's solve reaches the tolerance by a host f64 residual with
total iterations within 10 % of the JAX solve's (28 iterations in two
rounds on this CPU). Also: ``with_tol(1e-8)`` on the same build reaches
1e-8; the host-round fallback (``solve(host_rounds=True)``) reaches the
tolerance; the device finish's double-float residual, with the A_lo·x_hi
rounding correction through B2b's plain route, equals the host f64
residual; and ``refine_solve`` is the JAX function's numpy copy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.lorasc_stencil import StencilLorascECG as JaxLorasc
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu.solvers.refine import refine_solve as j_refine_solve
from prealps_tpu_torch.ops import spmm as tspmm
from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
from prealps_tpu_torch.solvers.ecg import ECGOptions
from prealps_tpu_torch.solvers.refine import refine_solve

torch.set_num_threads(1)

NEL = 8
TOL = 1e-5
BUILD = dict(nparts=8, br=3, grid=(NEL + 1, NEL + 1, NEL), max_deflation=64,
             correction="deflate", pencil="agg", inner_tol=1e-3, dtype=np.float32)


def _opts(cls):
    return cls(t=12, tol=TOL, maxiter=1000, variant="omin", layout="tbn")


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(NEL, NEL, NEL, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    return a, b


@pytest.fixture(scope="module")
def jax_run(problem):
    a, b = problem
    x, info = JaxLorasc.build(a, opts=_opts(JaxOptions), **BUILD).solve(b)
    return x, info


@pytest.fixture(scope="module")
def port(problem):
    a, _ = problem
    return StencilLorascECG.build(a, opts=_opts(ECGOptions), device="cpu", **BUILD)


def test_refined_solve_matches_jax(problem, jax_run, port):
    a, b = problem
    _, info_j = jax_run
    assert _relres(a, jax_run[0], b) < TOL
    b2b = tspmm.stencil_pallas_bs_ext.launches
    x, info = port.solve(b)
    assert tspmm.stencil_pallas_bs_ext.launches == b2b      # plain route on the CPU
    assert _relres(a, x, b) < TOL and not info["breakdown"]
    assert info["refine_rounds"] >= 2 and info["device_rounds"] == info["refine_rounds"]
    assert abs(info["iters"] - info_j["iters"]) <= 0.1 * info_j["iters"], (
        info["iters"], info_j["iters"])
    assert abs(port.precond.deflated - info_j["deflated"]) <= 2
    assert "a_lo_blocks" in port.precond.operands


def test_with_tol_reaches_1e8(problem, port):
    a, b = problem
    deep = port.with_tol(1e-8)
    assert deep.precond is port.precond and deep.target_tol == 1e-8
    x, info = deep.solve(b)
    assert _relres(a, x, b) < 1e-8 and not info["breakdown"]


def test_host_rounds_reach_tol(problem, port):
    a, b = problem
    x, info = port.solve(b, host_rounds=True)
    assert _relres(a, x, b) < TOL
    assert info["device_rounds"] == 0 and info["refine_rounds"] >= 2


def test_polish_after_device_shortfall(problem, port, monkeypatch):
    """Device rounds that stop short of the tolerance (here: one round, to
    inner_tol only) are polished by host-f64 rounds from their result."""
    a, b = problem
    device = port._solve_refined_device
    monkeypatch.setattr(port, "_solve_refined_device",
                        lambda b_eff, _rounds: device(b_eff, 1))
    x, info = port.solve(b)
    assert _relres(a, x, b) < TOL and not info["breakdown"]
    assert info["device_rounds"] == 1 and info["refine_rounds"] >= 2
    assert info["relres_scaled"] < TOL


def test_finish_residual_matches_host_f64(problem, port):
    """One ECG round, then the device finish: its double-float residual
    (A·x_hi in double-float, A·x_lo and A_lo·x_hi in f32) equals the host
    f64 residual of x_hi + x_lo far below the f32 rounding of A."""
    _, b = problem
    b_eff = port.scale_d * b
    b_lane = np.ascontiguousarray(b_eff.reshape(port.nrb, port.br).T)
    b_hi = b_lane.astype(np.float32)
    b2 = torch.from_numpy(np.stack([b_hi, (b_lane - b_hi).astype(np.float32)]))
    res = port._ecg(b2[0])
    x2, r2, rnorm = port._finish(res, torch.zeros_like(b2), b2)
    x = (x2[0].double() + x2[1].double()).T.reshape(-1).numpy()
    r_true = b_eff - port.a_scaled @ x
    r_df = (r2[0].double() + r2[1].double()).T.reshape(-1).numpy()
    err = np.linalg.norm(r_df - r_true)
    assert err < 1e-3 * np.linalg.norm(r_true)
    assert err < 1e-9 * np.linalg.norm(b_eff)
    assert float(rnorm) == pytest.approx(np.linalg.norm(r2[0].double().numpy()),
                                         rel=1e-6)


def test_sigma_build_refines_pairs_in_f64():
    """The build defaults (σ correction): in f32 the kept pairs go through
    the f64 refinement on the device (stage ``pair_refine``) and become the
    σ operands. (The f32 σ solve itself breaks down with omin on this
    operator in both packages, which is why the record runs the balancing
    correction; ROADMAP C.)"""
    a = elasticity3d(6, 6, 6, heterogeneous=True)
    kw = dict(BUILD, grid=(7, 7, 6))
    kw.pop("correction")
    s = StencilLorascECG.build(a, opts=_opts(ECGOptions), device="cpu", **kw)
    pc = s.precond
    assert "pair_refine" in pc.timings and pc.deflated > 0
    assert "w_lift" not in pc.operands
    sigma, e_mat = pc.operands["sigma"], pc.operands["e_mat"]
    assert sigma.dtype == e_mat.dtype == torch.float32
    assert sigma.shape == (pc.deflated,) and bool((sigma > 0).all())
    assert e_mat.shape == (pc.plan.ng_pad, pc.deflated)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (12, 3, pc.plan.nrb)).astype(np.float32))
    assert bool(torch.isfinite(pc.apply(r)).all())


def test_refine_solve_matches_jax():
    """The numpy copy against the original on a small SPD system with an
    f32 inner solver: the same iterate, rounds and residual."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((40, 40))
    a = sp.csr_matrix(m @ m.T + 40 * np.eye(40))
    b = rng.standard_normal(40)
    a32 = a.toarray().astype(np.float32)

    def inner(r):
        return (np.linalg.solve(a32, r.astype(np.float32)).astype(np.float64),
                {"iters": 3, "breakdown": False})

    x_t, info_t = refine_solve(a, b, inner, 1e-12)
    x_j, info_j = j_refine_solve(a, b, inner, 1e-12)
    np.testing.assert_array_equal(x_t, x_j)
    assert info_t == info_j and info_t["refine_rounds"] >= 2
    assert info_t["relres_scaled"] < 1e-12
    assert float(jnp.asarray(info_t["res"])) == info_t["res"]
