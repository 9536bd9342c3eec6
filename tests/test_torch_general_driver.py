"""The general-sparse path as a whole: DistributedECG in both packages.

elasticity3d(6,6,6) (homogeneous), ``precond="bj"`` with 96-row host
blocks, ECG t = 4 odir_fused on row-major panels, for the three formats of
the path.

* f64 on the CPU: the port's build and solve match the JAX driver's —
  iteration counts ±1, x within 1e-8 relative. ``fmt="block_ell"`` is held
  against the JAX driver's ``fmt="block_ell_xla"``: the JAX Pallas kernel
  accumulates in f32 whatever the input type (prealps_tpu/ops/spmm.py:83),
  so its f64 solve is not an f64 reference; the port's CPU route (the plain
  version) and the XLA formulation compute the same f64 product.
* ``solver_from_reference``: the port solving on the JAX build's own
  operands reproduces the JAX f64 residual history to 1e-8.
* f32 ``ell``: device double-float refinement; both converge, refinement
  rounds within ±1 of the JAX driver's. f32 ``block_ell``: no double-float
  product, so the rounds take host f64 residuals, as in the JAX driver.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import pad_to_padded
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.interop import solver_from_reference
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

BUILD = dict(nshards=1, precond="bj", block_size=96)
JAX_FMT = {"ell": "ell", "block_ell_xla": "block_ell_xla", "block_ell": "block_ell_xla"}


def _opts(cls, tol):
    return cls(t=4, tol=tol, maxiter=2000, variant="odir_fused", layout="nt")


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    return a, b


@pytest.fixture(scope="module")
def jax_f64(problem):
    """The JAX driver's f64 builds and solves, one per JAX format."""
    a, b = problem
    out = {}
    for fmt in ("ell", "block_ell_xla"):
        s = JaxECG.build(a, fmt=fmt, opts=_opts(JaxOptions, 1e-8),
                         dtype=np.float64, **BUILD)
        out[fmt] = (s,) + s.solve(b)
    return out


@pytest.mark.parametrize("fmt", ["ell", "block_ell_xla", "block_ell"])
def test_f64_solve_matches(problem, jax_f64, fmt):
    a, b = problem
    _, x_j, info_j = jax_f64[JAX_FMT[fmt]]
    s = DistributedECG.build(a, fmt=fmt, opts=_opts(ECGOptions, 1e-8),
                             dtype=np.float64, device="cpu", **BUILD)
    assert set(s.timings) == {"layout", "fmt_convert", "precond"}
    assert s.operands.layout == "nt" and s.operands.bj.mode == "cholesky"
    assert s.layout.n_pad % (128 if fmt != "ell" else 8) == 0
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert not info["breakdown"]
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    assert _relres(a, x, b) < 1e-7


def _reference_arrays(sj, fmt):
    mat, (factors, gather_idx, inv_perm) = sj._operands
    lay = sj.layout
    arrays = dict(scale_d=sj.scale_d, perm=lay.perm, inv_perm=lay.inv_perm,
                  layout_offsets=lay.offsets, a_scaled=sj.a_scaled,
                  bj_factors=np.asarray(factors), bj_gather_idx=np.asarray(gather_idx),
                  bj_inv_perm=np.asarray(inv_perm))
    meta = dict(fmt=fmt, n=lay.n, n_pad=lay.n_pad, rows_per_shard=lay.rows_per_shard,
                opts=dataclasses.asdict(sj.opts), target_tol=sj.target_tol,
                bj_mode="cholesky", ncols_pad=lay.n_pad)
    key = ("ell_vals", "ell_cols") if fmt == "ell" else ("bell_blocks", "bell_blkcols")
    arrays.update(zip(key, (np.asarray(m) for m in mat)))
    return arrays, meta


@pytest.mark.parametrize("fmt", ["ell", "block_ell_xla", "block_ell"])
def test_solver_from_reference_reproduces_jax_history(problem, jax_f64, fmt):
    a, b = problem
    sj, x_j, info_j = jax_f64[JAX_FMT[fmt]]
    s = solver_from_reference(*_reference_arrays(sj, fmt), device="cpu")
    x, info = s.solve(b)
    n = info_j["iters"]
    assert info["iters"] == n
    # the JAX driver's info["history"] went through its f32 packed fetch:
    # take the f64 history from its solve function directly
    b_pad = pad_to_padded(sj.layout, sj.scale_d * b)
    res_j = sj._solve_fn(jnp.asarray(b_pad), *sj._operands)
    hist_j = np.asarray(res_j.history)
    assert hist_j.dtype == np.float64 and int(res_j.iters) == n
    np.testing.assert_allclose(info["history"][:n], hist_j[:n], rtol=1e-8,
                               atol=1e-14 * hist_j[0])
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def test_f32_ell_refines_like_jax(problem):
    a, b = problem
    tol = 1e-6
    sj = JaxECG.build(a, fmt="ell", opts=_opts(JaxOptions, tol),
                      dtype=np.float32, **BUILD)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, fmt="ell", opts=_opts(ECGOptions, tol),
                             dtype=np.float32, device="cpu", **BUILD)
    assert s.operands.df_ok and s.operands.bj.mode == "inverse"
    x, info = s.solve(b)
    assert _relres(a, x, b) < tol and _relres(a, x_j, b) < tol
    assert not info["breakdown"]
    assert info["device_rounds"] >= 2            # device double-float rounds
    assert abs(info["refine_rounds"] - info_j["refine_rounds"]) <= 1


def test_f32_block_ell_refines_on_the_host(problem):
    a, b = problem
    s = DistributedECG.build(a, fmt="block_ell", opts=_opts(ECGOptions, 1e-6),
                             dtype=np.float32, device="cpu", **BUILD)
    assert not s.operands.df_ok and s.operands.kernel
    x, info = s.solve(b)
    assert _relres(a, x, b) < 1e-6 and not info["breakdown"]
    assert info["device_rounds"] == 0 and info["refine_rounds"] >= 2


def test_defaults_are_the_jax_drivers(problem):
    """DistributedECG.build(a) means fmt="ell", precond="block_jacobi" and
    ECGOptions(layout="nt") in both packages (one block-Jacobi block)."""
    a, b = problem
    opts = dict(t=4, tol=1e-8, maxiter=2000)
    x_j, info_j = JaxECG.build(a, nshards=1, opts=JaxOptions(**opts),
                               dtype=np.float64).solve(b)
    s = DistributedECG.build(a, opts=ECGOptions(**opts), dtype=np.float64,
                             device="cpu")
    assert s.operands.bj.factors.shape[0] == 1
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
