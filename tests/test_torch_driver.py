"""The slice as a whole: DistributedECG build + solve in both packages.

elasticity3d(8,8,8) (homogeneous, the headline operator's family), stencil
format, two-level block Jacobi with 24-row blocks, ECG t = 4 odir_fused on
lane-major panels — the headline path at a size the CPU runs in seconds.

* f64: equal iteration counts (±1) and x within 1e-8 relative.
* f32 with tol 1e-6 (double-float refinement on the device): both reach the
  tolerance by a host f64 residual, and the port's total iterations lie
  within ±25 % of the JAX package's. They are not held closer: XLA:CPU
  contracts the double-float transforms into FMAs, so the JAX refinement
  degrades on the CPU and finishes with host rounds, while eager PyTorch
  keeps them exact.
* ``solver_from_reference``: the port solving on the JAX build's own
  operands reproduces the JAX f64 residual history to 1e-8 relative (down
  to the f64 rounding floor, 1e-14·‖b‖).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import pad_to_padded, permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops.formats import csr_to_stencil_bsr
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.interop import solver_from_reference
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

BUILD = dict(fmt="stencil", br=3, precond="bj2l", block_size=24, grid=(9, 9, 8))


def _opts(cls, tol):
    return cls(t=4, tol=tol, maxiter=3000, variant="odir_fused", layout="tbn")


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(8, 8, 8, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    return a, b


@pytest.fixture(scope="module")
def jax_f64(problem):
    a, b = problem
    s = JaxECG.build(a, nshards=1, opts=_opts(JaxOptions, 1e-8),
                     dtype=np.float64, **BUILD)
    x, info = s.solve(b)
    return s, x, info


def test_f64_solve_matches(problem, jax_f64):
    a, b = problem
    _, x_j, info_j = jax_f64
    s = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions, 1e-8),
                             dtype=np.float64, device="cpu", **BUILD)
    assert s.operands.blocks_flat.dtype == torch.float64
    assert set(s.timings) == {"layout", "fmt_convert", "precond"}
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert not info["breakdown"]
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    assert _relres(a, x, b) < 1e-7


def test_f32_refined_solve_converges_like_jax(problem):
    a, b = problem
    tol = 1e-6
    sj = JaxECG.build(a, nshards=1, opts=_opts(JaxOptions, tol),
                      dtype=np.float32, **BUILD)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions, tol),
                             dtype=np.float32, device="cpu", **BUILD)
    assert s.a_scaled is not None          # refining past the f32 floor
    assert s.opts.tol == 1e-3 and s.opts.stall_window == 250
    assert s.operands.inv_f.dtype == torch.float32
    x, info = s.solve(b)
    assert _relres(a, x, b) < tol and _relres(a, x_j, b) < tol
    assert not info["breakdown"]
    assert info["refine_rounds"] >= 2          # really refined past f32
    assert abs(info["iters"] - info_j["iters"]) <= 0.25 * info_j["iters"]


def test_solver_from_reference_reproduces_jax_history(problem, jax_f64):
    a, b = problem
    sj, x_j, info_j = jax_f64
    (blocks_t,), (inv_f, yq3, ac_inv) = sj._operands
    lay = sj.layout
    offsets = csr_to_stencil_bsr(
        permute_and_pad_matrix(sym_rac_scaling(a)[0], lay), br=3).offsets
    arrays = dict(blocks=np.asarray(blocks_t), inv_f=np.asarray(inv_f),
                  yq3=np.asarray(yq3), ac_inv=np.asarray(ac_inv),
                  scale_d=sj.scale_d, perm=lay.perm, inv_perm=lay.inv_perm,
                  layout_offsets=lay.offsets, a_scaled=sj.a_scaled)
    meta = dict(stencil_offsets=offsets, br=3, n=lay.n, n_pad=lay.n_pad,
                rows_per_shard=lay.rows_per_shard,
                opts=dataclasses.asdict(sj.opts), target_tol=sj.target_tol)
    s = solver_from_reference(arrays, meta, device="cpu")
    x, info = s.solve(b)
    n = info_j["iters"]
    assert info["iters"] == n
    # the JAX driver's info["history"] went through its f32 packed fetch:
    # take the f64 history from its solve function directly
    b_pad = pad_to_padded(lay, sj.scale_d * b).reshape(-1, 3).T
    res_j = sj._solve_fn(jnp.asarray(b_pad), *sj._operands)
    hist_j = np.asarray(res_j.history)
    assert hist_j.dtype == np.float64 and int(res_j.iters) == n
    # relative 1e-8, down to the f64 floor of the recursively updated
    # residual (its rounding is absolute, ~eps·‖b‖ = eps·history[0])
    np.testing.assert_allclose(info["history"][:n], hist_j[:n], rtol=1e-8,
                               atol=1e-14 * hist_j[0])
    assert np.all(info["history"][n:] == -1.0)
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def _jax_kind(sj):
    """The JAX build's preconditioner kind, read off its operands."""
    ops = sj._operands[1]
    if ops is None:
        return None
    if len(ops) == 3:
        return "bj2l" if ops[1].ndim == 3 else "bj"
    (op,) = ops
    if op.dtype == jnp.bfloat16:
        return "bj_lane"
    return {5: "bj_dedup", 3: "bj_flat"}.get(op.ndim, "chebyshev")


@pytest.mark.parametrize("kw", [dict(fmt="dia", precond="bj", bj_dtype="bf16"),
                                dict(precond="block_jacobi"),
                                dict(nshards=2), dict(grid=None),
                                dict(nshards=4), dict(precond="chebyshev"),
                                dict(fmt="auto", precond="cheby"),
                                dict(precond="bj", bj_dedupe=False, bj_dtype="bf16")])
def test_unported_options_raise(problem, kw):
    """The cases of the former refusal test. Several shards need a process
    group of as many ranks (tests/test_torch_sharded_*.py run them), so
    without one they raise ValueError. The others build and
    solve as the JAX driver does: the same preconditioner kind (with
    grid=, precond="block_jacobi" dedupes the x-line blocks, on DIA too;
    without it bj2l takes translation modes; Chebyshev on the stencil and
    on what fmt="auto" detects) and equal iteration counts (±1) with x
    within 1e-8 relative in f64. The bf16 block Jacobi (bj_lane) runs in
    f32 with refinement to 1e-6, as its JAX test does: relres < 5e-5 and
    iterations within 25 % of the JAX driver's."""
    a, b = problem
    args = dict(BUILD, nshards=1)
    args.update(kw)
    if args["nshards"] != 1:
        with pytest.raises(ValueError, match="process group of"):
            DistributedECG.build(a, opts=_opts(ECGOptions, 1e-6), device="cpu",
                                 **args)
        return
    bf16 = args.get("bj_dtype") == "bf16"
    tol, dtype = (1e-6, np.float32) if bf16 else (1e-8, np.float64)
    sj = JaxECG.build(a, opts=_opts(JaxOptions, tol), dtype=dtype, **args)
    s = DistributedECG.build(a, opts=_opts(ECGOptions, tol), dtype=dtype,
                             device="cpu", **args)
    assert s.operands.precond_kind == _jax_kind(sj) is not None
    assert s.opts.layout == sj.opts.layout and s.layout.n_pad == sj.layout.n_pad
    x_j, info_j = sj.solve(b)
    x, info = s.solve(b)
    assert not info["breakdown"]
    if bf16:
        assert _relres(a, x, b) < 5e-5
        assert abs(info["iters"] - info_j["iters"]) <= 0.25 * info_j["iters"]
    else:
        assert abs(info["iters"] - info_j["iters"]) <= 1
        assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def test_cuda_default_device_is_explicit(problem):
    """device='cuda' is the default and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    a, _ = problem
    with pytest.raises(RuntimeError, match="cuda"):
        DistributedECG.build(a, opts=_opts(ECGOptions, 1e-6), **BUILD)
