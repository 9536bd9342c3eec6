"""The port's general-matrix LORASC (prealps_tpu_torch/precond/lorasc.py and
api.ECGSolver(precond="lorasc")) against the JAX package's, on the CPU.

ela_small (heterogeneous elasticity3d(6,5,5), RAC-scaled), 4 parts, the
native block-arrow partition in both packages (the default), f64 unless
stated; the configurations of tests/test_lorasc.py:

* ``schur_complement_dense`` bitwise;
* ``build_lorasc`` direct: the arrow, the interior and separator factors
  bitwise, the ELL blocks bitwise, e_mat up to the sign of each vector and
  sigma within 1e-10 relative;
* ``build_lorasc`` lanczos against the direct build (tests/test_lorasc.py's
  contract) and against JAX's Lanczos build (the same count of pairs,
  sigma within 1e-8);
* the apply on the JAX build's fields (``ecg_solver_from_reference``)
  within 1e-12 of JAX's apply;
* ``ECGSolver(precond="lorasc")``: iterations within ±1 and x within 1e-8
  of the JAX solve, on its own build and on JAX's fields;
* f32 with host-f64 refinement: both packages' rounds and counts logged,
  each held to convergence (true relres within 100 × tol).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from api_reference import jax_build, rel
from prealps_tpu.api import ECGSolver as JaxSolver
from prealps_tpu.core.partition import block_arrow_structure as j_arrow
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.precond import lorasc as jl
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.api import ECGSolver
from prealps_tpu_torch.core.partition import block_arrow_structure, permute
from prealps_tpu_torch.interop import ecg_solver_from_reference
from prealps_tpu_torch.precond import lorasc as tl
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

OPTS = dict(t=2, tol=1e-8, maxiter=2000, variant="odir_fused")


@pytest.fixture(scope="module")
def scaled(ela_small):
    a, _ = sym_rac_scaling(ela_small)
    return a


@pytest.fixture(scope="module")
def builds(scaled):
    """(port, JAX) direct builds at deflation_tol 1e-1 (pairs to compare)."""
    kw = dict(nparts=4, deflation_tol=1e-1, dtype=np.float64)
    return tl.build_lorasc(scaled, device="cpu", **kw), jl.build_lorasc(scaled, **kw)


def test_schur_complement_dense_bitwise(scaled):
    arrow = block_arrow_structure(scaled, 4)
    ap, ni = permute(scaled, arrow.perm), arrow.sep_start
    blocks = tl.arrow_blocks(ap, ni)
    np.testing.assert_array_equal(tl.schur_complement_dense(*blocks),
                                  jl.schur_complement_dense(*blocks))


def test_direct_build_matches(builds):
    (lor, arrow), (lor_j, arrow_j) = builds
    np.testing.assert_array_equal(arrow.perm, arrow_j.perm)
    assert (lor.ni, lor.ng) == (lor_j.ni, lor_j.ng)
    np.testing.assert_array_equal(lor.aii_solver.factors.numpy(),
                                  np.asarray(lor_j.aii_solver.factors))
    np.testing.assert_array_equal(lor.aii_solver.gather_idx.numpy(),
                                  np.asarray(lor_j.aii_solver.gather_idx))
    np.testing.assert_array_equal(lor.agg_solver.factor.numpy(),
                                  np.asarray(lor_j.agg_solver.factor))
    for m in ("aig", "agi"):
        np.testing.assert_array_equal(getattr(lor, m).vals.numpy(),
                                      np.asarray(getattr(lor_j, m).vals))
        np.testing.assert_array_equal(getattr(lor, m).cols.numpy(),
                                      np.asarray(getattr(lor_j, m).cols))
    assert lor.nev == lor_j.nev >= 2
    e, e_j = lor.e_mat.numpy(), np.asarray(lor_j.e_mat)
    sign = np.sign(np.sum(e * e_j, axis=0))
    assert rel(e * sign, e_j) < 1e-10
    assert rel(lor.sigma.numpy(), np.asarray(lor_j.sigma)) < 1e-10


def test_lanczos_against_direct_and_jax(scaled, builds):
    arrow = block_arrow_structure(scaled, 4)
    kw = dict(arrow=arrow, deflation_tol=1e-1, eig_method="lanczos",
              lanczos_ncv=min(arrow.sep_size, 80))
    lor_l, _ = tl.build_lorasc(scaled, device="cpu", **kw)
    nd = builds[0][0].nev
    assert lor_l.nev >= min(nd, 3) - 1          # tests/test_lorasc.py:53-66
    lor_lj, _ = jl.build_lorasc(scaled, arrow=j_arrow(scaled, 4), **{
        k: v for k, v in kw.items() if k != "arrow"})
    assert lor_l.nev == lor_lj.nev
    assert rel(lor_l.sigma.numpy(), np.asarray(lor_lj.sigma)) < 1e-8


def test_no_pair_keeps_one_zero_vector(scaled):
    lor, _ = tl.build_lorasc(scaled, nparts=4, deflation_tol=1e-12, device="cpu")
    lor_j, _ = jl.build_lorasc(scaled, nparts=4, deflation_tol=1e-12)
    assert lor.nev == lor_j.nev == 1
    assert float(lor.sigma.abs().sum()) == 0.0


def test_apply_on_jax_fields(ela_small, rng):
    fields, meta, m_j = jax_build(ela_small, JaxOptions(**OPTS), "lorasc", nparts=4,
                                  deflation_tol=1e-1)
    solver = ecg_solver_from_reference(fields, meta, device="cpu")
    v = rng.standard_normal((meta["n"], 3))
    w = solver.precond.apply(torch.from_numpy(v)).numpy()
    assert rel(w, np.asarray(m_j.apply(jnp.asarray(v)))) < 1e-12


@pytest.mark.parametrize("eig_method", ["direct", "lanczos"])
def test_solver_matches_jax(ela_small, rng, eig_method):
    b = rng.standard_normal(ela_small.shape[0])
    kw = dict(nparts=4, eig_method=eig_method)
    x, info = ECGSolver.build(ela_small, opts=ECGOptions(**OPTS), precond="lorasc",
                              device="cpu", **kw).solve(b)
    x_j, info_j = JaxSolver.build(ela_small, opts=JaxOptions(**OPTS),
                                  precond="lorasc", **kw).solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert rel(x, x_j) < 1e-8
    assert not info["breakdown"]
    assert np.linalg.norm(b - ela_small @ x) / np.linalg.norm(b) < 1e-6
    fields, meta, _ = jax_build(ela_small, JaxOptions(**OPTS), "lorasc", **kw)
    x_r, info_r = ecg_solver_from_reference(fields, meta, device="cpu").solve(b)
    assert abs(info_r["iters"] - info_j["iters"]) <= 1
    assert rel(x_r, x_j) < 1e-8


def test_lorasc_beats_block_jacobi(ela_small, rng):
    b = rng.standard_normal(ela_small.shape[0])
    opts = ECGOptions(t=2, tol=1e-6, maxiter=4000)
    _, i_bj = ECGSolver.build(ela_small, opts=opts, precond="block_jacobi", nblocks=4,
                              device="cpu").solve(b)
    x, i_lo = ECGSolver.build(ela_small, opts=opts, precond="lorasc", nparts=4,
                              device="cpu").solve(b)
    assert np.linalg.norm(b - ela_small @ x) / np.linalg.norm(b) < 1e-5
    assert i_lo["iters"] < i_bj["iters"]


def test_f32_refinement_logged(ela_small, rng):
    """f32 solve with host-f64 rounds in both packages: the counts are
    logged beside each other (the f32 drift of ROADMAP A4 is rounding, not
    held), each converged: the true relative residual of the unscaled
    system within 100 × tol (the CLI's test)."""
    b = rng.standard_normal(ela_small.shape[0])
    opts = dict(t=4, tol=1e-8, maxiter=3000)
    x, info = ECGSolver.build(ela_small, opts=ECGOptions(**opts), precond="lorasc",
                              nparts=4, dtype=np.float32, device="cpu").solve(b)
    x_j, info_j = JaxSolver.build(ela_small, opts=JaxOptions(**opts), precond="lorasc",
                                  nparts=4, dtype=np.float32).solve(b)
    print(f"f32 LORASC: port {info['iters']} iterations in {info['refine_rounds']} "
          f"rounds, JAX {info_j['iters']} in {info_j['refine_rounds']}")
    for xx, ii in ((x, info), (x_j, info_j)):
        assert ii["refine_rounds"] >= 1 and not ii["breakdown"]
        assert np.linalg.norm(b - ela_small @ xx) / np.linalg.norm(b) < 1e-6
