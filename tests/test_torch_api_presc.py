"""The port's general-matrix PRESC (prealps_tpu_torch/precond/presc.py,
direct/banded.py::block_banded_schur and api.ECGSolver(precond="presc"))
against the JAX package's, on the CPU in f64.

ela_small (heterogeneous elasticity3d(6,5,5), RAC-scaled), 4 parts, the
native block-arrow partition (the default in both packages); the
configurations of tests/test_presc.py and tests/test_banded.py:

* ``separator_owners`` bitwise;
* ``local_schur_complements`` and ``local_schur_complements_banded``
  within 1e-10 relative of JAX's, and of each other;
* ``block_banded_schur`` against JAX's and against scipy's dense Schur
  complement (tests/test_banded.py:139-190), and a non-SPD block flagged;
* ``build_presc`` for ssloc / saloc × direct / lanczos: the pairs and
  sigma (1e-8) of JAX's build;
* ``ECGSolver(precond="presc")`` for those builds and the banded Schur:
  iterations within ±1 and x within 1e-8 of the JAX solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from api_reference import jax_build, rel
from prealps_tpu.api import ECGSolver as JaxSolver
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.direct import banded as jb
from prealps_tpu.precond import presc as jp
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.api import ECGSolver
from prealps_tpu_torch.core.partition import block_arrow_structure, permute
from prealps_tpu_torch.direct import banded as tb
from prealps_tpu_torch.interop import ecg_solver_from_reference
from prealps_tpu_torch.precond import presc as tp
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

OPTS = dict(t=2, tol=1e-8, maxiter=3000, variant="odir_fused")


@pytest.fixture(scope="module")
def arrowed(ela_small):
    a, _ = sym_rac_scaling(ela_small)
    arrow = block_arrow_structure(a, 4)
    ap = permute(a, arrow.perm)
    return ap, arrow, tp.separator_owners(ap, arrow)


def test_separator_owners_bitwise(arrowed):
    ap, arrow, owner = arrowed
    np.testing.assert_array_equal(owner, jp.separator_owners(ap, arrow))
    assert owner.shape[0] == arrow.sep_size
    assert owner.min() >= 0 and owner.max() < 4


def test_local_schur_complements(arrowed):
    ap, arrow, owner = arrowed
    order = np.argsort(owner, kind="stable")
    ni = arrow.sep_start
    ap2 = permute(ap, np.concatenate([np.arange(ni), ni + order]))
    owner2 = owner[order]
    dense, off = tp.local_schur_complements(ap2, arrow, owner2)
    dense_j, off_j = jp.local_schur_complements(ap2, arrow, owner2)
    banded, off_b = tp.local_schur_complements_banded(ap2, arrow, owner2, device="cpu")
    banded_j, _ = jp.local_schur_complements_banded(ap2, arrow, owner2)
    np.testing.assert_array_equal(off, off_j)
    np.testing.assert_array_equal(off, off_b)
    for s, s_j, s_b, s_bj in zip(dense, dense_j, banded, banded_j):
        if not s.size:
            continue
        assert rel(s, s_j) < 1e-10
        assert rel(s_b, s_bj) < 1e-10
        assert rel(s_b, s) < 1e-10
        np.linalg.cholesky(s)


def _spd_banded(n, band, rng):
    """tests/test_banded.py's random SPD matrix of half-bandwidth ≤ band."""
    diags = [rng.standard_normal(n) for _ in range(band)]
    a = sp.diags([np.zeros(n)] + diags, offsets=[0] + list(range(1, band + 1)),
                 shape=(n, n)).tocsr()
    a = a + a.T
    return sp.csr_matrix(a + sp.eye(n) * (np.abs(a).sum(axis=1).max() + 1.0))


@pytest.mark.parametrize("n_schur", [3, 8, 16])
def test_block_banded_schur(rng, n_schur):
    blocks = [_spd_banded(m, 5, rng) for m in (48, 57)]
    plan = tb.plan_block_banded(blocks, bs=16, order="natural")
    d, e = tb.assemble_host(plan, blocks)
    schur, bad = tb.block_banded_schur(torch.from_numpy(d), torch.from_numpy(e), n_schur)
    schur_j, bad_j = jb.block_banded_schur(jnp.asarray(d), jnp.asarray(e), n_schur)
    assert not bad and not bool(bad_j)
    assert rel(schur.numpy(), np.asarray(schur_j)) < 1e-12
    pad = plan.rows_padded
    for i, b in enumerate(blocks):
        a_full = np.eye(pad)
        a_full[:b.shape[0], :b.shape[0]] = b.toarray()
        k = pad - n_schur
        a12 = a_full[:k, k:]
        s_ref = a_full[k:, k:] - a12.T @ np.linalg.solve(a_full[:k, :k], a12)
        np.testing.assert_allclose(schur[i].numpy(), s_ref, rtol=1e-9, atol=1e-10)


def test_block_banded_schur_flags_and_refuses(rng):
    d = np.stack([np.eye(8)] * 3)[None].copy()
    e = np.zeros_like(d)
    d[0, 1] = -np.eye(8)                       # not SPD in a leading block
    _, bad = tb.block_banded_schur(torch.from_numpy(d), torch.from_numpy(e), 4)
    _, bad_j = jb.block_banded_schur(jnp.asarray(d), jnp.asarray(e), 4)
    assert bad and bool(bad_j)
    with pytest.raises(ValueError, match="n_schur"):
        tb.block_banded_schur(torch.from_numpy(d), torch.from_numpy(e), 9)


CASES = {"ssloc_direct": dict(eigs_kind="ssloc"),
         "saloc_direct": dict(eigs_kind="saloc"),
         "ssloc_lanczos": dict(eigs_kind="ssloc", eig_method="lanczos"),
         "saloc_lanczos": dict(eigs_kind="saloc", eig_method="lanczos"),
         "ssloc_banded": dict(eigs_kind="ssloc", schur_method="banded")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_and_solve_match_jax(ela_small, rng, case):
    kw = dict(nparts=4, **CASES[case])
    a_s, _ = sym_rac_scaling(ela_small)
    pre, arrow = tp.build_presc(a_s, device="cpu", **kw)
    pre_j, arrow_j = jp.build_presc(a_s, **kw)
    np.testing.assert_array_equal(arrow.perm, arrow_j.perm)
    assert pre.nev == pre_j.nev
    assert rel(pre.sigma.numpy(), np.asarray(pre_j.sigma)) < 1e-8
    b = rng.standard_normal(ela_small.shape[0])
    x, info = ECGSolver.build(ela_small, opts=ECGOptions(**OPTS), precond="presc",
                              device="cpu", **kw).solve(b)
    x_j, info_j = JaxSolver.build(ela_small, opts=JaxOptions(**OPTS), precond="presc",
                                  **kw).solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert rel(x, x_j) < 1e-8
    assert not info["breakdown"]
    assert np.linalg.norm(b - ela_small @ x) / np.linalg.norm(b) < 1e-6


def test_solve_on_jax_fields(ela_small, rng):
    fields, meta, _ = jax_build(ela_small, JaxOptions(**OPTS), "presc", nparts=4)
    b = rng.standard_normal(ela_small.shape[0])
    x, info = ecg_solver_from_reference(fields, meta, device="cpu").solve(b)
    x_j, info_j = JaxSolver.build(ela_small, opts=JaxOptions(**OPTS), precond="presc",
                                  nparts=4).solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert rel(x, x_j) < 1e-8


def test_unknown_options_raise(ela_small):
    for kw in (dict(eigs_kind="nope"), dict(eig_method="nope"),
               dict(schur_method="nope")):
        with pytest.raises(ValueError, match="unknown"):
            tp.build_presc(ela_small, nparts=4, device="cpu", **kw)
