"""fmt="auto" through DistributedECG in both packages, on the CPU.

One matrix for each outcome of ``detect_format``: elasticity ("stencil"),
a tridiagonal ("dia"), a shuffled band that RCM recovers ("dia_rcm"), the
JAX tests' shuffled geometric graph ("block_ell_morton", 8×8 block-ELL
through the plain gather product), a random 8×8-block matrix
("block_ell_natural") and a random sparse matrix ("ell").

* f64 under the layout policy (``auto_layout=True``, the same rule in
  both drivers: on the CPU every outcome takes nt): the same choice,
  layout and permutation; iterations within ±1 of the JAX driver's; x
  within 1e-8 relative, in the ORIGINAL ordering (``pre_perm`` is
  transparent). The shuffled band solves with ``precond="none"`` and no
  scaling, as the JAX package's own test does.
* f64 with the lane-major layout pinned (``auto_layout=False``, tbn) for
  the stencil and DIA outcomes, against the JAX driver pinned the same.
* The layout policy: for every outcome (and bj2l on the stencil, which
  forces tbn) the port picks the JAX driver's layout, and still solves.
* f32 on the geometric graph: host-f64 refinement rounds (block-ELL has no
  double-float product), round counts within ±1 of the JAX driver's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.parallel.driver import (
    BlockEllOperands,
    DistributedECG,
)
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


def _geometric(rng, npts=600, rad=0.25):
    pts = rng.random((npts, 3))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    a = sp.csr_matrix((d2 < rad * rad).astype(np.float64))
    a = a + a.T
    a = sp.csr_matrix(sp.diags(np.asarray(a.sum(axis=1)).ravel() + 1.0) - a)
    pm = rng.permutation(npts)
    return sp.csr_matrix(a[pm][:, pm])


def _shuffled_band():
    n = 1200
    band = sp.diags([np.ones(n - 1), 4.0 * np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()
    pm = np.random.default_rng(42).permutation(n)
    return sp.csr_matrix(band[pm][:, pm])


def _block_random(nb=100, density=0.03, seed=3, bs=8):
    rng = np.random.default_rng(seed)
    pat = sp.csr_matrix(sp.random(nb, nb, density=density, random_state=seed,
                                  format="csr"))
    pat.data[:] = 1
    b = sp.kron(pat, np.ones((bs, bs))).tocsr()
    b.data = rng.standard_normal(b.nnz)
    s = sp.csr_matrix(b + b.T)
    return sp.csr_matrix(s + sp.diags(np.asarray(abs(s).sum(axis=1)).ravel() + 1))


def _random():
    """Random symmetric pattern, diagonally dominant (SPD)."""
    n = 400
    a = sp.random(n, n, density=0.01, random_state=7, format="csr")
    s = sp.csr_matrix(a + a.T)
    return sp.csr_matrix(s + sp.diags(np.asarray(abs(s).sum(axis=1)).ravel() + 1))


# name: (matrix, pinned layout (auto_layout=False), build options, ECG options)
CASES = {
    "stencil": (lambda: elasticity3d(3, 3, 3, heterogeneous=True), "tbn",
                dict(precond="block_jacobi", block_size=96), dict(t=4, tol=1e-8)),
    "dia": (lambda: sp.diags([np.ones(99), 4 * np.ones(100), np.ones(99)],
                             [-1, 0, 1]).tocsr(), "tbn",
            dict(precond="block_jacobi", block_size=32), dict(t=2, tol=1e-10)),
    "dia_rcm": (_shuffled_band, "nt", dict(precond="none", scale=False),
                dict(t=2, tol=1e-10)),
    "block_ell_morton": (lambda: _geometric(np.random.default_rng(42)), "nt",
                         dict(precond="block_jacobi", block_size=64),
                         dict(t=4, tol=1e-8)),
    "block_ell_natural": (_block_random, "nt",
                          dict(precond="block_jacobi", block_size=64),
                          dict(t=4, tol=1e-8)),
    "ell": (_random, "nt", dict(precond="block_jacobi", block_size=64),
            dict(t=4, tol=1e-8)),
}


def _relres(a, x, b):
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def _f64_parity(name, auto_layout):
    make, layout, kw, o = CASES[name]
    if auto_layout:
        layout = "nt"      # the policy's choice on the CPU, for every outcome
    a = make()
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    sj = JaxECG.build(a, nshards=1, fmt="auto", dtype=np.float64,
                      auto_layout=auto_layout,
                      opts=JaxOptions(maxiter=2000, layout=layout, **o), **kw)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, nshards=1, fmt="auto", dtype=np.float64,
                             auto_layout=auto_layout, device="cpu",
                             opts=ECGOptions(maxiter=2000, layout=layout, **o), **kw)
    assert s.fmt_info["chosen"] == sj.fmt_info["chosen"] == name
    assert s.fmt_info == sj.fmt_info
    assert s.opts.layout == sj.opts.layout == layout
    assert (s.pre_perm is None) == (sj.pre_perm is None)
    if s.pre_perm is not None:
        np.testing.assert_array_equal(s.pre_perm, sj.pre_perm)
    if name.startswith("block_ell"):
        ops = s.operands
        assert isinstance(ops, BlockEllOperands) and not ops.kernel
        assert ops.mat.bk == 8
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert not info["breakdown"]
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    assert _relres(a, x, b) < 1e-6


@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_auto_matches_jax(name):
    _f64_parity(name, auto_layout=True)


@pytest.mark.parametrize("name", ["stencil", "dia"])
def test_f64_auto_pinned_tbn_matches_jax(name):
    _f64_parity(name, auto_layout=False)


POLICY_CASES = sorted(CASES) + ["stencil_bj2l"]


@pytest.mark.parametrize("name", POLICY_CASES)
def test_auto_layout_policy(name):
    """For every detect_format outcome on the CPU the port picks the JAX
    driver's layout (nt; tbn only for bj2l, which exists only lane-major),
    and solves. An explicit tbn under auto_layout=False stays tbn on
    stencil/dia and falls to nt on a gather format, in both drivers."""
    make, _, kw, o = CASES[name.replace("_bj2l", "")]
    if name == "stencil_bj2l":
        kw = dict(precond="bj2l", block_size=96, grid=(4, 4, 3))
    a = make()
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    for auto_layout, asked in ((True, "nt"), (False, "tbn")):
        sj = JaxECG.build(a, nshards=1, fmt="auto", dtype=np.float64,
                          auto_layout=auto_layout,
                          opts=JaxOptions(maxiter=2000, layout=asked, **o), **kw)
        s = DistributedECG.build(a, nshards=1, fmt="auto", dtype=np.float64,
                                 device="cpu", auto_layout=auto_layout,
                                 opts=ECGOptions(maxiter=2000, layout=asked, **o),
                                 **kw)
        assert s.opts.layout == sj.opts.layout
        assert s.operands.layout == s.opts.layout
        if auto_layout:
            assert s.opts.layout == ("tbn" if name == "stencil_bj2l" else "nt")
            x, info = s.solve(b)
            assert _relres(a, x, b) < 1e-6 and not info["breakdown"]


def test_f32_auto_refines_on_the_host():
    make, layout, kw, o = CASES["block_ell_morton"]
    a = make()
    b = np.random.default_rng(2).standard_normal(a.shape[0])
    tol = 1e-7
    sj = JaxECG.build(a, nshards=1, fmt="auto", dtype=np.float32,
                      opts=JaxOptions(t=4, tol=tol, maxiter=2000, layout="nt"), **kw)
    x_j, info_j = sj.solve(b)
    s = DistributedECG.build(a, nshards=1, fmt="auto", dtype=np.float32, device="cpu",
                             opts=ECGOptions(t=4, tol=tol, maxiter=2000, layout="nt"),
                             **kw)
    assert s.fmt_info["chosen"] == "block_ell_morton" and not s.operands.df_ok
    x, info = s.solve(b)
    assert _relres(a, x, b) < tol and _relres(a, x_j, b) < tol
    assert info["device_rounds"] == 0 and info["refine_rounds"] >= 2
    assert abs(info["refine_rounds"] - info_j["refine_rounds"]) <= 1
