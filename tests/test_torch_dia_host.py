"""The DIA and format-detection host layer in the port against the JAX
package's, exactly.

``csr_to_dia_ell``, ``dia_coverage``, ``block_fill``, ``detect_format``,
``csr_to_dia_ell_auto``, ``pseudo_coords`` and ``morton_perm`` are
numpy/scipy copies in the port: the same arrays bit for bit, the same
choices and permutations. The matrices are those of the JAX package's own
tests (tests/test_spmm.py): a band with noise, a pure band, a shuffled band
(RCM recovers it: "dia_rcm"), a shuffled geometric graph ("block_ell_morton"),
a random matrix ("ell"), a scalar band that also passes the block-stencil
test ("dia"), and elasticity ("stencil").
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from prealps_tpu.core import partition as jpart
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.ops import formats as jfmt
from prealps_tpu_torch.core import partition as tpart
from prealps_tpu_torch.ops import formats as tfmt

torch.set_num_threads(1)


def _geometric(rng, npts=600, rad=0.25):
    """Shuffled SPD graph Laplacian on random 3-D points (as test_spmm.py)."""
    pts = rng.random((npts, 3))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    a = sp.csr_matrix((d2 < rad * rad).astype(np.float64))
    a = a + a.T
    a = sp.csr_matrix(sp.diags(np.asarray(a.sum(axis=1)).ravel() + 1.0) - a)
    pm = rng.permutation(npts)
    return sp.csr_matrix(a[pm][:, pm])


def _band_noise():
    rng = np.random.default_rng(42)
    n = 300
    band = sp.diags([rng.standard_normal(n - abs(k)) for k in (-7, -1, 0, 1, 7)],
                    offsets=[-7, -1, 0, 1, 7], shape=(n, n), format="csr")
    noise = sp.random(n, n, density=0.002, random_state=7, format="csr")
    return sp.csr_matrix(band + noise)


def _shuffled_band():
    n = 1200
    band = sp.diags([np.ones(n - 1), 4.0 * np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()
    pm = np.random.default_rng(42).permutation(n)
    return sp.csr_matrix(band[pm][:, pm])


def _random():
    n = 400
    a = sp.random(n, n, density=0.01, random_state=7, format="csr")
    return sp.csr_matrix(a + a.T + sp.eye(n))


def _scalar_band():
    rng = np.random.default_rng(42)
    n = 6_000
    mats = [sp.diags(rng.random(n - o) + 0.1, o, shape=(n, n))
            for o in (0, 1, 2, 3, 5, 8, 13, 21, 34)]
    band = sum(mats[1:], mats[0])
    band = (band + band.T).tocsr()
    return sp.csr_matrix(band + sp.diags(np.asarray(abs(band).sum(axis=1)).ravel()))


MATRICES = {
    "band_noise": _band_noise,
    "tridiag": lambda: sp.diags([np.ones(99), 4 * np.ones(100), np.ones(99)],
                                [-1, 0, 1]).tocsr(),
    "shuffled_band": _shuffled_band,
    "geometric": lambda: _geometric(np.random.default_rng(42)),
    "random": _random,
    "scalar_band": _scalar_band,
    "elasticity": lambda: elasticity3d(4, 4, 3),
    "elasticity_het": lambda: elasticity3d(5, 4, 4, heterogeneous=True),
}
CHOICE = {"band_noise": "dia", "tridiag": "dia", "shuffled_band": "dia_rcm",
          "geometric": "block_ell_morton", "random": "ell",
          "scalar_band": "dia", "elasticity": "stencil",
          "elasticity_het": "stencil"}


@pytest.fixture(scope="module")
def mats():
    return {k: f() for k, f in MATRICES.items()}


@pytest.mark.parametrize("min_fill,max_diags", [(0.05, 512), (0.5, 512), (0.02, 3)])
@pytest.mark.parametrize("name", ["band_noise", "shuffled_band", "elasticity_het",
                                  "geometric"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_csr_to_dia_ell_equal(mats, name, min_fill, max_diags, dtype):
    a = mats[name]
    dt = tfmt.csr_to_dia_ell(a, min_fill=min_fill, max_diags=max_diags, dtype=dtype)
    dj = jfmt.csr_to_dia_ell(a, min_fill=min_fill, max_diags=max_diags, dtype=dtype)
    assert dt.offsets == dj.offsets and tuple(dt.shape) == tuple(dj.shape)
    np.testing.assert_array_equal(dt.diags.numpy(), np.asarray(dj.diags))
    assert (dt.rem is None) == (dj.rem is None)
    if dt.rem is not None:
        np.testing.assert_array_equal(dt.rem.vals.numpy(), np.asarray(dj.rem.vals))
        np.testing.assert_array_equal(dt.rem.cols.numpy(), np.asarray(dj.rem.cols))


@pytest.mark.parametrize("min_fill", [0.05, 0.2])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_coverage_and_block_fill_equal(mats, name, min_fill):
    a = mats[name]
    assert tfmt.dia_coverage(a, min_fill) == jfmt.dia_coverage(a, min_fill)
    for bm, bk in ((8, 8), (8, 128)):
        assert tfmt.block_fill(a, bm, bk) == jfmt.block_fill(a, bm, bk)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_detect_format_equal(mats, name):
    """Same choice, scores and permutation; the permuted matrix equal."""
    a = mats[name]
    ft, it = tfmt.detect_format(a, br=3)
    fj, ij = jfmt.detect_format(a, br=3)
    assert ft == fj == CHOICE[name]
    assert ("perm" in it) == ("perm" in ij)
    if "perm" in it:
        np.testing.assert_array_equal(it.pop("perm"), ij.pop("perm"))
        pt, pj = it.pop("permuted"), ij.pop("permuted")
        assert (pt != pj).nnz == 0
    assert it == ij


@pytest.mark.parametrize("name", ["geometric", "shuffled_band", "random"])
def test_detect_format_without_reorder_equal(mats, name):
    a = mats[name]
    kw = dict(br=3, allow_stencil=False, allow_reorder=False)
    assert tfmt.detect_format(a, **kw) == jfmt.detect_format(a, **kw)


@pytest.mark.parametrize("name", ["elasticity", "shuffled_band", "band_noise"])
def test_csr_to_dia_ell_auto_equal(mats, name):
    a = mats[name]
    dt, pt = tfmt.csr_to_dia_ell_auto(a, min_fill=0.05)
    dj, pj = jfmt.csr_to_dia_ell_auto(a, min_fill=0.05)
    assert (pt is None) == (pj is None)
    if pt is not None:
        np.testing.assert_array_equal(pt, pj)
    assert dt.offsets == dj.offsets
    np.testing.assert_array_equal(dt.diags.numpy(), np.asarray(dj.diags))


@pytest.mark.parametrize("k,smooth", [(3, 3), (2, 0)])
@pytest.mark.parametrize("name", ["geometric", "elasticity", "random"])
def test_pseudo_coords_and_morton_equal(mats, name, k, smooth):
    """The BFS sweeps break ties in the same order: equal coordinates and
    Morton permutations."""
    a = mats[name]
    ct = tpart.pseudo_coords(a, k=k, smooth=smooth)
    cj = jpart.pseudo_coords(a, k=k, smooth=smooth)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(tpart.morton_perm(ct), jpart.morton_perm(cj))
    np.testing.assert_array_equal(tpart.morton_perm(ct[:, 0], bits=6),
                                  jpart.morton_perm(cj[:, 0], bits=6))
