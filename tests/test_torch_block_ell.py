"""The port's general-format SpMMs against the JAX package's.

* ``block_ell_spmm_pallas`` on CPU tensors (its plain version,
  ``block_ell_spmm``) against the Pallas kernel in interpret mode, for
  bk ∈ {8, 128} and t ∈ {1, 12}, in f32: within 1e-5·max(|B|·|x|) (the two
  sum in different orders; the CUDA kernel, held to the same bound on the
  card, in yet another), and the exact f64 product within the same bound.
* ``block_ell_spmm`` and ``ell_spmm`` in f64 against the JAX XLA versions
  and a @ x to 1e-12.
* ``ell_gather_spmm_df``: hi + lo within 1e-12 (relative to |A|·|x|) of
  the f64 product of the same f32 inputs, and the JAX version's hi within
  plain-f32 accuracy (XLA:CPU contracts its transforms into FMAs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops import formats as jfmt
from prealps_tpu.ops import spmm as jspmm
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm

torch.set_num_threads(1)


@pytest.fixture(params=["ela_small", "poisson_small"])
def problem(request):
    return sym_rac_scaling(request.getfixturevalue(request.param))[0]


def _x(rows, t, dtype, seed):
    return np.random.default_rng(seed).standard_normal((rows, t)).astype(dtype)


@pytest.mark.parametrize("t", [1, 12])
@pytest.mark.parametrize("bk", [8, 128])
def test_block_ell_kernel_route_matches_pallas_f32(problem, bk, t):
    a = problem
    mt = tfmt.csr_to_block_ell(a, bm=8, bk=bk, dtype=np.float32)
    mj = jfmt.csr_to_block_ell(a, bm=8, bk=bk, dtype=np.float32)
    x = _x(mt.shape[1], t, np.float32, seed=bk + t)
    before = tspmm.block_ell_spmm_pallas.launches
    y_t = tspmm.block_ell_spmm_pallas(mt, torch.from_numpy(x)).numpy()
    assert tspmm.block_ell_spmm_pallas.launches == before    # CPU: no launch
    y_j = np.asarray(jspmm.block_ell_spmm_pallas(mj, jnp.asarray(x), interpret=True))
    assert y_t.dtype == y_j.dtype == np.float32 and y_t.shape == y_j.shape
    scale = tspmm.block_ell_spmm(
        tfmt.BlockEllMatrix(mt.blocks.abs(), mt.blkcols, mt.shape),
        torch.from_numpy(np.abs(x))).numpy()
    bound = 1e-5 * scale.max()
    assert np.abs(y_t - y_j).max() <= bound
    n = a.shape[0]
    exact = a @ x[:n].astype(np.float64)
    assert np.abs(y_t[:n].astype(np.float64) - exact).max() <= bound


@pytest.mark.parametrize("bk", [8, 128])
def test_block_ell_plain_matches_xla_f64(ela_small, bk):
    a = ela_small
    mt = tfmt.csr_to_block_ell(a, bm=8, bk=bk, dtype=np.float64)
    mj = jfmt.csr_to_block_ell(a, bm=8, bk=bk, dtype=np.float64)
    x = _x(mt.shape[1], 5, np.float64, seed=3)
    y_t = tspmm.block_ell_spmm(mt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, np.asarray(jspmm.block_ell_spmm(mj, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y_t[:a.shape[0]], a @ x[:a.shape[0]], rtol=1e-12,
                               atol=1e-12)


def test_block_ell_wrapper_checks(ela_small):
    m = tfmt.csr_to_block_ell(ela_small, bm=8, bk=128, dtype=np.float32)
    x = torch.from_numpy(_x(m.shape[1], 2, np.float32, seed=4))
    with pytest.raises(ValueError, match="rows"):
        tspmm.block_ell_spmm_pallas(m, x[1:])
    with pytest.raises(ValueError, match="match"):
        tspmm.block_ell_spmm_pallas(
            tfmt.BlockEllMatrix(m.blocks, m.blkcols[:, 1:], m.shape), x)


@pytest.mark.parametrize("t", [1, 4])
def test_ell_spmm_matches_xla_f64(problem, t):
    a = problem
    et = tfmt.csr_to_ell(a, dtype=np.float64)
    ej = jfmt.csr_to_ell(a, dtype=np.float64)
    x = _x(a.shape[0], t, np.float64, seed=t)
    y_t = tspmm.ell_spmm(et, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, np.asarray(jspmm.ell_spmm(ej, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y_t, a @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("t", [1, 2])
def test_ell_df_product_matches_f64_and_jax(problem, t):
    a = problem
    et = tfmt.csr_to_ell(a, dtype=np.float32)
    x = _x(a.shape[0], t, np.float32, seed=20 + t)
    gathered = torch.from_numpy(x)[et.cols]
    hi, lo = tspmm.ell_gather_spmm_df(et.vals, gathered)
    assert hi.dtype == lo.dtype == torch.float32
    exact = (et.vals.double()[:, :, None] * gathered.double()).sum(1).numpy()
    scale = (et.vals.double().abs()[:, :, None] * gathered.double().abs()).sum(1).numpy()
    got = hi.double().numpy() + lo.double().numpy()
    assert np.all(np.abs(got - exact) <= 1e-12 * scale.max())
    jh, jl = jspmm.ell_gather_spmm_df(jnp.asarray(et.vals.numpy()),
                                      jnp.asarray(gathered.numpy()))
    assert np.asarray(jh).dtype == np.float32
    np.testing.assert_allclose(hi.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6 * scale.max())
