"""DIA products in the port against the JAX package, on the CPU.

* br = 1 stencil products with D > 64 offsets (the cap of the port's
  earlier stencil kernels): the DIA table of elasticity3d (D = 99) and a
  synthetic 99-diagonal band whose halo reaches 90 % of n, through the
  plain versions of B1 (``stencil_flat_ext``, the ``fmt="dia"`` lane-major
  operator) and B2b (``stencil_pallas_bs_ext``, the sweep's ``dia_tbn``) on
  a wrap-extended panel, against JAX ``stencil_scan_accumulate``.
* ``dia_ell_spmm`` against the JAX ``dia_ell_spmm`` and scipy, with and
  without an ELL remainder.

Held to |y_port − y_jax| ≤ tol · max(|A|·|x|), tol 1e-12 in f64 and 1e-5
in f32 (the same products, summed in the same order on both sides).
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.partition import rcm_order
from prealps_tpu.ops import formats as jfmt
from prealps_tpu.ops import spmm as jspmm
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@functools.lru_cache(maxsize=None)
def _diags(kind, dtype):
    if kind == "elasticity":
        offsets, diags, rem = tfmt.dia_ell_host(elasticity3d(4, 4, 3), min_fill=0.05,
                                                dtype=dtype)
        assert rem is None
    else:
        n = 500
        rng = np.random.default_rng(9)
        offsets = tuple(sorted(int(o) for o in rng.choice(np.arange(-450, 451), 99,
                                                          replace=False)))
        diags = rng.standard_normal((99, n)).astype(dtype)
        rows = np.arange(n)
        for d, o in enumerate(offsets):    # zero where the column leaves A
            diags[d, (rows + o < 0) | (rows + o >= n)] = 0.0
    assert len(offsets) == 99
    return offsets, diags


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("t", [1, 12])
@pytest.mark.parametrize("kind", ["elasticity", "band"])
def test_br1_products_with_99_offsets(kind, t, dtype):
    offsets, diags = _diags(kind, dtype)
    n = diags.shape[1]
    halo = max(abs(o) for o in offsets)
    x = np.random.default_rng(t).standard_normal((t, 1, n)).astype(dtype)
    x_ext = np.concatenate([x[:, :, n - halo:], x, x[:, :, :halo]], axis=2)
    d_t = diags[:, None, None, :]
    jprod = jax.jit(lambda b, v: jspmm.stencil_scan_accumulate(b, offsets, v, halo))
    ref = np.asarray(jprod(jnp.asarray(d_t), jnp.asarray(x_ext)))
    scale = np.asarray(jprod(jnp.asarray(np.abs(d_t)), jnp.asarray(np.abs(x_ext))))
    tol = TOL[dtype] * scale.max()
    b1, b2b = tspmm.stencil_flat_ext.launches, tspmm.stencil_pallas_bs_ext.launches
    y1 = tspmm.stencil_flat_ext(torch.from_numpy(diags), offsets,
                                torch.from_numpy(x_ext[:, 0]), halo, 1).numpy()
    y2 = tspmm.stencil_pallas_bs_ext(torch.from_numpy(d_t), offsets,
                                     torch.from_numpy(x_ext), halo).numpy()
    assert (tspmm.stencil_flat_ext.launches, tspmm.stencil_pallas_bs_ext.launches) == (b1, b2b)
    assert y1.shape == (t, n) and y2.shape == (t, 1, n)
    assert np.all(np.abs(y1 - ref[:, 0]) <= tol)
    assert np.all(np.abs(y2 - ref) <= tol)


def _dia_matrices():
    rng = np.random.default_rng(42)
    n = 300
    band = sp.diags([rng.standard_normal(n - abs(k)) for k in (-7, -1, 0, 1, 7)],
                    offsets=[-7, -1, 0, 1, 7], shape=(n, n), format="csr")
    noise = sp.random(n, n, density=0.002, random_state=7, format="csr")
    ela = sp.csr_matrix(elasticity3d(4, 3, 3))
    p = rcm_order(ela)
    return {"band_noise": (sp.csr_matrix(band + noise), 0.5),
            "elasticity_rcm": (sp.csr_matrix(ela[p][:, p]), 0.02),
            "elasticity": (ela, 0.05)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["band_noise", "elasticity_rcm", "elasticity"])
def test_dia_ell_spmm_matches_jax(name, dtype):
    a, min_fill = _dia_matrices()[name]
    dt = tfmt.csr_to_dia_ell(a, min_fill=min_fill, dtype=dtype)
    dj = jfmt.csr_to_dia_ell(a, min_fill=min_fill, dtype=dtype)
    assert (dt.rem is None) == (name == "elasticity")
    x = np.random.default_rng(3).standard_normal((a.shape[0], 4)).astype(dtype)
    y = tspmm.dia_ell_spmm(dt, torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jspmm.dia_ell_spmm)(dj, jnp.asarray(x)))
    tol = TOL[dtype] * (abs(a) @ np.abs(x)).max()
    assert y.dtype == dtype
    assert np.all(np.abs(y - ref) <= tol)
    assert np.all(np.abs(y - a @ x.astype(np.float64)) <= tol)
