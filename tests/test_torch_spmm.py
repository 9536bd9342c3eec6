"""The port's stencil SpMM against the JAX package's.

* ``stencil_flat_ext_ref`` (the CUDA kernel's plain version) against the
  Pallas kernel ``stencil_flat_ext`` in interpret mode and against a @ x,
  for br = 3 and br = 1: rtol 1e-12 in f64; in f32 within 1e-5 of
  |B|·|x| (the rounding bound of a length-S·br f32 dot product, with room
  for the kernel's FMA contraction on the card).
* the ``stencil_flat_ext`` wrapper on CPU tensors runs the plain version
  and counts no launch.
* the double-float residual product against the JAX version and against
  the f64 product.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
(marked ``cuda``) and ``python3 chip_smoke.py``, which holds it against the
plain version at the full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.ops import spmm as jspmm
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm

torch.set_num_threads(1)


def _operands(a, br, t, dtype, seed):
    """Flat block table, k-major x with wrap halos, and x as (n, t)."""
    st = tfmt.csr_to_stencil_bsr_t(a, br=br, dtype=dtype, device="cpu")
    halo = max(abs(o) for o in st.offsets)
    x = np.random.default_rng(seed).standard_normal((a.shape[0], t)).astype(dtype)
    xf = tfmt.panel_to_flat_kmajor(tfmt.panel_to_lane_major(torch.from_numpy(x), br))
    x_ext = tspmm.extend_wrap(xf, halo).contiguous()
    bf = tfmt.stencil_blocks_flat(st.blocks_t).contiguous()
    return bf, st.offsets, x_ext, halo, x


def _to_nt(yf, br):
    return tfmt.panel_from_lane_major(tfmt.panel_from_flat_kmajor(yf, br)).numpy()


@pytest.fixture(params=["ela_small", "poisson_small"])
def problem(request):
    a = request.getfixturevalue(request.param)
    return a, (3 if request.param == "ela_small" else 1)


@pytest.mark.parametrize("t", [1, 4])
def test_flat_ref_matches_pallas_and_dense_f64(problem, t):
    a, br = problem
    bf, offs, x_ext, halo, x = _operands(a, br, t, np.float64, seed=t)
    y_t = tspmm.stencil_flat_ext_ref(bf, offs, x_ext, halo, br)
    y_j = jspmm.stencil_flat_ext(jnp.asarray(bf.numpy()), offs,
                                 jnp.asarray(x_ext.numpy()), halo, br=br,
                                 chunk=128, interpret=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_to_nt(y_t, br), a @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("t", [1, 12])
def test_flat_ref_matches_pallas_and_dense_f32(problem, t):
    a, br = problem
    bf, offs, x_ext, halo, x = _operands(a, br, t, np.float32, seed=10 + t)
    y_t = tspmm.stencil_flat_ext_ref(bf, offs, x_ext, halo, br).numpy()
    y_j = np.asarray(jspmm.stencil_flat_ext(
        jnp.asarray(bf.numpy()), offs, jnp.asarray(x_ext.numpy()), halo,
        br=br, chunk=128, interpret=True))
    assert y_j.dtype == np.float32 and y_t.dtype == np.float32
    scale = tspmm.stencil_flat_ext_ref(bf.abs(), offs, x_ext.abs(), halo, br).numpy()
    bound = 1e-5 * scale + 1e-30
    assert np.all(np.abs(y_t - y_j) <= bound)
    y_64 = _to_nt(torch.from_numpy(y_t), br).astype(np.float64)
    exact = a @ x.astype(np.float64)
    assert np.all(np.abs(y_64 - exact) <= _to_nt(torch.from_numpy(bound), br))


def test_wrapper_on_cpu_runs_plain_version(ela_small):
    bf, offs, x_ext, halo, _ = _operands(ela_small, 3, 4, np.float32, seed=3)
    before = tspmm.stencil_flat_ext.launches
    y = tspmm.stencil_flat_ext(bf, offs, x_ext, halo, 3)
    assert tspmm.stencil_flat_ext.launches == before
    torch.testing.assert_close(
        y, tspmm.stencil_flat_ext_ref(bf, offs, x_ext, halo, 3), rtol=0, atol=0)


def test_wrapper_checks_shapes(ela_small):
    bf, offs, x_ext, halo, _ = _operands(ela_small, 3, 2, np.float32, seed=4)
    with pytest.raises(ValueError, match="columns"):
        tspmm.stencil_flat_ext(bf, offs, x_ext[:, 1:], halo, 3)
    with pytest.raises(ValueError, match="rows"):
        tspmm.stencil_flat_ext(bf[1:], offs, x_ext, halo, 3)
    with pytest.raises(ValueError, match="halo"):
        tspmm.stencil_flat_ext(bf, offs, x_ext[:, 2:-2], halo - 2, 3)


def test_scan_oracle_matches_flat(ela_small):
    bf, offs, x_ext, halo, x = _operands(ela_small, 3, 3, np.float64, seed=5)
    blocks_t = bf.reshape(len(offs), 3, 3, -1)
    x_ext4 = tfmt.panel_from_flat_kmajor(x_ext, 3)
    y4 = tspmm.stencil_scan_accumulate(blocks_t, offs, x_ext4, halo)
    y_j = jspmm.stencil_scan_accumulate(jnp.asarray(blocks_t.numpy()), offs,
                                        jnp.asarray(x_ext4.numpy()), halo)
    np.testing.assert_allclose(y4.numpy(), np.asarray(y_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tfmt.panel_from_lane_major(y4).numpy(), ela_small @ x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("t", [1, 2])
def test_df_product_matches_jax_and_f64(ela_small, t):
    """hi + lo of the compensated product within 1e-12 (relative to |B|·|x|)
    of the f64 product of the same f32 inputs, on both sides."""
    bf, offs, x_ext, halo, _ = _operands(ela_small, 3, t, np.float32, seed=20 + t)
    blocks_t = bf.reshape(len(offs), 3, 3, -1)
    x_ext4 = tfmt.panel_from_flat_kmajor(x_ext, 3).contiguous()
    hi, lo = tspmm.stencil_scan_accumulate_df(blocks_t, offs, x_ext4, halo)
    assert hi.dtype == torch.float32 and lo.dtype == torch.float32
    exact = tspmm.stencil_scan_accumulate(blocks_t.double(), offs, x_ext4.double(),
                                          halo).numpy()
    scale = tspmm.stencil_scan_accumulate(blocks_t.abs().double(), offs,
                                          x_ext4.abs().double(), halo).numpy()
    got = hi.double().numpy() + lo.double().numpy()
    assert np.all(np.abs(got - exact) <= 1e-12 * scale.max())
    jh, jl = jspmm.stencil_scan_accumulate_df(
        jnp.asarray(blocks_t.numpy()), offs, jnp.asarray(x_ext4.numpy()), halo)
    assert np.asarray(jh).dtype == np.float32
    got_j = np.asarray(jh).astype(np.float64) + np.asarray(jl).astype(np.float64)
    # the JAX version on the CPU loses the error-free transforms to FMA
    # contraction (XLA:CPU), so it is held to plain-f32 accuracy only
    assert np.all(np.abs(got_j - exact) <= 1e-6 * scale.max())
    np.testing.assert_allclose(hi.numpy(), np.asarray(jh),
                               rtol=0, atol=1e-6 * scale.max())
