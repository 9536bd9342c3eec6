"""The port's block-Jacobi applies against the JAX package's.

* ``BlockJacobi.apply`` (host-built, row-major panels) in both modes: f64
  Cholesky factors (two triangular solves) to 1e-12, f32 explicit inverses
  (one batched GEMM) to 1e-5 relative to |M⁻¹|·|z|; on the JAX build's own
  arrays and on the port's.
* ``bj_apply_pallas`` on CPU tensors (its plain version) against the JAX
  kernel in interpret mode, in the shape of the JAX test
  (tests/test_kernels.py::TestBJApplyPallas), and ``pack_bj_dense`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import contiguous_row_layout, permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.direct import device_bj as jdbj
from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
from prealps_tpu.precond import block_jacobi as jbj
from prealps_tpu_torch.core.partition import nsplit
from prealps_tpu_torch.direct import device_bj as tdbj
from prealps_tpu_torch.precond import block_jacobi as tbj

torch.set_num_threads(1)


def _port_from_jax(ref):
    return tbj.BlockJacobi(
        factors=torch.from_numpy(np.array(ref.factors)),
        gather_idx=torch.from_numpy(np.array(ref.gather_idx, dtype=np.int64)),
        inv_perm=torch.from_numpy(np.array(ref.inv_perm, dtype=np.int64)),
        mode=ref.mode)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("t", [1, 4])
def test_block_jacobi_apply_matches(ela_small, dtype, t):
    a = sym_rac_scaling(ela_small)[0]
    ref = jbj.build_block_jacobi(a, nblocks=6, dtype=dtype)
    z = np.random.default_rng(t).standard_normal((a.shape[0], t)).astype(dtype)
    want = np.asarray(ref.apply(jnp.asarray(z)))
    port = tbj.build_block_jacobi(a, nblocks=6, dtype=dtype)
    assert port.mode == ref.mode
    for bj in (_port_from_jax(ref), port):
        got = bj.apply(torch.from_numpy(z)).numpy()
        assert got.dtype == dtype
        if dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        else:
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    # and it inverts the diagonal blocks: A_ii w_i = z_i
    w = port.apply(torch.from_numpy(z)).numpy().astype(np.float64)
    off = nsplit(a.shape[0], 6)
    for r0, r1 in zip(off[:-1], off[1:]):
        r = a[r0:r1, r0:r1] @ w[r0:r1] - z[r0:r1]
        assert np.abs(r).max() <= (1e-10 if dtype == np.float64 else 1e-3)


def test_block_jacobi_sentinel_rows_stay_zero():
    """Blocks of unequal size pad with identity rows fed from the sentinel
    zero row: the padded positions never leak into the result."""
    a = sym_rac_scaling(elasticity3d(4, 4, 3))[0]
    bj = tbj.build_block_jacobi(a, nblocks=7, dtype=np.float64)
    m = a.shape[0]
    assert int((bj.gather_idx == m).sum()) > 0
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((m, 2)))
    w = bj.apply(z)
    assert w.shape == (m, 2) and bool(torch.isfinite(w).all())


@pytest.mark.parametrize("t", [4, 12])
def test_bj_apply_pallas_plain_matches_jax_interpret(t):
    a = elasticity3d(6, 5, 5)
    mbn, br = 24, 3
    lay = contiguous_row_layout(a.shape[0], 1, row_multiple=mbn * br)
    sb = csr_to_stencil_bsr_t(permute_and_pad_matrix(a, lay), br=br, dtype=np.float32)
    inv5 = jdbj.build_device_block_jacobi(sb.blocks_t, sb.offsets, mbn=mbn)
    nrb = sb.blocks_t.shape[-1]
    z = np.random.default_rng(42).standard_normal((t, br, nrb)).astype(np.float32)
    b2_j = jdbj.pack_bj_dense(inv5)
    want = np.asarray(jdbj.bj_apply_pallas(b2_j, jnp.asarray(z), br=br, interpret=True))
    inv_t = torch.from_numpy(np.array(inv5))
    b2_t = tdbj.pack_bj_dense(inv_t)
    np.testing.assert_array_equal(b2_t.numpy(), np.asarray(b2_j))
    assert b2_t.shape[1] % 128 == 0
    np.testing.assert_array_equal(
        tdbj.pack_bj_dense(inv_t.reshape(inv_t.shape[0], br * mbn, br * mbn)).numpy(),
        b2_t.numpy())
    before = tdbj.bj_apply_pallas.launches
    got = tdbj.bj_apply_pallas(b2_t, torch.from_numpy(z), br).numpy()
    assert tdbj.bj_apply_pallas.launches == before            # CPU: no launch
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    flat = tdbj.bj_apply_flat(inv_t.reshape(-1, br * mbn, br * mbn),
                              torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, flat, rtol=2e-5, atol=2e-5)


def test_bj_apply_pallas_checks_shapes():
    b2 = torch.zeros((4, 128, 128))
    with pytest.raises(ValueError, match="fit"):
        tdbj.bj_apply_pallas(b2, torch.zeros((2, 3, 4 * 50)), 3)
    with pytest.raises(ValueError, match="fit"):
        tdbj.bj_apply_pallas(b2, torch.zeros((2, 2, 4 * 30)), 3)
