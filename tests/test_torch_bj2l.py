"""The port's device block Jacobi and two-level preconditioner against the
JAX package's, on the same numpy inputs, in f64 (rtol 1e-10: the inverses
go through batched Cholesky on both sides, in different LAPACK orders)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import contiguous_row_layout, pad_to_padded, permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.direct import device_bj as jbj
from prealps_tpu.ops.formats import csr_to_stencil_bsr_t
from prealps_tpu.precond import twolevel as jtwo
from prealps_tpu_torch.direct import device_bj as tbj
from prealps_tpu_torch.parallel.driver import coarse_inverse_host
from prealps_tpu_torch.precond import twolevel as ttwo

torch.set_num_threads(1)
RTOL = 1e-10


@pytest.fixture(scope="module", params=[8, 16])
def operator(request):
    """Scaled, padded elasticity3d(5,5,4) stencil with mbn-node blocks."""
    mbn = request.param
    br = 3
    a, d = sym_rac_scaling(elasticity3d(5, 5, 4))
    lay = contiguous_row_layout(a.shape[0], 1,
                                row_multiple=math.lcm(math.lcm(8, br), mbn * br))
    a_pad = permute_and_pad_matrix(a, lay)
    st = csr_to_stencil_bsr_t(a_pad, br=br, dtype=np.float64)
    blocks_t = np.array(st.blocks_t)
    nrb = blocks_t.shape[-1]
    y5 = jtwo.geometric_rbm_modes((6, 6, 4), br, nrb, mbn,
                                  scale_d=pad_to_padded(lay, d), q=6)
    return dict(a_pad=a_pad, blocks_t=blocks_t, offsets=st.offsets, mbn=mbn,
                br=br, nrb=nrb, y5=y5)


def test_dense_blocks_equal(operator):
    o = operator
    d_t = tbj.dense_blocks_from_stencil(torch.from_numpy(o["blocks_t"]),
                                        o["offsets"], o["mbn"])
    d_j = jbj.dense_blocks_from_stencil(jnp.asarray(o["blocks_t"]), o["offsets"],
                                        o["mbn"])
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    # the blocks are the diagonal blocks of A (component-major inside)
    nb, mb = d_t.shape[0], o["br"] * o["mbn"]
    blk = d_t.reshape(nb, o["br"], o["mbn"], o["br"], o["mbn"])[1]
    nat = blk.permute(1, 0, 3, 2).reshape(mb, mb).numpy()
    np.testing.assert_array_equal(nat, o["a_pad"][mb:2 * mb, mb:2 * mb].toarray())


def test_batched_inverse_and_flat_build(operator):
    o = operator
    dense = jbj.dense_blocks_from_stencil(jnp.asarray(o["blocks_t"]), o["offsets"],
                                          o["mbn"])
    inv_t = tbj.batched_spd_inverse(torch.from_numpy(np.array(dense)))
    inv_j = jbj.batched_spd_inverse(dense, method="chol")
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(inv_j)).max()))
    flat_t = tbj.build_device_block_jacobi_flat(
        torch.from_numpy(o["blocks_t"]), o["offsets"], mbn=o["mbn"])
    flat_j = jbj.build_device_block_jacobi_flat(
        jnp.asarray(o["blocks_t"]), o["offsets"], mbn=o["mbn"])
    np.testing.assert_allclose(flat_t.numpy(), np.asarray(flat_j), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(flat_j)).max()))
    with pytest.raises(NotImplementedError):
        tbj.batched_spd_inverse(inv_t, method="newton")


@pytest.mark.parametrize("t", [1, 4])
def test_bj_and_bj2l_apply_equal(operator, t):
    o = operator
    br, nrb, mbn = o["br"], o["nrb"], o["mbn"]
    flat = np.asarray(jbj.build_device_block_jacobi_flat(
        jnp.asarray(o["blocks_t"]), o["offsets"], mbn=mbn))
    nb, mb = flat.shape[0], flat.shape[1]
    y5 = o["y5"]
    ac = jtwo.coarse_matrix_host(o["a_pad"], y5, br)
    ac += 1e-10 * np.trace(ac) / ac.shape[0] * np.eye(ac.shape[0])
    ac_inv = coarse_inverse_host(ac)
    yq3 = np.ascontiguousarray(y5.transpose(0, 3, 1, 2).reshape(nb, -1, mb))
    z = np.random.default_rng(t).standard_normal((t, br, nrb))

    w_t = tbj.bj_apply_flat(torch.from_numpy(flat), torch.from_numpy(z)).numpy()
    w_j = np.asarray(jbj.bj_apply_flat(jnp.asarray(flat), jnp.asarray(z)))
    np.testing.assert_allclose(w_t, w_j, rtol=RTOL, atol=RTOL * np.abs(w_j).max())

    args = [torch.from_numpy(v) for v in (flat, yq3, ac_inv, z)]
    m_t = ttwo.bj2l_apply(*args).numpy()
    m_j = np.asarray(jtwo.bj2l_apply(*(jnp.asarray(v) for v in (flat, yq3, ac_inv, z))))
    np.testing.assert_allclose(m_t, m_j, rtol=RTOL, atol=RTOL * np.abs(m_j).max())
    # the coarse term is really there: bj2l differs from plain BJ
    assert np.abs(m_t - w_t).max() > 1e-6 * np.abs(w_t).max()
