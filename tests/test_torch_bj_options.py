"""The device block-Jacobi options against the JAX package's, in f64:

* ``csr_slab_groups`` / ``stencil_slab_groups``: the host copies give the
  same groups, bitwise, at x-line and z-slab blocks, and on a
  heterogeneous operator;
* ``build_device_block_jacobi_grouped`` and ``bj_apply_grouped`` to 1e-12
  relative, against the JAX pair and against the flat apply of the
  per-block inverses;
* ``batched_spd_inverse(method="newton")`` to 1e-10 relative;
* ``bj_apply_lane_major`` on the same bf16 inverses to 1e-5 × max|w|,
  with w in f32.

The driver's solves with these options are in
test_torch_bj_options_driver.py; the grid-free bj2l coarse modes in
test_torch_bj2l_nogrid.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import contiguous_row_layout, permute_and_pad_matrix
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.direct import device_bj as jbj
from prealps_tpu.ops.formats import csr_to_stencil_bsr, csr_to_stencil_bsr_t
from prealps_tpu_torch.direct import device_bj as tbj

torch.set_num_threads(1)
RTOL = 1e-12


def _operator(nel, het=False):
    """Scaled stencil operator of elasticity3d(nel), its host (nrb, S, br,
    br) blocks and the lane-major (S, br, br, nrb) table."""
    a, _ = sym_rac_scaling(elasticity3d(*nel, heterogeneous=het))
    lay = contiguous_row_layout(a.shape[0], 1, row_multiple=3)
    a_pad = permute_and_pad_matrix(a, lay)
    blocks_host = np.asarray(csr_to_stencil_bsr(a_pad, br=3, dtype=np.float64).blocks)
    st = csr_to_stencil_bsr_t(a_pad, br=3, dtype=np.float64)
    return a_pad, blocks_host, np.asarray(st.blocks_t), st.offsets


@pytest.mark.parametrize("nel,mbn,het", [((6, 6, 8), 7, False),
                                         ((6, 6, 8), 49, False),
                                         ((6, 6, 8), 49, True),
                                         ((4, 5, 6), 30, False)])
def test_slab_groups_bitwise(nel, mbn, het):
    a_pad, blocks_host, _, _ = _operator(nel, het)
    got = tbj.csr_slab_groups(a_pad, 3 * mbn)
    assert got == jbj.csr_slab_groups(a_pad, 3 * mbn)
    assert tbj.stencil_slab_groups(blocks_host, mbn) == jbj.stencil_slab_groups(
        blocks_host, mbn)
    nb = blocks_host.shape[0] // mbn
    assert sorted(i for g in got[1] for i in g) == list(range(nb))
    if not het:
        assert len(got[0]) < nb          # interior lines or slabs repeat
    assert tbj.csr_slab_groups(a_pad, a_pad.shape[0] - 3) is None


@pytest.fixture(scope="module")
def grouped():
    a_pad, _, blocks_t, offsets = _operator((6, 6, 8))
    mbn = 7                               # x-line blocks
    rep_idx, groups = jbj.csr_slab_groups(a_pad, 3 * mbn)
    return np.array(blocks_t), offsets, mbn, rep_idx, groups


@pytest.mark.parametrize("t", [1, 4])
def test_grouped_build_and_apply(grouped, t):
    blocks_t, offsets, mbn, rep_idx, groups = grouped
    inv_u = tbj.build_device_block_jacobi_grouped(torch.from_numpy(blocks_t),
                                                  offsets, mbn, rep_idx)
    inv_uj = np.asarray(jbj.build_device_block_jacobi_grouped(
        jnp.asarray(blocks_t), offsets, mbn=mbn, rep_idx=rep_idx))
    assert inv_u.shape == inv_uj.shape == (len(groups), 3, mbn, 3, mbn)
    np.testing.assert_allclose(inv_u.numpy(), inv_uj, rtol=RTOL,
                               atol=RTOL * np.abs(inv_uj).max())
    nrb = blocks_t.shape[-1]
    z = np.random.default_rng(t).standard_normal((t, 3, nrb))
    bg = tbj.block_groups(groups, "cpu")
    w = tbj.bj_apply_grouped(inv_u, bg, torch.from_numpy(z)).numpy()
    w_j = np.asarray(jbj.bj_apply_grouped(jnp.asarray(inv_uj), groups, jnp.asarray(z)))
    np.testing.assert_allclose(w, w_j, rtol=RTOL, atol=RTOL * np.abs(w_j).max())
    # against the flat apply of every block's own inverse
    flat = tbj.build_device_block_jacobi_flat(torch.from_numpy(blocks_t), offsets,
                                              mbn=mbn)
    w_f = tbj.bj_apply_flat(flat, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(w, w_f, rtol=RTOL, atol=RTOL * np.abs(w_f).max())


def test_block_groups_index_tensors(grouped):
    groups = grouped[-1]
    bg = tbj.block_groups(groups, "cpu")
    assert bg.num_groups == len(groups)
    order = bg.order.numpy()
    for g, (s, e) in zip(groups, bg.bounds):
        assert tuple(order[s:e]) == g
    np.testing.assert_array_equal(order[bg.inv_order.numpy()], np.arange(order.size))


@pytest.mark.parametrize("mbn", [8, 16])
def test_newton_inverse_matches_jax(mbn):
    _, _, blocks_t, offsets = _operator((4, 4, 4))
    nrb = blocks_t.shape[-1]
    blocks_t = blocks_t[..., :nrb - nrb % mbn]
    dense = jbj.dense_blocks_from_stencil(jnp.asarray(blocks_t), offsets, mbn)
    inv_j = np.asarray(jbj.batched_spd_inverse(dense, method="newton"))
    inv_t = tbj.batched_spd_inverse(torch.from_numpy(np.array(dense)),
                                    method="newton").numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-10, atol=1e-10 * np.abs(inv_j).max())
    # and it is the inverse the Cholesky route gives
    inv_c = tbj.batched_spd_inverse(torch.from_numpy(np.array(dense))).numpy()
    np.testing.assert_allclose(inv_t, inv_c, rtol=1e-8, atol=1e-8 * np.abs(inv_c).max())
    with pytest.raises(ValueError, match="method"):
        tbj.batched_spd_inverse(torch.from_numpy(np.array(dense)), method="lu")


@pytest.mark.parametrize("t", [1, 12])
def test_bf16_apply_matches_jax(t):
    _, _, blocks_t, offsets = _operator((6, 6, 6))
    mbn = 14
    nrb = blocks_t.shape[-1] - blocks_t.shape[-1] % mbn
    inv5_j = jbj.build_device_block_jacobi(jnp.asarray(blocks_t[..., :nrb]), offsets,
                                           mbn=mbn).astype(jnp.bfloat16)
    inv5 = torch.from_numpy(np.asarray(inv5_j).view(np.uint16).copy()).view(
        torch.bfloat16)
    z = np.random.default_rng(t).standard_normal((t, 3, nrb)).astype(np.float32)
    w = tbj.bj_apply_lane_major(inv5, torch.from_numpy(z))
    w_j = np.asarray(jbj.bj_apply_lane_major(inv5_j, jnp.asarray(z)))
    assert w.dtype == torch.float32 and w_j.dtype == np.float32
    np.testing.assert_allclose(w.numpy(), w_j, rtol=0, atol=1e-5 * np.abs(w_j).max())
    # the split keeps the input's low bits: far closer to the f32 apply of
    # the same (bf16-valued) inverses than a bf16-rounded input would be
    w_f = tbj.bj_apply_lane_major(inv5.float(), torch.from_numpy(z)).numpy()
    z_r = torch.from_numpy(z).to(torch.bfloat16).float()
    w_r = tbj.bj_apply_lane_major(inv5.float(), z_r).numpy()
    err, err_r = np.abs(w.numpy() - w_f).max(), np.abs(w_r - w_f).max()
    assert err < 1e-5 * np.abs(w_f).max() < err_r
