"""The port's lane-major stencil SpMM on the CPU against the JAX package:
``stencil_bsr_spmm_t`` against the JAX XLA scan, and the wrappers' checks.
The cases and tolerances are in tests/lane_cases.py; B2a and B2b against
the JAX Pallas kernels in interpret mode are in
tests/test_torch_lane_{b2a,b2b}.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prealps_tpu.ops import spmm as jspmm
from prealps_tpu_torch.ops import spmm as tspmm
from tests.lane_cases import CASES, assert_close, lane_operator, lane_setup, panel

torch.set_num_threads(1)


@pytest.mark.parametrize("kind,t,dtype", CASES)
def test_stencil_bsr_spmm_t_matches_jax_scan(kind, t, dtype):
    st, _, _, x, _, scale, ja = lane_setup(kind, t, dtype)
    y = tspmm.stencil_bsr_spmm_t(st, torch.from_numpy(x)).numpy()
    ref = np.asarray(jspmm.stencil_bsr_spmm_t(ja, jnp.asarray(x)))
    assert y.dtype == dtype
    assert_close(y, ref, scale, dtype)


def test_b2a_takes_non_contiguous_panels_through_the_entry_point():
    """stencil_bsr_spmm_t makes its panel contiguous; the result equals the
    product of the contiguous copy."""
    st, _ = lane_operator("elasticity", np.float64)
    nrb = st.blocks_t.shape[-1]
    xt = torch.from_numpy(panel(5, 3, nrb, np.float64, seed=1))
    x_nc = xt.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    assert not x_nc.is_contiguous()
    np.testing.assert_array_equal(tspmm.stencil_bsr_spmm_t(st, x_nc).numpy(),
                                  tspmm.stencil_bsr_spmm_t(st, xt).numpy())


@pytest.mark.parametrize("bad", ["halo", "width", "offsets", "rank"])
def test_lane_wrappers_refuse_bad_shapes(bad):
    st, halo = lane_operator("elasticity", np.float64)
    nrb = st.blocks_t.shape[-1]
    x = torch.from_numpy(panel(2, 3, nrb, np.float64, seed=2))
    x_ext = tspmm.extend_wrap(x, halo)
    with pytest.raises(ValueError):
        if bad == "halo":        # an offset reaches past the halo
            tspmm.stencil_pallas_bs_ext(st.blocks_t, st.offsets,
                                        tspmm.extend_wrap(x, halo - 1), halo - 1)
        elif bad == "width":     # panel width is not nrb + 2·halo
            tspmm.stencil_pallas_bs_ext(st.blocks_t, st.offsets, x_ext[..., 1:], halo)
        elif bad == "offsets":   # blocks and offsets disagree
            tspmm.stencil_pallas_bs_ext(st.blocks_t, st.offsets[:-1], x_ext, halo)
        else:
            tspmm.stencil_bsr_spmm_t_pallas_bs(st, x[0])
