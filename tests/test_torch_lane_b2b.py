"""B2b (``stencil_pallas_bs_ext``) on the CPU, where it runs its plain
version, against the JAX Pallas kernel in interpret mode (cases and
tolerances in tests/lane_cases.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prealps_tpu.ops import spmm as jspmm
from prealps_tpu_torch.ops import spmm as tspmm
from tests.lane_cases import CASES, assert_close, lane_setup

torch.set_num_threads(1)


@pytest.mark.parametrize("kind,t,dtype", CASES)
def test_b2b_matches_jax_pallas_interpret(kind, t, dtype):
    st, halo, blocks, _, x_ext, scale, _ = lane_setup(kind, t, dtype)
    before = tspmm.stencil_pallas_bs_ext.launches
    y = tspmm.stencil_pallas_bs_ext(torch.from_numpy(blocks), st.offsets,
                                    torch.from_numpy(x_ext), halo).numpy()
    assert tspmm.stencil_pallas_bs_ext.launches == before  # plain route
    ref = np.asarray(jspmm.stencil_pallas_bs_ext(
        jnp.asarray(blocks), st.offsets, jnp.asarray(x_ext), halo, interpret=True))
    assert_close(y, ref, scale, dtype)
