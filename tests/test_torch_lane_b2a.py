"""B2a (``stencil_bsr_spmm_t_pallas_bs``) on the CPU, where it runs its
plain version, against the JAX Pallas kernel in interpret mode (cases and
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
def test_b2a_matches_jax_pallas_interpret(kind, t, dtype):
    st, _, _, x, _, scale, ja = lane_setup(kind, t, dtype)
    before = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
    y = tspmm.stencil_bsr_spmm_t_pallas_bs(st, torch.from_numpy(x)).numpy()
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches == before  # plain route
    ref = np.asarray(jspmm.stencil_bsr_spmm_t_pallas_bs(ja, jnp.asarray(x),
                                                        interpret=True))
    assert_close(y, ref, scale, dtype)
