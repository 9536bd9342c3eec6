"""B3 (``stencil_bsr_spmm_t_pallas``) on the CPU, where it runs its plain
version, against the JAX package (cases and tolerances in
tests/lane_cases.py).

In f32 the reference is the JAX Pallas kernel (manual double-buffered DMAs
on the TPU) in interpret mode, with a 64-node chunk so the wider operators
run several grid steps and a zero-padded tail. That kernel carries f32
sums and refuses f64 panels, so in f64 the reference is the JAX package's
XLA form of the same function, ``stencil_bsr_spmm_t``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prealps_tpu.ops import spmm as jspmm
from prealps_tpu_torch.ops import spmm as tspmm
from tests.lane_cases import CASES, assert_close, lane_setup

torch.set_num_threads(1)


@pytest.mark.parametrize("kind,t,dtype", CASES)
def test_b3_matches_jax(kind, t, dtype):
    st, _, _, x, _, scale, ja = lane_setup(kind, t, dtype)
    before = tspmm.stencil_bsr_spmm_t_pallas.launches
    y = tspmm.stencil_bsr_spmm_t_pallas(st, torch.from_numpy(x)).numpy()
    assert tspmm.stencil_bsr_spmm_t_pallas.launches == before  # plain route
    if dtype == np.float32:
        ref = jspmm.stencil_bsr_spmm_t_pallas(ja, jnp.asarray(x), chunk=64,
                                              interpret=True)
    else:
        ref = jspmm.stencil_bsr_spmm_t(ja, jnp.asarray(x))
    assert_close(y, np.asarray(ref), scale, dtype)
