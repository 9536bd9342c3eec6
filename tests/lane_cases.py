"""Shared cases of the lane-major stencil SpMM parity tests
(tests/test_torch_lane_{spmm,b2a,b2b}.py): the port's stencil_bsr_spmm_t,
B2a and B2b on the CPU against the JAX package.

Same numpy operators and panels on both sides, panels of width
t ∈ {1, 8, 12, 20} in f64 and f32: a random br = 3 stencil with five
offsets (the Pallas kernels' interpret mode traces S·br² products per call,
so the full grid of shapes runs on a short stencil; the wrap-halo product
is defined for any blocks), the Poisson stencil (br = 1, S = 7), and the
LORASC path's elasticity stencil (br = 3, S = 27) at t = 12. The port's
CPU route is the kernels' plain version (``stencil_scan_accumulate``); the
JAX side runs its XLA scan (``stencil_bsr_spmm_t``) and its Pallas kernels
in interpret mode. Held to |y_port − y_jax| ≤ tol · max(|B|·|x|) with tol
1e-12 in f64 and 1e-5 in f32 (the two sides sum the same products in
another association order).
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

from prealps_tpu.core.generators import elasticity3d as j_elasticity3d
from prealps_tpu.core.generators import poisson3d as j_poisson3d
from prealps_tpu.ops.formats import StencilBsrTMatrix as JStencilBsrTMatrix
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def lane_operator(kind, dtype):
    if kind == "random":
        offsets, nrb = (-9, -1, 0, 1, 9), 36
        blocks = np.random.default_rng(3).standard_normal((len(offsets), 3, 3, nrb))
        st = tfmt.StencilBsrTMatrix(torch.from_numpy(blocks.astype(dtype)),
                                    offsets, (3 * nrb, 3 * nrb))
    else:
        a = j_elasticity3d(4, 3, 3) if kind == "elasticity" else j_poisson3d(7, 6, 5)
        st = tfmt.csr_to_stencil_bsr_t(a, br=3 if kind == "elasticity" else 1,
                                       dtype=dtype)
    return st, max(abs(o) for o in st.offsets)


def panel(t, br, nrb, dtype, seed):
    return np.random.default_rng(seed).standard_normal((t, br, nrb)).astype(dtype)


def assert_close(y, ref, scale, dtype):
    assert y.shape == ref.shape
    assert np.all(np.abs(y - ref) <= TOL[dtype] * scale.max())


CASES = ([(kind, t, dt) for kind in ("poisson", "random") for t in (1, 8, 12, 20)
          for dt in (np.float64, np.float32)]
         + [("elasticity", 12, np.float32)])


@functools.lru_cache(maxsize=None)
def lane_setup(kind, t, dtype):
    st, halo = lane_operator(kind, dtype)
    blocks = st.blocks_t.numpy()
    br = blocks.shape[1]
    x = panel(t, br, blocks.shape[-1], dtype, seed=10 * br + t)
    x_ext = np.concatenate([x[:, :, -halo:], x, x[:, :, :halo]], axis=2)
    scale = tspmm.stencil_scan_accumulate(
        st.blocks_t.abs(), st.offsets, torch.from_numpy(np.abs(x_ext)), halo).numpy()
    ja = JStencilBsrTMatrix(blocks_t=jnp.asarray(blocks), offsets=st.offsets,
                            shape=st.shape)
    return st, halo, blocks, x, x_ext, scale, ja


