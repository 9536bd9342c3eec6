"""B4 (``stencil_spmm_planar``) on the CPU, where it runs its plain version
``stencil_spmm_planar_ref``, against the JAX Pallas kernel in interpret
mode and the JAX plain reference; ``stencil_blocks_planar`` bitwise.

Operators: a random NON-symmetric br = 3 block table with five offsets
(so a swapped plane / component index shows), the heterogeneous
elasticity stencil padded to whole 128-node chunks (as the JAX package's
own test), and the Poisson stencil (br = 1). The JAX kernel needs
chunk | nrb and chunk ≥ halo: chunk 128. Held to |y_port − y_jax| ≤
tol · max(|B|·|x|), tol 1e-12 in f64 and 1e-5 in f32.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prealps_tpu.core.generators import elasticity3d, poisson3d
from prealps_tpu.core.layout import contiguous_row_layout, permute_and_pad_matrix
from prealps_tpu.ops import spmm as jspmm
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}
CHUNK = 128


@functools.lru_cache(maxsize=None)
def _operator(kind, dtype):
    if kind == "random":
        offsets, br, nrb = (-9, -1, 0, 1, 9), 3, 256
        blocks_t = np.random.default_rng(5).standard_normal(
            (len(offsets), br, br, nrb)).astype(dtype)
        return blocks_t, offsets, br
    br = 3 if kind == "elasticity" else 1
    a = (elasticity3d(6, 6, 6, heterogeneous=True) if kind == "elasticity"
         else poisson3d(8, 8, 6))
    lay = contiguous_row_layout(a.shape[0], 1, row_multiple=br * CHUNK)
    st = tfmt.csr_to_stencil_bsr_t(permute_and_pad_matrix(a, lay), br=br,
                                   dtype=dtype)
    return st.blocks_t.numpy(), st.offsets, br


CASES = ([("random", t, dt) for t in (1, 4, 12) for dt in (np.float64, np.float32)]
         + [("elasticity", 1, np.float64), ("elasticity", 4, np.float32),
            ("poisson", 12, np.float64), ("poisson", 5, np.float32)])


@pytest.mark.parametrize("kind,t,dtype", CASES)
def test_b4_matches_jax_pallas_interpret(kind, t, dtype):
    blocks_t, offsets, br = _operator(kind, dtype)
    nrb = blocks_t.shape[-1]
    b3 = tspmm.stencil_blocks_planar(torch.from_numpy(blocks_t))
    b3_j = jspmm.stencil_blocks_planar(jnp.asarray(blocks_t))
    np.testing.assert_array_equal(b3.numpy(), np.asarray(b3_j))
    x2 = np.random.default_rng(t).standard_normal((t, br * nrb)).astype(dtype)
    before = tspmm.stencil_spmm_planar.launches
    y = tspmm.stencil_spmm_planar(b3.contiguous(), torch.from_numpy(x2),
                                  offsets=offsets, br=br, nrb=nrb).numpy()
    assert tspmm.stencil_spmm_planar.launches == before     # plain route
    scale = tspmm.stencil_spmm_planar_ref(b3.abs(), torch.from_numpy(np.abs(x2)),
                                          offsets=offsets, br=br, nrb=nrb).numpy()
    tol = TOL[dtype] * scale.max()
    y_pal = np.asarray(jspmm.stencil_spmm_planar(
        b3_j, jnp.asarray(x2), offsets=offsets, br=br, nrb=nrb, chunk=CHUNK,
        interpret=True))
    y_ref = np.asarray(jspmm.stencil_spmm_planar_ref(
        b3_j, jnp.asarray(x2), offsets=offsets, br=br, nrb=nrb))
    assert y.shape == y_pal.shape == (t, br * nrb)
    assert np.all(np.abs(y - y_pal) <= tol)
    assert np.all(np.abs(y - y_ref) <= tol)


def test_b4_plane_major_index():
    """Each output plane m reads row s·br + k of its own plane: a table with
    one nonzero entry (m, k) = (2, 0) at offset 0 maps input plane 0 to
    output plane 2 and nothing else."""
    br, nrb, offsets = 3, 16, (-1, 0, 1)
    blocks_t = torch.zeros((3, br, br, nrb), dtype=torch.float64)
    blocks_t[1, 2, 0] = 1.0
    b3 = tspmm.stencil_blocks_planar(blocks_t).contiguous()
    x2 = torch.arange(br * nrb, dtype=torch.float64)[None]
    y = tspmm.stencil_spmm_planar(b3, x2, offsets=offsets, br=br, nrb=nrb)
    expect = torch.zeros_like(x2)
    expect[0, 2 * nrb:] = x2[0, :nrb]
    assert torch.equal(y, expect)
