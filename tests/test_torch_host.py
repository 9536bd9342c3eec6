"""The port's host layer against the JAX package's, exactly.

prealps_tpu_torch carries numpy copies of the host functions it needs (the
JAX package cannot be imported without JAX). They must produce the same
arrays bit for bit: generators, RAC scaling, the contiguous layout and its
padding, the stencil conversion, and the bj2l coarse-space builders.
"""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from prealps_tpu.core import generators as jgen
from prealps_tpu.core import layout as jlay
from prealps_tpu.core.scaling import sym_rac_scaling as j_scaling
from prealps_tpu.ops.formats import csr_to_stencil_bsr as j_stencil
from prealps_tpu.ops.formats import csr_to_stencil_bsr_t as j_stencil_t
from prealps_tpu.precond import twolevel as jtwo
from prealps_tpu_torch.core import generators as tgen
from prealps_tpu_torch.core import layout as tlay
from prealps_tpu_torch.core.scaling import sym_rac_scaling as t_scaling
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.precond import twolevel as ttwo

torch.set_num_threads(1)

PROBLEMS = {
    "ela4": lambda g: g.elasticity3d(4, 4, 4),
    "ela5_homog": lambda g: g.elasticity3d(5, 4, 6, heterogeneous=False),
    "ela6_x0": lambda g: g.elasticity3d(6, 5, 5, fixed_face="x0"),
    "poisson": lambda g: g.poisson3d(7, 6, 5),
}
BR = {"ela4": 3, "ela5_homog": 3, "ela6_x0": 3, "poisson": 1}


def _same_csr(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.dtype == b.dtype


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_generators_equal(name):
    _same_csr(PROBLEMS[name](tgen), PROBLEMS[name](jgen))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_scaling_equal(name):
    a = PROBLEMS[name](jgen)
    sa_t, d_t = t_scaling(a)
    sa_j, d_j = j_scaling(a)
    _same_csr(sa_t, sa_j)
    np.testing.assert_array_equal(d_t, d_j)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_layout_and_padding_equal(name):
    a = j_scaling(PROBLEMS[name](jgen))[0]
    br = BR[name]
    mult = math.lcm(math.lcm(8, br), 16 * br)
    lt = tlay.contiguous_row_layout(a.shape[0], 1, row_multiple=mult)
    lj = jlay.contiguous_row_layout(a.shape[0], 1, row_multiple=mult)
    assert (lt.n, lt.n_pad, lt.nshards, lt.rows_per_shard) == (
        lj.n, lj.n_pad, lj.nshards, lj.rows_per_shard)
    for f in ("perm", "inv_perm", "offsets"):
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))
    assert lt.n_pad > lt.n            # the padding path is exercised
    _same_csr(tlay.permute_and_pad_matrix(a, lt), jlay.permute_and_pad_matrix(a, lj))
    v = np.random.default_rng(0).standard_normal((a.shape[0], 2))
    vp = tlay.pad_to_padded(lt, v)
    np.testing.assert_array_equal(vp, jlay.pad_to_padded(lj, v))
    np.testing.assert_array_equal(tlay.unpad_from_padded(lt, vp), v)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_stencil_conversion_equal(name, dtype):
    a = PROBLEMS[name](jgen)
    br = BR[name]
    st = tfmt.csr_to_stencil_bsr(a, br=br, dtype=dtype, device="cpu")
    sj = j_stencil(a, br=br, dtype=dtype)
    assert st.offsets == sj.offsets
    np.testing.assert_array_equal(st.blocks.numpy(), np.asarray(sj.blocks))
    tt = tfmt.csr_to_stencil_bsr_t(a, br=br, dtype=dtype, device="cpu")
    tj = j_stencil_t(a, br=br, dtype=dtype)
    np.testing.assert_array_equal(tt.blocks_t.numpy(), np.asarray(tj.blocks_t))
    assert tt.blocks_t.dtype == (torch.float32 if dtype == np.float32
                                 else torch.float64)


def test_stencil_conversion_rejects_irregular():
    rng = np.random.default_rng(3)
    import scipy.sparse as sp

    m = sp.random(60, 60, density=0.5, random_state=rng) + sp.eye(60)
    assert tfmt.csr_to_stencil_bsr(m, br=3, max_offsets=4) is None
    assert j_stencil(m, br=3, max_offsets=4) is None


def test_panel_layouts_roundtrip():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((30, 4)))
    xt = tfmt.panel_to_lane_major(x, 3)
    assert xt.shape == (4, 3, 10)
    torch.testing.assert_close(tfmt.panel_from_lane_major(xt), x, rtol=0, atol=0)
    xf = tfmt.panel_to_flat_kmajor(xt)
    # row k·t + j = component k of direction j
    torch.testing.assert_close(xf[1 * 4 + 2], xt[2, 1], rtol=0, atol=0)
    torch.testing.assert_close(tfmt.panel_from_flat_kmajor(xf, 3), xt, rtol=0, atol=0)


@pytest.mark.parametrize("mbn", [8, 16])
def test_coarse_space_equal(mbn):
    a, d = j_scaling(jgen.elasticity3d(5, 5, 4))
    br = 3
    mult = math.lcm(math.lcm(8, br), mbn * br)
    lay = jlay.contiguous_row_layout(a.shape[0], 1, row_multiple=mult)
    a_pad = jlay.permute_and_pad_matrix(a, lay)
    d_pad = jlay.pad_to_padded(lay, d)
    nrb = lay.n_pad // br
    y_t = ttwo.geometric_rbm_modes((6, 6, 4), br, nrb, mbn, scale_d=d_pad, q=6)
    y_j = jtwo.geometric_rbm_modes((6, 6, 4), br, nrb, mbn, scale_d=d_pad, q=6)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(ttwo.coarse_matrix_host(a_pad, y_t, br),
                                  jtwo.coarse_matrix_host(a_pad, y_j, br))


def test_port_imports_no_jax():
    """The package and its driver load without JAX (the card's machine has
    none): checked in a fresh interpreter."""
    code = ("import sys; import prealps_tpu_torch, "
            "prealps_tpu_torch.parallel.driver, prealps_tpu_torch.interop; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('prealps_tpu.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
