"""The general path's host layer in the port against the JAX package's, exactly.

ELL and block-ELL conversion, the even split and RCM ordering, the
partition row layout and the host block-Jacobi build are numpy/scipy copies
in the port; they must give the same arrays bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from prealps_tpu.core import generators as jgen
from prealps_tpu.core import layout as jlay
from prealps_tpu.core import partition as jpart
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops import formats as jfmt
from prealps_tpu.precond import block_jacobi as jbj
from prealps_tpu_torch.core import layout as tlay
from prealps_tpu_torch.core import partition as tpart
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.precond import block_jacobi as tbj

torch.set_num_threads(1)


def _random_spd(n, seed):
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, density=0.05, random_state=rng, format="csr")
    return sp.csr_matrix(m + m.T + sp.eye(n) * n)


PROBLEMS = {
    "ela5": lambda: jgen.elasticity3d(5, 4, 4),
    "poisson": lambda: jgen.poisson3d(7, 6, 5),
    "random": lambda: _random_spd(203, 1),
}


def _scaled(name):
    return sym_rac_scaling(PROBLEMS[name]())[0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_ell_conversion_equal(name, dtype):
    a = _scaled(name)
    et = tfmt.csr_to_ell(a, dtype=dtype)
    ej = jfmt.csr_to_ell(a, dtype=dtype)
    assert et.shape == ej.shape
    np.testing.assert_array_equal(et.vals.numpy(), np.asarray(ej.vals))
    np.testing.assert_array_equal(et.cols.numpy(), np.asarray(ej.cols))
    assert et.cols.dtype == torch.int32 and et.vals.numpy().dtype == dtype


@pytest.mark.parametrize("bk", [8, 128])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_block_ell_conversion_equal(name, bk):
    a = _scaled(name)
    bt = tfmt.csr_to_block_ell(a, bm=8, bk=bk, dtype=np.float32)
    bj = jfmt.csr_to_block_ell(a, bm=8, bk=bk, dtype=np.float32)
    assert bt.shape == bj.shape and (bt.bm, bt.bk) == (8, bk)
    np.testing.assert_array_equal(bt.blocks.numpy(), np.asarray(bj.blocks))
    np.testing.assert_array_equal(bt.blkcols.numpy(), np.asarray(bj.blkcols))
    assert bt.blkcols.dtype == torch.int32


@pytest.mark.parametrize("n,k", [(10, 3), (147968, 617), (7, 7), (5, 1)])
def test_nsplit_equal(n, k):
    np.testing.assert_array_equal(tpart.nsplit(n, k), jpart.nsplit(n, k))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_rcm_order_equal(name):
    a = _scaled(name)
    np.testing.assert_array_equal(tpart.rcm_order(a[:60, :60]),
                                  jpart.rcm_order(a[:60, :60]))


@pytest.mark.parametrize("row_multiple", [8, 128])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_row_layout_equal(name, row_multiple):
    a = _scaled(name)
    lt = tlay.build_row_layout(a, 1, row_multiple=row_multiple)
    lj = jlay.build_row_layout(a, 1, row_multiple=row_multiple)
    assert (lt.n, lt.n_pad, lt.nshards, lt.rows_per_shard, lt.deps) == (
        lj.n, lj.n_pad, lj.nshards, lj.rows_per_shard, lj.deps)
    for f in ("perm", "inv_perm", "offsets"):
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))
    pt, pj = tlay.permute_and_pad_matrix(a, lt), jlay.permute_and_pad_matrix(a, lj)
    np.testing.assert_array_equal(pt.indptr, pj.indptr)
    np.testing.assert_array_equal(pt.indices, pj.indices)
    np.testing.assert_array_equal(pt.data, pj.data)


def test_layout_from_part_equal():
    """Several parts (a pinned partition): same permutation, padding and
    dependency sets."""
    a = _scaled("random")
    part = np.random.default_rng(2).integers(0, 3, a.shape[0])
    lt = tlay.layout_from_part(a, part, 3, row_multiple=8)
    lj = jlay.layout_from_part(a, part, 3, row_multiple=8)
    assert (lt.n_pad, lt.rows_per_shard, lt.deps) == (lj.n_pad, lj.rows_per_shard, lj.deps)
    for f in ("perm", "inv_perm", "offsets"):
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))


def test_row_layout_refuses_several_shards():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlay.build_row_layout(_scaled("poisson"), 2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["ela5", "random"])
def test_block_jacobi_build_equal(name, dtype):
    """Same RCM-ordered blocks, the same f64 factors cast to dtype (inverse
    mode for f32, Cholesky for f64), the same index maps."""
    a = _scaled(name)
    factors, gather_idx, inv_perm, mode = tbj.block_jacobi_host(
        a, nblocks=5, dtype=dtype)
    ref = jbj.build_block_jacobi(a, nblocks=5, dtype=dtype)
    assert mode == ref.mode == ("inverse" if dtype == np.float32 else "cholesky")
    np.testing.assert_array_equal(factors, np.asarray(ref.factors))
    np.testing.assert_array_equal(gather_idx, np.asarray(ref.gather_idx))
    np.testing.assert_array_equal(inv_perm, np.asarray(ref.inv_perm))
    bt = tbj.build_block_jacobi(a, block_size=40, dtype=dtype)
    np.testing.assert_array_equal(
        bt.factors.numpy(),
        np.asarray(jbj.build_block_jacobi(a, block_size=40, dtype=dtype).factors))
