"""The block-ELL kernel's operand: the blocks' nonzero entries, packed once
per operator (``formats.pack_block_ell_entries``), and their plain product
(``spmm.block_ell_entries_spmm``) against the JAX package.

* The pack round-trips: scattering the entries back gives ``mat.blocks``
  exactly; zeros are dropped; ``row_ptr`` is monotone; each row's columns
  are in slot order (s, then k), which is ascending column.
* On a 4-shard ``_block_ell_shard`` build (k-way layout,
  ``PREALPS_TPU_NO_NATIVE=1``) the columns are the shard's [own ∥ halo]
  coordinates: the entries' product on a random extended panel is JAX's
  ``block_ell_spmm`` of the same shard's blocks (the JAX block halo plan's
  ``blkcols_local``) to 1e-12 in f64.
* ``block_ell_entries_spmm`` against JAX's ``block_ell_spmm`` (XLA) and
  ``block_ell_spmm_pallas(interpret=True)``, bk ∈ {8, 128}, t ∈ {1, 12}:
  within 1e-5·max(|B|·|x|) in f32 (each sums in its own order), and 1e-12
  in f64 against XLA (the Pallas kernel accumulates in f32 whatever its
  input type).
* ``fmt="block_ell"`` builds carry the entries: the port's own build on
  the CPU and one through ``interop.solver_from_reference``;
  ``fmt="block_ell_xla"`` (the plain product) does not pack.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import build_block_halo_plan as jax_plan
from prealps_tpu.core.layout import build_row_layout as jax_layout
from prealps_tpu.core.layout import permute_and_pad_matrix as jax_pad
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops import formats as jfmt
from prealps_tpu.ops import spmm as jspmm
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.core.layout import build_row_layout, permute_and_pad_matrix
from prealps_tpu_torch.interop import solver_from_reference
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm
from prealps_tpu_torch.parallel.driver import DistributedECG, _block_ell_shard
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

BUILD = dict(nshards=1, precond="bj", block_size=96)


@pytest.fixture(scope="module")
def operator():
    return sym_rac_scaling(elasticity3d(6, 5, 5))[0]


def _x(rows, t, dtype, seed):
    return np.random.default_rng(seed).standard_normal((rows, t)).astype(dtype)


def _unpack(e, mat):
    """The entries scattered back into (nrb, S, bm, bk) blocks."""
    nrb, s_max, bm, bk = mat.blocks.shape
    counts = torch.diff(e.row_ptr.long())
    rows = torch.repeat_interleave(torch.arange(nrb * bm), counts)
    cols = e.cols.long()
    # the slot of each entry: where its column block sits in its row block's list
    blk = mat.blkcols.long()[rows // bm]                       # (nnz, S)
    slot = torch.argmax((blk == (cols // bk)[:, None]).int(), dim=1)
    out = torch.zeros_like(mat.blocks)
    out[rows // bm, slot, rows % bm, cols % bk] = e.vals
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bk", [8, 128])
def test_pack_round_trips(operator, bk, dtype):
    mat = tfmt.csr_to_block_ell(operator, bm=8, bk=bk, dtype=dtype)
    e = tfmt.pack_block_ell_entries(mat)
    assert e.row_ptr.dtype == e.cols.dtype == torch.int32
    assert e.vals.dtype == mat.blocks.dtype
    assert e.row_ptr.shape == (mat.shape[0] + 1,) and int(e.row_ptr[0]) == 0
    assert int(e.row_ptr[-1]) == e.nnz == int((mat.blocks != 0).sum())
    assert bool((torch.diff(e.row_ptr) >= 0).all())
    assert bool((e.vals != 0).all())                            # zeros dropped
    torch.testing.assert_close(_unpack(e, mat), mat.blocks, rtol=0, atol=0)
    # each row's columns ascend (slot order, s then k)
    counts = torch.diff(e.row_ptr.long())
    same_row = torch.repeat_interleave(torch.arange(mat.shape[0]), counts)
    step = torch.diff(e.cols.long())
    assert bool((step[same_row[1:] == same_row[:-1]] > 0).all())
    # the entries are the operator's nonzero values, row by row
    a = operator.tocsr(copy=True)
    a.eliminate_zeros()
    a.sort_indices()
    np.testing.assert_array_equal(np.diff(e.row_ptr.numpy())[:a.shape[0]], np.diff(a.indptr))
    np.testing.assert_array_equal(e.cols.numpy(), a.indices)
    np.testing.assert_array_equal(e.vals.numpy(), a.data.astype(dtype))


@pytest.fixture(scope="module")
def shards(operator):
    """The port's 4 shards of the block-ELL build and JAX's blkcols_local."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        lay = build_row_layout(operator, 4, row_multiple=128)
        lay_j = jax_layout(operator, 4, row_multiple=128)
    a_pad = permute_and_pad_matrix(operator, lay)
    mats = [_block_ell_shard(a_pad, lay, r, 128, np.float64, "cpu")[0] for r in range(4)]
    bell_j = jfmt.csr_to_block_ell(jax_pad(operator, lay_j), bm=8, bk=128)
    plan_j = jax_plan(lay_j, np.asarray(bell_j.blkcols), np.asarray(bell_j.blocks), 128)
    return lay, mats, np.asarray(bell_j.blocks), plan_j.blkcols_local


@pytest.mark.parametrize("rank", range(4))
def test_pack_on_a_shard_halo_space(shards, rank):
    lay, mats, blocks_j, blkcols_j = shards
    mat = mats[rank]
    e = tfmt.pack_block_ell_entries(mat)
    mpl = lay.rows_per_shard
    assert e.row_ptr.shape == (mpl + 1,) and mat.shape[1] > mpl
    assert 0 <= int(e.cols.min()) and int(e.cols.max()) < mat.shape[1]
    torch.testing.assert_close(_unpack(e, mat), mat.blocks, rtol=0, atol=0)
    rows = slice(rank * mpl // 8, (rank + 1) * mpl // 8)
    mj = jfmt.BlockEllMatrix(jnp.asarray(blocks_j[rows]), jnp.asarray(blkcols_j[rows]),
                             tuple(mat.shape))
    x = _x(mat.shape[1], 5, np.float64, seed=rank)
    y = tspmm.block_ell_entries_spmm(e, torch.from_numpy(x)).numpy()
    y_j = np.asarray(jspmm.block_ell_spmm(mj, jnp.asarray(x)))
    np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-12 * np.abs(y_j).max())
    if rank == 1:
        assert int(e.cols.max()) >= mpl          # halo columns referenced


@pytest.mark.parametrize("t", [1, 12])
@pytest.mark.parametrize("bk", [8, 128])
def test_entries_product_matches_jax_f32(operator, bk, t):
    mt = tfmt.csr_to_block_ell(operator, bm=8, bk=bk, dtype=np.float32)
    mj = jfmt.csr_to_block_ell(operator, bm=8, bk=bk, dtype=np.float32)
    x = _x(mt.shape[1], t, np.float32, seed=bk + t)
    y = tspmm.block_ell_entries_spmm(tfmt.pack_block_ell_entries(mt),
                                     torch.from_numpy(x)).numpy()
    scale = tspmm.block_ell_spmm(
        tfmt.BlockEllMatrix(mt.blocks.abs(), mt.blkcols, mt.shape),
        torch.from_numpy(np.abs(x))).numpy()
    bound = 1e-5 * scale.max()
    for y_j in (jspmm.block_ell_spmm(mj, jnp.asarray(x)),
                jspmm.block_ell_spmm_pallas(mj, jnp.asarray(x), interpret=True)):
        y_j = np.asarray(y_j)
        assert y.dtype == y_j.dtype == np.float32 and y.shape == y_j.shape
        assert np.abs(y - y_j).max() <= bound


@pytest.mark.parametrize("t", [1, 12])
@pytest.mark.parametrize("bk", [8, 128])
def test_entries_product_matches_xla_f64(operator, bk, t):
    mt = tfmt.csr_to_block_ell(operator, bm=8, bk=bk, dtype=np.float64)
    mj = jfmt.csr_to_block_ell(operator, bm=8, bk=bk, dtype=np.float64)
    x = _x(mt.shape[1], t, np.float64, seed=bk + t)
    y = tspmm.block_ell_entries_spmm(tfmt.pack_block_ell_entries(mt),
                                     torch.from_numpy(x)).numpy()
    y_j = np.asarray(jspmm.block_ell_spmm(mj, jnp.asarray(x)))
    np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-12 * np.abs(y_j).max())
    n = operator.shape[0]
    np.testing.assert_allclose(y[:n], operator @ x[:n], rtol=1e-12,
                               atol=1e-12 * np.abs(y).max())


def _opts(cls):
    return cls(t=4, tol=1e-8, maxiter=2000, variant="odir_fused", layout="nt")


def _check_entries(mat):
    e = mat.entries
    assert e is not None and e.row_ptr.shape == (mat.shape[0] + 1,)
    torch.testing.assert_close(_unpack(e, mat), mat.blocks, rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["block_ell", "block_ell_xla"])
def test_block_ell_build_carries_entries(fmt):
    a = elasticity3d(5, 5, 4)
    s = DistributedECG.build(a, fmt=fmt, opts=_opts(ECGOptions), dtype=np.float64,
                             device="cpu", **BUILD)
    if fmt == "block_ell":
        _check_entries(s.operands.mat)
    else:
        assert s.operands.mat.entries is None     # the plain product reads blocks


def test_solver_from_reference_carries_entries():
    a = elasticity3d(5, 5, 4)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    sj = JaxECG.build(a, fmt="block_ell_xla", opts=_opts(JaxOptions), dtype=np.float64,
                      **BUILD)
    (blocks, blkcols), (factors, gather_idx, inv_perm) = sj._operands
    lay = sj.layout
    arrays = dict(scale_d=sj.scale_d, perm=lay.perm, inv_perm=lay.inv_perm,
                  layout_offsets=lay.offsets, a_scaled=sj.a_scaled,
                  bj_factors=np.asarray(factors), bj_gather_idx=np.asarray(gather_idx),
                  bj_inv_perm=np.asarray(inv_perm), bell_blocks=np.asarray(blocks),
                  bell_blkcols=np.asarray(blkcols))
    meta = dict(fmt="block_ell", n=lay.n, n_pad=lay.n_pad,
                rows_per_shard=lay.rows_per_shard, opts=dataclasses.asdict(sj.opts),
                target_tol=sj.target_tol, bj_mode="cholesky", ncols_pad=lay.n_pad)
    s = solver_from_reference(arrays, meta, device="cpu")
    _check_entries(s.operands.mat)
    x, info = s.solve(b)
    x_j, info_j = sj.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
