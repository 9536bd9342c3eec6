"""The sharded driver's host layer in the port against the JAX package's,
bitwise: the k-way partition, the multi-shard row layout and the ELL halo
plan.

The port copies the JAX package's Python partitioner. The JAX package runs
its native C++ partitioner instead where that is built, and the two give
other parts (on elasticity3d(6,6,6) at k = 4, 30 % of the rows agree), so
every JAX call here runs with ``PREALPS_TPU_NO_NATIVE=1``, which
``prealps_tpu/core/partition.py::_use_native`` reads on every call.
"""

import numpy as np
import pytest
import torch

from prealps_tpu.core import generators as jgen
from prealps_tpu.core import layout as jlay
from prealps_tpu.core import partition as jpart
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops import formats as jfmt
from prealps_tpu_torch.core import layout as tlay
from prealps_tpu_torch.core import partition as tpart

torch.set_num_threads(1)

PROBLEMS = {
    "ela6": lambda: jgen.elasticity3d(6, 6, 6),
    "ela_thin": lambda: jgen.elasticity3d(6, 6, 2),
    "poisson": lambda: jgen.poisson3d(9, 8, 7),
}


@pytest.fixture(autouse=True)
def _python_partitioner(monkeypatch):
    monkeypatch.setenv("PREALPS_TPU_NO_NATIVE", "1")


def _scaled(name):
    return sym_rac_scaling(PROBLEMS[name]())[0]


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("name", ["ela6", "poisson"])
def test_kway_partition_equal(name, k):
    a = _scaled(name)
    pt = tpart.kway_partition(a, k)
    pj = jpart.kway_partition(a, k)
    np.testing.assert_array_equal(pt, pj)
    assert pt.dtype == np.int64 and set(np.unique(pt)) == set(range(k))


def test_kway_partition_helpers_equal():
    """The BFS levels, the pseudo-peripheral vertex and one bisection on a
    masked subgraph."""
    a = _scaled("ela6")
    adj = tpart._adjacency(a)
    mask = np.zeros(a.shape[0], dtype=bool)
    mask[::2] = True
    mask[: a.shape[0] // 2] = True
    np.testing.assert_array_equal(tpart._bfs_levels(adj, 3, mask),
                                  jpart._bfs_levels(adj, 3, mask))
    assert tpart._pseudo_peripheral(adj, mask) == jpart._pseudo_peripheral(adj, mask)
    verts = np.flatnonzero(mask)
    for got, want in zip(tpart._bisect(adj, verts, 4), jpart._bisect(adj, verts, 4)):
        np.testing.assert_array_equal(got, want)


def test_kway_partition_one_part():
    a = _scaled("poisson")
    np.testing.assert_array_equal(tpart.kway_partition(a, 1),
                                  np.zeros(a.shape[0], dtype=np.int64))


@pytest.mark.parametrize("row_multiple", [8, 24])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("name", ["ela6", "poisson"])
def test_build_row_layout_equal(name, k, row_multiple):
    a = _scaled(name)
    lt = tlay.build_row_layout(a, k, row_multiple=row_multiple)
    lj = jlay.build_row_layout(a, k, row_multiple=row_multiple)
    assert (lt.n, lt.n_pad, lt.nshards, lt.rows_per_shard, lt.deps) == (
        lj.n, lj.n_pad, lj.nshards, lj.rows_per_shard, lj.deps)
    for f in ("perm", "inv_perm", "offsets"):
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_contiguous_row_layout_equal(k):
    """The stencil path's layout over several shards (all padding at the
    global tail): unchanged, and still the JAX package's."""
    a = _scaled("ela_thin")
    lt = tlay.contiguous_row_layout(a.shape[0], k, row_multiple=24)
    lj = jlay.contiguous_row_layout(a.shape[0], k, row_multiple=24)
    assert (lt.n_pad, lt.rows_per_shard, lt.deps) == (lj.n_pad, lj.rows_per_shard, lj.deps)
    for f in ("perm", "inv_perm", "offsets"):
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))


def _ell_of_layout(a, layout_mod, k, row_multiple=8):
    lay = layout_mod.build_row_layout(a, k, row_multiple=row_multiple)
    ell = jfmt.csr_to_ell(jlay.permute_and_pad_matrix(a, lay))
    return lay, np.asarray(ell.cols), np.asarray(ell.vals)


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("name", ["ela6", "poisson"])
def test_build_halo_plan_equal(name, k):
    """Every field of the plan, on the ELL structure of the k-way layout."""
    a = _scaled(name)
    lay_j, cols, vals = _ell_of_layout(a, jlay, k)
    lay_t = tlay.build_row_layout(a, k)
    pt = tlay.build_halo_plan(lay_t, cols, vals)
    pj = jlay.build_halo_plan(lay_j, cols, vals)
    assert (pt.h, pt.comm_rows, pt.halo_rows_per_shard) == (
        pj.h, pj.comm_rows, pj.halo_rows_per_shard)
    for f in ("send_idx", "cols_local"):
        got, want = getattr(pt, f), getattr(pj, f)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_halo_plan_reproduces_the_product():
    """The plan's local product (own rows ∥ received rows) gives the global
    ELL product on every shard, in numpy."""
    a = _scaled("ela6")
    k = 3
    lay, cols, vals = _ell_of_layout(a, jlay, k)
    plan = tlay.build_halo_plan(tlay.build_row_layout(a, k), cols, vals)
    x = np.random.default_rng(0).standard_normal((lay.n_pad, 2))
    y_glob = np.einsum("nl,nlt->nt", vals, x[cols])
    mpl = lay.rows_per_shard
    xs = x.reshape(k, mpl, 2)
    for s in range(k):
        recv = np.stack([xs[q][plan.send_idx[q, s]] for q in range(k)])
        x_ext = np.concatenate([xs[s], recv.reshape(-1, 2)])
        rows = slice(s * mpl, (s + 1) * mpl)
        y = np.einsum("nl,nlt->nt", vals[rows], x_ext[plan.cols_local[rows]])
        np.testing.assert_allclose(y, y_glob[rows], rtol=1e-13, atol=1e-13)
