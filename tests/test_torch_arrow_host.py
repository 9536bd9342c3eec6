"""The distributed LORASC's host half against the JAX package, bitwise.

* ``core/partition.py``: ``block_arrow_structure`` (the k-way partition
  and the greedy vertex separator; the port's lazy max-heap picks the
  vertex the JAX argsort loop picks) and ``permute`` on elasticity3d(6,5,5),
  (6,6,6) and poisson3d(9,8,7) at k = 2, 4, 8.
* ``direct/banded.py``: ``plan_block_banded``, ``assemble_host`` and
  ``to_band`` / ``from_band`` on the interiors of a block-arrow split.
* ``parallel/lorasc_driver.py::lorasc_host_plan``: every host array of the
  JAX ``DistributedLorascECG`` build (its ``_operands`` but the device
  factors and the Ritz basis, and the arrow and row maps) at nshards 4 with
  the exact Schur complement, with forced deflation and a banded separator
  (``agg_dense_max=64``), and over a (4, 2) mesh.

The JAX side runs its Python algorithms (``PREALPS_TPU_NO_NATIVE=1``).
"""

import numpy as np
import pytest

from prealps_tpu.core import partition as jp
from prealps_tpu.core.generators import elasticity3d, poisson3d
from prealps_tpu.direct import banded as jb
from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG as JaxLorasc
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.core import partition as tp
from prealps_tpu_torch.direct import banded as tb
from prealps_tpu_torch.parallel.lorasc_driver import lorasc_host_plan

MATRICES = {"ela655": lambda: elasticity3d(6, 5, 5),
            "ela666": lambda: elasticity3d(6, 6, 6),
            "poi987": lambda: poisson3d(9, 8, 7)}


@pytest.fixture(autouse=True)
def python_partition(monkeypatch):
    monkeypatch.setenv("PREALPS_TPU_NO_NATIVE", "1")


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_block_arrow_and_permute_bitwise(name, k):
    a = MATRICES[name]()
    t, j = tp.block_arrow_structure(a, k), jp.block_arrow_structure(a, k)
    for f in ("perm", "interior_offsets", "part"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == getattr(j, f).dtype
    assert (t.sep_start, t.n, t.nparts, t.sep_size) == (j.sep_start, j.n, j.nparts,
                                                         j.sep_size)
    pt, pj = tp.permute(a, t.perm), jp.permute(a, j.perm)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))


@pytest.mark.parametrize("order,bs_multiple", [("rcm", 8), ("rcm", 24), ("natural", 8)])
def test_band_plan_assembly_and_maps_bitwise(order, bs_multiple):
    a = elasticity3d(6, 6, 6)
    arrow = jp.block_arrow_structure(a, 4)
    ap, off = jp.permute(a, arrow.perm), arrow.interior_offsets
    blocks = [ap[off[s]:off[s + 1], off[s]:off[s + 1]] for s in range(4)]
    pt = tb.plan_block_banded(blocks, order=order, bs_multiple=bs_multiple)
    pj = jb.plan_block_banded(blocks, order=order, bs_multiple=bs_multiple)
    assert (pt.nparts, pt.nblk, pt.bs, pt.bandwidth, pt.rows_padded) == (
        pj.nparts, pj.nblk, pj.bs, pj.bandwidth, pj.rows_padded)
    for f in ("perm", "inv_perm", "sizes"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    for dtype in (np.float64, np.float32):
        dt, et = tb.assemble_host(pt, blocks, dtype=dtype)
        dj, ej = jb.assemble_host(pj, blocks, dtype=dtype)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(et, ej)
        assert dt.dtype == dj.dtype == dtype
    d2, e2 = tb.assemble_host(pt, blocks, parts=[2, 0])
    d4, e4 = tb.assemble_host(pt, blocks)
    np.testing.assert_array_equal(d2, d4[[2, 0]])
    np.testing.assert_array_equal(e2, e4[[2, 0]])
    rng = np.random.default_rng(0)
    parts = [rng.standard_normal((int(m), 3)) for m in pt.sizes]
    vt, vj = tb.to_band(pt, parts), jb.to_band(pj, parts)
    np.testing.assert_array_equal(vt, vj)
    for ot, oj, v in zip(tb.from_band(pt, vt), jb.from_band(pj, vj), parts):
        np.testing.assert_array_equal(ot, oj)
        np.testing.assert_array_equal(ot, v)


CASES = {
    "schur4": dict(nshards=4),
    "deflation4_banded": dict(nshards=4, exact_schur=False, agg_dense_max=64),
    "mesh42": dict(mesh_shape=(4, 2), max_deflation=16),
}
HOST_OPERANDS = ("ell_vals", "ell_cols", "band_perm", "band_inv", "int_mask",
                 "sep_slice_mask", "agi_vals", "agi_cols", "aig_vals", "aig_cols",
                 "agg_ell_v", "agg_ell_c", "agg_inv", "aband_perm", "aband_inv",
                 "sep_real_mask")


@pytest.fixture(scope="module")
def jax_builds():
    """The JAX builds of each case (f64, elasticity3d(6,5,5))."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PREALPS_TPU_NO_NATIVE", "1")
        a = elasticity3d(6, 5, 5)
        opts = JaxOptions(t=2, tol=1e-8, maxiter=600)
        return a, {name: JaxLorasc.build(a, opts=opts, dtype=np.float64, **kw)
                   for name, kw in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_plan_is_the_jax_build_bitwise(jax_builds, case):
    a, builds = jax_builds
    sj = builds[case]
    kw = CASES[case]
    g_n, l_n = kw.get("mesh_shape", (kw.get("nshards"), 1))
    plan = lorasc_host_plan(a, g_n, l_n, np.float64,
                            exact_schur=kw.get("exact_schur"),
                            agg_dense_max=kw.get("agg_dense_max", 4096))
    ops_j = sj._operands[0]
    compared = 0
    for name in HOST_OPERANDS:
        assert (name in plan) == (name in ops_j), name
        if name in plan:
            want = np.asarray(ops_j[name])
            np.testing.assert_array_equal(plan[name], want, err_msg=name)
            assert plan[name].dtype == want.dtype, name
            compared += 1
    assert compared == (15 if plan["agg_banded"] else 13)
    for name in ("arrow_perm", "row_of", "scale_d"):
        np.testing.assert_array_equal(plan[name], getattr(sj, name))
    assert (plan["ni_max"], plan["ng_max"], plan["n"]) == (sj.ni_max, sj.ng_max, sj.n)
    assert plan["agg_banded"] == (case == "deflation4_banded")
    assert plan["exact_schur"] == (case != "deflation4_banded")
    if plan["agg_banded"]:
        assert plan["agg_d"].shape[1:3] == np.asarray(ops_j["agg_fac"].l_inv).shape[1:3]
    fac = ops_j["fac"]
    assert plan["d"].shape == np.asarray(fac.l_inv).shape


def test_host_plan_assembles_the_asked_groups():
    a = elasticity3d(6, 5, 5)
    full = lorasc_host_plan(a, 4)
    mine = lorasc_host_plan(a, 4, groups=[3])
    np.testing.assert_array_equal(mine["d"], full["d"][3:4])
    np.testing.assert_array_equal(mine["e"], full["e"][3:4])
    assert full["d"].shape[0] == 4
