"""Pinned partitions (``parts=``) and a caller's row layout (``layout=``)
in the driver, against the JAX driver (prealps_tpu/parallel/driver.py:
112, 123-128, 265-294):

* the JAX driver's ValueErrors: no ``parts=`` with fmt="stencil", not
  both ``parts=`` and ``layout=``, the partition's length and its part ids
  (one shard: all zeros);
* a pinned one-shard partition (all zeros) and a caller's layout solve as
  the JAX driver does: equal iteration counts (±1), x within 1e-8
  relative in f64; ``layout=`` gives the default build's x exactly;
* fmt="auto" with ``parts=`` considers neither the stencil nor a
  reordering, in both packages;
* a layout over several shards needs as many shards (and a process group
  of as many ranks: tests/test_torch_sharded_*.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.layout import build_row_layout as jax_build_row_layout
from prealps_tpu.parallel.driver import DistributedECG as JaxECG
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.core.layout import build_row_layout, contiguous_row_layout
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(5, 5, 5, heterogeneous=True)
    return a, np.random.default_rng(6).standard_normal(a.shape[0])


def _opts(cls, layout="nt"):
    return cls(t=4, tol=1e-8, maxiter=3000, variant="odir_fused", layout=layout)


def _build_both(a, **kw):
    """The JAX and the port build's outcome: the solver or the ValueError."""
    out = []
    for build, opts, extra in ((JaxECG.build, _opts(JaxOptions), {}),
                               (DistributedECG.build, _opts(ECGOptions),
                                dict(device="cpu"))):
        try:
            out.append(build(a, nshards=1, opts=opts, dtype=np.float64, **kw,
                             **extra))
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("case", ["stencil", "both", "length", "range"])
def test_invalid_partitions_raise_like_jax(problem, case):
    a, _ = problem
    n = a.shape[0]
    parts = np.zeros(n, dtype=np.int64)
    kw = dict(fmt="ell", precond="bj", parts=parts)
    if case == "stencil":
        kw["fmt"] = "stencil"
    elif case == "length":
        kw["parts"] = parts[:-1]
    elif case == "range":
        kw["parts"] = np.where(np.arange(n) % 7 == 0, 1, 0)
    lay_j = jax_build_row_layout(a, 1) if case == "both" else None
    lay_t = build_row_layout(a, 1) if case == "both" else None
    errs = []
    for build, opts, extra, lay in (
            (JaxECG.build, _opts(JaxOptions), {}, lay_j),
            (DistributedECG.build, _opts(ECGOptions), dict(device="cpu"), lay_t)):
        with pytest.raises(ValueError) as e:
            build(a, nshards=1, opts=opts, dtype=np.float64, layout=lay, **kw,
                  **extra)
        errs.append(str(e.value))
    match = {"stencil": "fmt='stencil'", "both": "either parts= or layout=",
             "length": "entries for a", "range": "part ids must lie in"}[case]
    assert all(match in m for m in errs), errs
    assert errs[0] == errs[1]


@pytest.mark.parametrize("fmt,layout", [("ell", "nt"), ("block_ell", "nt"),
                                        ("dia", "nt"), ("dia", "tbn")])
def test_pinned_partition_solves_like_jax(problem, fmt, layout):
    a, b = problem
    kw = dict(fmt=fmt, precond="bj", block_size=30, parts=np.zeros(a.shape[0]))
    jax_fmt = "block_ell_xla" if fmt == "block_ell" else fmt
    sj = JaxECG.build(a, nshards=1, opts=_opts(JaxOptions, layout), dtype=np.float64,
                      **dict(kw, fmt=jax_fmt))
    s = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions, layout),
                             dtype=np.float64, device="cpu", **kw)
    assert s.layout.n_pad == sj.layout.n_pad
    np.testing.assert_array_equal(s.layout.perm, sj.layout.perm)
    x_j, info_j = sj.solve(b)
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)


def test_caller_layout_is_the_layout(problem):
    a, b = problem
    kw = dict(fmt="ell", precond="bj", block_size=30, dtype=np.float64, device="cpu")
    lay = build_row_layout(a, 1, row_multiple=16)
    s = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions), layout=lay, **kw)
    assert s.layout is lay
    x, info = s.solve(b)
    s0 = DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions), **kw)
    assert s0.layout.n_pad == lay.n_pad           # 544 rows either way
    np.testing.assert_array_equal(x, s0.solve(b)[0])
    sj = JaxECG.build(a, nshards=1, opts=_opts(JaxOptions), dtype=np.float64,
                      fmt="ell", precond="bj", block_size=30,
                      layout=jax_build_row_layout(a, 1, row_multiple=16))
    x_j, info_j = sj.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
    wide = dataclasses.replace(contiguous_row_layout(a.shape[0], 2), nshards=2)
    with pytest.raises(ValueError, match="layout has 2 shards"):
        DistributedECG.build(a, nshards=1, opts=_opts(ECGOptions), layout=wide, **kw)


def test_auto_with_parts_keeps_the_row_order(problem):
    """With a pinned partition fmt="auto" may neither pick the stencil nor
    permute rows: both packages choose the same general format."""
    a, b = problem
    sj, s = _build_both(a, fmt="auto", precond="bj", block_size=30,
                        parts=np.zeros(a.shape[0]))
    assert s.fmt_info["chosen"] == sj.fmt_info["chosen"]
    assert s.fmt_info["chosen"] not in ("stencil", "dia_rcm", "block_ell_morton")
    assert s.pre_perm is None and sj.pre_perm is None
    x_j, info_j = sj.solve(b)
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1
    assert np.linalg.norm(x - x_j) <= 1e-8 * np.linalg.norm(x_j)
