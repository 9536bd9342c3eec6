"""The SpMM format sweep (``python -m prealps_tpu_torch.examples.bench_spmm``)
on the CPU, where the kernels' wrappers run their plain versions, in f64.

At --nel 3 --t 1,4: one JSON line per (format, t) with the keys of the
JAX sweep (examples/bench_spmm.py), and every format's y = A x equal to the
scipy product of the same scaled operator to 1e-12 · max(|A|·|x|).
"""

import json

import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu_torch.examples import bench_spmm

torch.set_num_threads(1)

JAX_KEYS = {"format", "t", "n", "nnz", "ms", "gnnz_per_s", "platform"}


def test_main_prints_the_jax_sweeps_lines(capsys):
    bench_spmm.main(["--nel", "3", "--t", "1,4", "--reps", "1", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["format"], r["t"]) for r in lines] == [
        (f, t) for t in (1, 4) for f in bench_spmm.FORMATS]
    a, _ = sym_rac_scaling(elasticity3d(3, 3, 3))
    for rec in lines:
        assert set(rec) == JAX_KEYS
        assert (rec["n"], rec["nnz"], rec["platform"]) == (a.shape[0], a.nnz, "cpu")
        assert rec["ms"] > 0 and rec["gnnz_per_s"] > 0


@pytest.mark.parametrize("t", [1, 4])
def test_every_format_agrees_with_scipy(t):
    a, _ = sym_rac_scaling(elasticity3d(3, 3, 3))
    b3 = bench_spmm.stencil_bsr_spmm_t_pallas.launches
    seen = set()
    for rec, x, y in bench_spmm.sweep(nel=3, ts=(t,), reps=1, device="cpu"):
        xn = x.numpy()
        assert xn.dtype == np.float64 and y.shape == xn.shape
        ref = a @ xn
        assert np.all(np.abs(y.numpy() - ref) <= 1e-12 * (abs(a) @ np.abs(xn)).max())
        seen.add(rec["format"])
    assert seen == set(bench_spmm.FORMATS)
    assert bench_spmm.stencil_bsr_spmm_t_pallas.launches == b3   # plain route


def test_unknown_format_is_refused():
    with pytest.raises(SystemExit):
        bench_spmm.main(["--formats", "csr", "--device", "cpu"])
