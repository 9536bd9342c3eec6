"""The port's measurement scripts on the CPU at small sizes (f64, the plain
versions of the kernels), against the JAX package's scripts and scipy:

* ``examples/bench_fmt_auto.py --scale 0.05``: the four classes, the same
  matrices as the JAX script's generator from the same seed (bitwise), the
  chosen format equal to JAX's ``detect_format`` on them, every format's
  product within 1e-10 (relative) of scipy's;
* ``examples/bench_spmm_general.py --npts 3000``: the generator bitwise
  JAX's, both general products (and the stencil's) within 1e-10 of
  scipy's, the JSON keys;
* ``examples/measure_halo_overlap.py --ranks 2`` at elasticity3d(4³): the
  full step's product, gathered, equal to the one-rank product within
  1e-12, three positive times;
* every script's default device is the card: without one it raises.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from prealps_tpu.ops.formats import detect_format as jax_detect_format
from prealps_tpu_torch.examples import (
    bench_fmt_auto,
    bench_spmm_general,
    deflation_study_f64,
    measure_halo_overlap,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_TOL = 1e-10


def _jax_script(name):
    """The JAX package's ``examples/<name>.py`` as a module (its main not
    run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_fmt_auto_classes_match_jax(capsys):
    rc = bench_fmt_auto.main(["--scale", "0.05", "--device", "cpu", "--reps", "1"])
    head, *recs, last = _records(capsys.readouterr().out)
    assert head["card"] == "cpu" and last["metric"] == "fmt_auto_worst_ratio"
    assert rc == (0 if last["pass"] else 1)
    mats = _jax_script("bench_fmt_auto").make_matrices(0.05, np.random.default_rng(0))
    ours = bench_fmt_auto.make_matrices(0.05, np.random.default_rng(0))
    assert [r["metric"] for r in recs] == [f"fmt_auto_{k}" for k in mats]
    for rec, (name, a) in zip(recs, mats.items()):
        assert (a != ours[name]).nnz == 0 and a.dtype == ours[name].dtype
        assert rec["chosen"] == jax_detect_format(a, br=3)[0], name
        assert rec["dtype"] == "float64" and rec["n"] == a.shape[0]
        assert set(rec["per_format_ms"]) == set(rec["per_format_relerr"])
        assert {"block_ell_morton", "ell"} <= set(rec["per_format_ms"])
        assert all(e <= F64_TOL for e in rec["per_format_relerr"].values()), rec
        assert rec["auto_vs_best"] >= 1.0 and rec["auto_ms"] > 0
    assert "stencil" in recs[0]["per_format_ms"] and "dia" in recs[1]["per_format_ms"]


def test_spmm_general_products(capsys):
    assert bench_spmm_general.main(["--npts", "3000", "--stencil-nel", "4",
                                    "--device", "cpu", "--reps", "1"]) == 0
    head, dia, bell, stencil, ratio = _records(capsys.readouterr().out)
    assert head == {"card": "cpu", "npts": 3000, "t": 12}
    a_j = _jax_script("bench_spmm_general").random_geometric_spd(3000)
    a = bench_spmm_general.random_geometric_spd(3000)
    assert (a != a_j).nnz == 0
    assert [r["metric"] for r in (dia, bell, stencil)] == [
        "spmm_general_geometric_dia_ell", "spmm_general_geometric_blockell_morton",
        "spmm_stencil_headline"]
    for rec in (dia, bell, stencil):
        assert rec["relerr"] <= F64_TOL and rec["ms"] > 0 and rec["gnnz_per_s"] > 0
        assert rec["platform"] == "cpu"
    assert dia["nnz"] == bell["nnz"] == a.nnz and dia["ndiag"] > 0
    assert set(ratio["stencil_over_general"]) == {dia["metric"], bell["metric"]}


def test_halo_overlap_full_step_is_the_one_rank_product(capsys):
    assert measure_halo_overlap.main(["--ranks", "2", "--nel", "4", "--steps", "3",
                                      "--device", "cpu"]) == 0
    (rec,) = _records(capsys.readouterr().out)
    assert rec["ranks"] == 2 and rec["dtype"] == "float64" and not rec["shared_card"]
    assert rec["full_vs_single_relerr"] <= 1e-12
    assert rec["full_ms"] > 0 and rec["compute_ms"] > 0 and rec["halo_ms"] > 0
    assert rec["halo"] <= rec["nrb_local"] and np.isfinite(rec["overlap_efficiency"])


@pytest.mark.parametrize("script", [bench_fmt_auto, bench_spmm_general,
                                    measure_halo_overlap, deflation_study_f64])
def test_default_device_needs_a_card(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        script.main([])
