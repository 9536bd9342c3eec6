"""The plain reference check, and what the benchmark's modules import."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import scipy.sparse as sp

from benchmark.references import relres

ROOT = Path(__file__).resolve().parents[2]


def test_residual_of_a_known_solution():
    rng = np.random.default_rng(7)
    m = rng.standard_normal((12, 12))
    a = sp.csr_matrix(m @ m.T + 12 * np.eye(12))
    x = rng.standard_normal(12)
    b = a @ x
    d = relres.equilibration(a)
    assert np.allclose(d, 1 / np.sqrt(np.abs(a.toarray()).max(axis=1)))
    exact = relres.residuals(a, d, b, x)
    assert exact["relres"] < 1e-14 and exact["relres_scaled"] < 1e-14
    e = np.zeros(12)
    e[3] = 1e-3
    off = relres.residuals(a, d, b, x + e)
    want = np.linalg.norm(a @ e) / np.linalg.norm(b)
    assert abs(off["relres"] - want) < 1e-12 * want + 1e-15
    want_s = np.linalg.norm(d * (a @ e)) / np.linalg.norm(d * b)
    assert abs(off["relres_scaled"] - want_s) < 1e-12 * want_s + 1e-15


def test_non_finite_or_misshapen_answers_read_infinitely_wrong():
    a = sp.identity(3, format="csr")
    d = relres.equilibration(a)
    b = np.ones(3)
    assert relres.residuals(a, d, b, np.array([1.0, np.nan, 1.0]))["relres"] == np.inf
    assert relres.residuals(a, d, b, np.ones(2))["relres"] == np.inf


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    loaded = _modules_after(
        "from benchmark.references import relres\n"
        "from benchmark import roofline, trace, problems\n"
        "from benchmark.problems import elasticity3d\n")
    assert not loaded & {"prealps_tpu_torch", "prealps_tpu", "jax", "jaxlib", "torch"}
