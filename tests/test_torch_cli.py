"""The port's command line (``python -m prealps_tpu_torch.cli``) against the
JAX package's (prealps_tpu/cli.py), on the CPU (``--device cpu``, f64).

* ``ecg`` (DistributedECG with block Jacobi; fmt auto and ell, a .mtx file)
  and ``lorasc`` (ECGSolver with LORASC direct and Lanczos, PRESC ssloc and
  saloc): the same JSON keys as JAX's line, iterations within ±1, relres
  below 100 × tol;
* the rhs and solution files (tests/test_smoke.py:165-215): a saved
  solution solves the loaded rhs;
* the error exits of both packages' CLIs, and the port-only ones: several
  shards outside a group, ``bench`` (no port benchmark yet), an absent
  card.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from prealps_tpu import cli as jcli
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.io import load_vector, save_mtx, save_vector
from prealps_tpu_torch import cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N655 = 3 * 7 * 6 * 5           # elasticity3d(6,5,5)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _both(capsys, command, argv):
    """(port record, JAX record) of one command line."""
    rc_j = getattr(jcli, f"{command}_main")(argv)
    rec_j = _last_json(capsys.readouterr().out)
    rc = cli.main([command, *argv, "--device", "cpu"])
    rec = _last_json(capsys.readouterr().out)
    assert rc in (0, None) and rc_j in (0, None)
    return rec, rec_j


def _same(rec, rec_j, tol):
    if "refine_rounds" not in rec_j and rec.get("refine_rounds") == 0:
        # the port's DistributedLorascECG reports its 0 rounds without
        # refinement (tests/test_torch_dlorasc.py); JAX leaves the key out
        rec = {k: v for k, v in rec.items() if k != "refine_rounds"}
    assert set(rec) == set(rec_j)
    assert abs(rec["iters"] - rec_j["iters"]) <= 1
    assert rec["relres"] < 100 * tol
    for k in ("n", "nnz", "bs", "breakdown", "refine_rounds", "fmt_chosen"):
        assert rec.get(k) == rec_j.get(k), k


CASES = {
    "ecg_auto": ("ecg", ["--size", "6x5x5", "-e", "2", "-t", "1e-6"]),
    "ecg_ell": ("ecg", ["--size", "6x5x5", "-e", "4", "--fmt", "ell", "-t", "1e-8"]),
    "lorasc": ("lorasc", ["--size", "6x5x5", "--nparts", "4", "-t", "1e-8"]),
    "lorasc_lanczos": ("lorasc", ["--size", "6x5x5", "--nparts", "4",
                                  "--eig-method", "lanczos", "-t", "1e-8"]),
    "presc": ("lorasc", ["-p", "presc", "--size", "6x5x5", "--nparts", "4", "-t", "1e-8"]),
    "presc_saloc": ("lorasc", ["-p", "presc", "--eigs-kind", "saloc", "--size",
                               "6x5x5", "--nparts", "4", "-t", "1e-8"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax(capsys, case):
    command, argv = CASES[case]
    rec, rec_j = _both(capsys, command, [*argv, "--json"])
    _same(rec, rec_j, float(argv[argv.index("-t") + 1]))


def test_matrix_rhs_and_solution_files(capsys, tmp_path):
    a = elasticity3d(6, 5, 5)
    mtx, rhs, sol = tmp_path / "a.mtx", tmp_path / "rhs.txt", tmp_path / "sol.txt"
    save_mtx(str(mtx), a)
    b = np.random.default_rng(7).standard_normal(N655)
    save_vector(str(rhs), b)
    argv = ["-m", str(mtx), "-e", "2", "-t", "1e-6", "--rhs", str(rhs), "--json"]
    rec, rec_j = _both(capsys, "ecg", [*argv, "--save-sol", str(sol)])
    _same(rec, rec_j, 1e-6)
    x = load_vector(str(sol))
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-4


def test_verbose_prints_history(capsys):
    rc = cli.main(["lorasc", "--size", "4x4x4", "--nparts", "4", "-t", "1e-6", "-v",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Iteration:" in out and "relres" in out


ERRORS = {
    "rhs_length": ("ecg", ["--size", "6x5x5", "--rhs", "{short}"]),
    "missing_matrix": ("ecg", ["-m", "{tmp}/none.mtx"]),
    "bad_size": ("lorasc", ["--size", "6by5"]),
    "deflate_small_path": ("lorasc", ["--size", "4x4x4", "--correction", "deflate"]),
    "partition_not_scalable": ("lorasc", ["--size", "4x4x4", "--partition-file",
                                          "{short}"]),
    "bj2l_poisson": ("ecg", ["--generate", "poisson", "--size", "4x4x4",
                             "--precond", "bj2l"]),
    "np_level1_divides": ("lorasc", ["--size", "4x4x4", "--nshards", "4",
                                     "--np-level1", "3"]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_exits(tmp_path, case):
    short = tmp_path / "short.txt"
    save_vector(str(short), np.ones(10))
    command, argv = ERRORS[case]
    argv = [v.format(short=short, tmp=tmp_path) for v in argv]
    with pytest.raises(SystemExit) as err_j:
        getattr(jcli, f"{command}_main")(argv)
    with pytest.raises(SystemExit) as err:
        cli.main([command, *argv, "--device", "cpu"])
    assert str(err.value).startswith("error:") or err.value.code == 2
    assert type(err.value.code) is type(err_j.value.code)


def test_port_only_exits(capsys):
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["lorasc", "--size", "4x4x4", "--nshards", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 2"):
        cli.main(["bench"])
    assert cli.main([]) == 2 and "usage" in capsys.readouterr().err


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    proc = subprocess.run([sys.executable, "-m", "prealps_tpu_torch.cli", "lorasc",
                           "--size", "3x3x3", "--nparts", "2"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
