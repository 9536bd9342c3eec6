"""The port's user scripts on the CPU at small sizes (gloo ranks):

* ``examples/weak_scaling.py`` over 2 ranks: one JSON row, the ablated
  solve (``PREALPS_TIMING_NO_COLLECTIVES`` set inside the ranks) timed
  beside the real one, and the knob not left set in the parent;
* ``examples/demo_large_separator.py`` at elasticity3d(6³) over 2 ranks:
  the distributed LORASC converges (relres < 1e-4);
* ``examples/multihost_launch.py --nproc 4``: four processes joined with
  ``init_group(init_method="env://")``, a (2, 2) mesh, each rank's true
  residual < 1e-7;
* every script's default device is the card: without one it raises.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from prealps_tpu_torch.examples import demo_large_separator, multihost_launch, weak_scaling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_weak_scaling_rows(capsys):
    from prealps_tpu_torch.core.generators import elasticity3d

    assert weak_scaling.main(["--device", "cpu", "--shards", "2", "--base-nel", "3",
                              "--t", "4", "--maxiter", "6", "--timeout", "120"]) == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert row["nshards"] == 2 and row["n"] == elasticity3d(3, 3, 6).shape[0]
    assert row["iters"] == 6 and row["dtype"] == "float64" and not row["shared_card"]
    assert row["iter_ms"] > 0 and row["iter_nocoll_ms"] > 0
    assert 0.0 <= row["comm_frac"] < 1.0 and 1 <= row["iters_nocoll"] <= 6
    assert "PREALPS_TIMING_NO_COLLECTIVES" not in os.environ


def test_demo_large_separator(capsys):
    assert demo_large_separator.main(["6", "2", "--device", "cpu",
                                      "--timeout", "120"]) == 0
    out = capsys.readouterr().out
    assert "built: n=" in out and "solved: iters=" in out


def test_multihost_launch():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "prealps_tpu_torch.examples.multihost_launch",
         "--nproc", "4", "--device", "cpu", "--timeout", "120"],
        capture_output=True, text=True, timeout=180, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("true_relres=") == 4 and "ALL_OK" in proc.stdout


@pytest.mark.parametrize("main", [weak_scaling.main, demo_large_separator.main])
def test_default_device_needs_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main([])


def test_multihost_default_device_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="cuda"):
        multihost_launch.main([])
