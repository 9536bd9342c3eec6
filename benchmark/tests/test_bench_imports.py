"""What a run imports, and the command's refusals: no card, or no program
beside the benchmark."""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_ON_CPU = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from benchmark import harness
cell = harness.resolve("ela_ecg12_bj.n811k")
cell["traffic"]["problem"].update(nx=4, ny=4, nz=4)
run = harness.Run(cell, 3, device="cpu", cache_dir=Path({cache!r}))
run.setup()
run.window(0.0)
run.release()
run.check()
print("FORBIDDEN", harness.forbidden_modules())
print("PROGRAM", "prealps_tpu_torch" in sys.modules)
"""


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    out = subprocess.run([sys.executable, "-c", RUN_ON_CPU.format(root=str(ROOT),
                                                                  cache=str(tmp_path))],
                         capture_output=True, text=True, timeout=600, check=True)
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("FORBIDDEN", "PROGRAM")))
    assert lines["FORBIDDEN"] == "[]"
    assert lines["PROGRAM"] == "True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "prealps_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake.sub", sys)
    assert "prealps_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _command(cwd, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ela_ecg12_bj.n811k",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
