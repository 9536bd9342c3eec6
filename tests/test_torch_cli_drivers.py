"""The port's command line on its other drivers, against the JAX package's
CLI on the CPU (``--device cpu``, f64): ``lorasc --scalable``
(StencilLorascECG) with its partition file, and the runs over several
shards under a group (``--nshards 2``, two gloo ranks spawned): the
distributed LORASC and the sharded ``ecg`` with its partition file saved
and pinned again (tests/test_smoke.py:298-340). Iterations within ±1 of
JAX's CLI at the same arguments; only rank 0 prints.
"""

import torch

from prealps_tpu import cli as jcli
from prealps_tpu.core.io import load_partition
from prealps_tpu_torch import cli
from sharded_cases import spawn_jobs
from test_torch_cli import N655, _both, _last_json, _same

torch.set_num_threads(1)


def test_scalable_matches_jax(capsys):
    rec, rec_j = _both(capsys, "lorasc", ["--size", "6x6x6", "-e", "2", "--scalable",
                                          "--nparts", "4", "-t", "1e-6", "--json"])
    _same(rec, rec_j, 1e-6)


def test_scalable_partition_roundtrip(capsys, tmp_path):
    part_path = tmp_path / "parts.txt"
    base = ["--size", "6x6x6", "-e", "2", "--scalable", "--nparts", "4", "-t",
            "1e-6", "--json", "--device", "cpu"]
    assert cli.main(["lorasc", *base, "--save-partition", str(part_path)]) == 0
    rec1 = _last_json(capsys.readouterr().out)
    part = load_partition(str(part_path), 3 * 7 * 7 * 6)
    assert (part < 0).any(), "separator rows must be marked -1"
    assert cli.main(["lorasc", *base, "--partition-file", str(part_path)]) == 0
    rec2 = _last_json(capsys.readouterr().out)
    assert rec2["iters"] == rec1["iters"] and rec2["relres"] < 1e-4


SHARDED = [("lorasc", ["--size", "6x5x5", "-e", "2", "-t", "1e-6", "--nshards", "2",
                       "--json"]),
           ("ecg", ["--size", "6x5x5", "-e", "2", "-t", "1e-6", "--nshards", "2",
                    "--fmt", "ell", "--json"])]


def test_sharded_runs_under_a_group(capsys, tmp_path, tmp_path_factory):
    part_path = str(tmp_path / "parts.txt")
    runs = [(c, [*argv, "--device", "cpu"]) for c, argv in SHARDED]
    runs.append(("ecg", [*runs[1][1], "--save-partition", part_path]))
    runs.append(("ecg", [*runs[1][1], "--partition-file", part_path]))
    ranks = spawn_jobs(2, [("cli_runs", (runs,))], tmp_path_factory, timeout=180)
    root, other = ranks[0][0], ranks[1][0]
    assert all(rc == 0 for rc, _ in root + other)
    assert all(out == "" for _, out in other), "only rank 0 prints"
    recs = [_last_json(out) for _, out in root]
    for (command, argv), rec in zip(SHARDED, recs):
        assert getattr(jcli, f"{command}_main")(argv) in (0, None)
        _same(rec, _last_json(capsys.readouterr().out), 1e-6)
    part = load_partition(part_path, N655)
    assert part.min() == 0 and part.max() == 1
    assert recs[3]["iters"] == recs[2]["iters"] == recs[1]["iters"]
