"""A traced run of each cell's configuration on the card, at a small size:
the span markers pair up with the trace, every per-layer metric is read,
and the answers are correct. Skipped without a card; on the card:

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

import pytest

from benchmark import harness

CELLS = ["ela_ecg12_bj.n811k"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_card(name, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.resolve(name)
    cell["traffic"]["problem"].update(nx=12, ny=12, nz=12)
    cell["traffic"].update(trace_solves=2)
    run = harness.Run(cell, 2 ** 31 + 5, device="cuda", cache_dir=tmp_path)
    run.setup()
    run.window(0.0, trace=True)
    run.release()
    run.check()
    assert run.correct and len(run.xs) == 2
    metrics, device, brk = run.per_layer()
    assert set(metrics) == {m["name"] for m in cell["per_layer"]}
    assert 0 < metrics["stencil_roofline"]["value"] <= 105
    assert 0 < metrics["spmm.device_pct"]["value"] < 100
    assert 0 < device["busy_s"] <= device["window_s"]
    assert brk["device_ops"] and brk["idle_gaps"]
