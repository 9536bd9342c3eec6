"""The reader ``lorasc.banded_graph_pct`` on synthetic solves: 100 where every
banded solve replayed its CUDA graph, the share where some ran eager, 0 on
an eager program, and nothing where a solve's trace lacks the counters (a
program without the graphs), a solve has no trace, or the window made no
banded solve. On a card (skipped without one), a traced run of the LORASC
cell at 12³ pairs every span marker and reads the new share beside the
accepted LORASC metrics."""

import pytest

from benchmark import harness, trace

CELL = "ela_lorasc.n346k"


def reader():
    return harness.load_module(harness.HERE / "layer_metrics" / "lorasc.banded_graph_pct.py",
                               "reader_lorasc_banded_graph_pct")


def ctx(graphed, solves=(180, 12)):
    """Two solves, each trace with ``solves`` banded solves and ``graphed``
    replays (None: neither counter)."""
    infos = []
    for k, (g, n) in enumerate(zip(graphed, solves)):
        counters = {"host.syncs": 9}
        if g is not None:
            counters.update({"lorasc.banded_solves": n, "lorasc.graph_solves": g})
        infos.append({"iters": n // 3, "trace": {"id": k, "spans": [], "counters": counters}})
    return {"infos": infos, "work": [], "busy_s": 0.0, "window_s": 1.0}


def test_every_solve_replayed_reads_100():
    assert reader().read(ctx([180, 12])) == pytest.approx(100.0)


def test_a_partly_eager_window_reads_its_share():
    assert reader().read(ctx([180, 0])) == pytest.approx(100.0 * 180 / 192)


def test_an_eager_program_reads_0():
    assert reader().read(ctx([0, 0])) == 0.0


@pytest.mark.parametrize("graphed", [(None, None), (180, None)])
def test_a_program_without_the_counters_reads_nothing(graphed):
    assert reader().read(ctx(graphed)) is None


def test_a_trace_with_one_counter_only_reads_nothing():
    c = ctx([180, 12])
    c["infos"][1]["trace"]["counters"].pop("lorasc.graph_solves")
    assert reader().read(c) is None


def test_a_window_without_banded_solves_reads_nothing():
    assert reader().read(ctx([0, 0], solves=(0, 0))) is None


def test_a_window_without_traces_reads_nothing():
    c = ctx([180, 12])
    for info in c["infos"]:
        info.pop("trace")
    assert reader().read(c) is None


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_the_graphed_share(tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from prealps_tpu_torch.precond import lorasc_scale

    # the entry wraps these module functions in spans: put them back after
    # the run, so a later traced run in this process counts its own markers
    for name in ("_aii_solve", "_agg_solve"):
        monkeypatch.setattr(lorasc_scale, name, getattr(lorasc_scale, name))
    cell = harness.resolve(CELL)
    cell["traffic"]["problem"].update(nx=12, ny=12, nz=12)
    cell["traffic"].update(trace_solves=2)
    run = harness.Run(cell, 2 ** 31 + 11, device="cuda", cache_dir=tmp_path)
    run.setup()
    run.window(0.0, trace=True)
    run.release()
    run.check()
    assert run.correct and len(run.xs) == 2
    metrics, device, _ = run.per_layer()
    _, instances = trace.attribute(run.trace_ops or [], run.spans.marks)
    assert instances is not None          # every marker paired with its span
    assert metrics["lorasc.banded_graph_pct"]["value"] == pytest.approx(100.0)
    assert 0 < metrics["lorasc.banded_device_pct"]["value"] < 100
    assert metrics["lorasc.ops_per_apply"]["value"] > 4
    assert "lorasc.b2a_roofline" in metrics
    assert 0 < device["busy_s"] <= device["window_s"]
    for info in run.infos:
        counters = info["trace"]["counters"]
        assert counters["lorasc.graph_captures"] == 0    # captured in the warm solve
        assert counters["lorasc.graph_solves"] == counters["lorasc.banded_solves"] > 0
