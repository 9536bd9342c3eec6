"""The reader ``ecg.graph_step_pct`` on synthetic solves: 100 where every
iteration replayed the step's CUDA graph, the share where some ran eager, 0
on an eager program, and nothing where a solve's trace lacks the counter
(a program without the graph) or a solve has no trace."""

import pytest

from benchmark import harness


def reader():
    return harness.load_module(harness.HERE / "layer_metrics" / "ecg.graph_step_pct.py",
                               "reader_ecg_graph_step_pct")


def ctx(steps, iters=(300, 20)):
    """Two solves of ``iters`` iterations, each trace with ``steps`` graph
    steps (None: no such counter)."""
    infos = []
    for k, (n, it) in enumerate(zip(steps, iters)):
        counters = {"host.syncs": it + 14}
        if n is not None:
            counters["ecg.graph_steps"] = n
        infos.append({"iters": it, "trace": {"id": k, "spans": [], "counters": counters}})
    return {"infos": infos, "work": [], "busy_s": 0.0, "window_s": 1.0}


def test_every_iteration_replayed_reads_100():
    assert reader().read(ctx([300, 20])) == pytest.approx(100.0)


def test_a_partly_eager_window_reads_its_share():
    assert reader().read(ctx([300, 0])) == pytest.approx(100.0 * 300 / 320)


def test_an_eager_program_reads_0():
    assert reader().read(ctx([0, 0])) == 0.0


@pytest.mark.parametrize("steps", [(None, None), (300, None)])
def test_a_program_without_the_counter_reads_nothing(steps):
    assert reader().read(ctx(steps)) is None


def test_a_window_without_traces_reads_nothing():
    c = ctx([300, 20])
    for info in c["infos"]:
        info.pop("trace")
    assert reader().read(c) is None
