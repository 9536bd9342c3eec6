"""``ecg.graph_step_pct``: the share of the traced window's ECG iterations
whose t×t algebra ran as a replay of the step's CUDA graph: 100 × Σ
``ecg.graph_steps`` (a program counter, ``info["trace"]``) over Σ
iterations (``info["iters"]``). Nothing where a solve's trace lacks the
counter (a program without the graph)."""

from benchmark import program_trace as pt

COUNTER = "ecg.graph_steps"


def read(ctx):
    trs = pt.traces(ctx["infos"])
    if trs is None or not all(COUNTER in t["counters"] for t in trs):
        return None
    iters = sum(int(i["iters"]) for i in ctx["infos"])
    steps = sum(int(t["counters"][COUNTER]) for t in trs)
    return 100.0 * steps / iters if iters else None
