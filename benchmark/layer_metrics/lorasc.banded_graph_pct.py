"""``lorasc.banded_graph_pct``: the share of the traced window's banded
interior and separator solves that ran as a replay of their CUDA graph:
100 × Σ ``lorasc.graph_solves`` over Σ ``lorasc.banded_solves`` (program
counters, ``info["trace"]``). Nothing where a solve's trace lacks the
counters (a program without the graphs) or the window made no banded
solve."""

from benchmark import program_trace as pt

SOLVES, GRAPHED = "lorasc.banded_solves", "lorasc.graph_solves"


def read(ctx):
    trs = pt.traces(ctx["infos"])
    if trs is None or not all(SOLVES in t["counters"] and GRAPHED in t["counters"]
                              for t in trs):
        return None
    solves = sum(int(t["counters"][SOLVES]) for t in trs)
    graphed = sum(int(t["counters"][GRAPHED]) for t in trs)
    return 100.0 * graphed / solves if solves else None
