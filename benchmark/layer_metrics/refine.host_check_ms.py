"""``refine.host_check_ms``: milliseconds a solve in ``solve.host_check``,
the host float64 check of the answer (a SciPy CSR product over the scaled
operator, the residual and its norms), the mean over the traced window's
solves (program spans, ``info["trace"]``)."""

from benchmark import program_trace as pt


def read(ctx):
    trs = pt.traces(ctx["infos"])
    if trs is None:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for t in trs for s in t["spans"]
             if s["name"] == "solve.host_check")
    return ns / len(trs) / 1e6
