"""``lorasc.banded_device_pct``: share of the traced window's device time
spent in LORASC's banded interior and separator solves (the benchmark's
span ``precond.banded`` around ``lorasc_scale._aii_solve`` and
``_agg_solve``, nested inside the apply's span ``precond``)."""

SPAN = "precond.banded"


def read(ctx):
    if ctx["instances"] is None:
        return None
    total = sum(e["dur"] for e in ctx["work"])
    inside = sum(e["dur"] for e in ctx["work"] if e["span"] == SPAN)
    return 100.0 * inside / total if total and inside else None
