"""``precond.device_pct``: share of the traced window's device time spent
in operations the preconditioner apply launched (span ``precond``)."""


def read(ctx):
    if ctx["instances"] is None:
        return None
    total = sum(e["dur"] for e in ctx["work"])
    inside = sum(e["dur"] for e in ctx["work"] if e["span"] == "precond")
    return 100.0 * inside / total if total and inside else None
