"""``lorasc.ops_per_apply``: device operations (kernels, copies, sets) one
LORASC apply launches: those between the markers of the benchmark's span
``precond``, its nested ``precond.banded`` included, over the number of
applies in the traced window. The banded solves loop over their blocks,
so this counts what the host issues for one apply."""

SPANS = ("precond", "precond.banded")


def read(ctx):
    if ctx["instances"] is None:
        return None
    applies = sum(name == "precond" for name, _ in ctx["instances"])
    ops = sum(e["span"] in SPANS for e in ctx["work"])
    return ops / applies if applies and ops else None
