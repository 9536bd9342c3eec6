"""``stencil_roofline``: the stencil kernel's share of its roofline on the
operator product. For each launch inside a span ``spmm`` whose name has
``stencil`` in it, the bound from the span's operands (``roofline.py``'s
rule, the panel width the span recorded); the share is the launches' summed
bound over their summed device time in the trace."""


def read(ctx):
    op = ctx["operator"]
    if ctx["instances"] is None or not op or op.get("format") != "stencil":
        return None
    bound_s = device_s = 0.0
    counted = set()
    for e in ctx["work"]:
        if e["span"] != "spmm" or "stencil" not in e["name"].lower():
            continue
        device_s += e["dur"] * 1e-6
        if e["inst"] not in counted:
            counted.add(e["inst"])
            bound_s += ctx["roofline"].stencil_bound_s(op, ctx["instances"][e["inst"]][1]["t"])
    return 100.0 * bound_s / device_s if device_s else None
