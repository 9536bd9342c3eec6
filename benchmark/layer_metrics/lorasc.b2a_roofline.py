"""``lorasc.b2a_roofline``: the lane-major stencil kernel B2a's share of its
roofline over all its launches in the traced window: the iteration's
operator product, the apply's two sweep products and the refinement
finish's A·x_lo. A launch is B2a where the kernel ``stencil_pipe`` runs
lane-major (KMAJOR false) with wrap halos (WRAP true) on the lane-major
block table (PLANAR false), its last three template arguments; B2b (no
wrap) is left out. Each launch's bound is ``roofline.stencil_bound_s`` on
the operator's shapes at the panel width its span recorded, or the solve's
``t`` outside the spans; the share is the summed bound over the summed
device time."""

KERNEL = "stencil_pipe<"


def template_args(name: str):
    """The template arguments of a kernel name, or None."""
    at = name.find(KERNEL)
    if at < 0:
        return None
    depth, start = 0, at + len(KERNEL)
    for k in range(start, len(name)):
        if name[k] == "<":
            depth += 1
        elif name[k] == ">":
            if depth == 0:
                args = [s.strip() for s in name[start:k].split(",")]
                return [{"(bool)1": "true", "(bool)0": "false"}.get(s, s) for s in args]
            depth -= 1
    return None


def is_b2a(name: str) -> bool:
    args = template_args(name)
    return args is not None and len(args) >= 3 and args[-3:] == ["false", "true", "false"]


def read(ctx):
    op = ctx["operator"]
    if ctx["instances"] is None or not op or op.get("format") != "stencil":
        return None
    bound_s = device_s = 0.0
    for e in ctx["work"]:
        if not is_b2a(e["name"]):
            continue
        args = ctx["instances"][e["inst"]][1] if e["inst"] is not None else None
        t = (args or {}).get("t", op.get("t"))
        if t is None:
            return None
        device_s += e["dur"] * 1e-6
        bound_s += ctx["roofline"].stencil_bound_s(op, t)
    return 100.0 * bound_s / device_s if device_s else None
