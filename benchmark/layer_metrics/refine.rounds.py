"""``refine.rounds``: refinement rounds a solve, the mean over the traced
window's solves (``info["refine_rounds"]``, a program counter)."""


def read(ctx):
    rounds = [i["refine_rounds"] for i in ctx["infos"] if i.get("refine_rounds") is not None]
    return sum(rounds) / len(rounds) if rounds else None
