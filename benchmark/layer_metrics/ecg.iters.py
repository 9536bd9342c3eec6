"""``ecg.iters``: ECG iterations a solve over all its rounds, the mean over
the traced window's solves (``info["iters"]``, a program counter)."""


def read(ctx):
    iters = [i["iters"] for i in ctx["infos"]]
    return sum(iters) / len(iters) if iters else None
