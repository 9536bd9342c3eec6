"""``device.idle_pct``: share of the traced window's wall time in which no
operation ran on the card: 1 − the union of the device operations'
intervals over the window."""


def read(ctx):
    if not ctx["work"] or not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
