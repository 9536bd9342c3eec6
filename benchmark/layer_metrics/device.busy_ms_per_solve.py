"""``device.busy_ms_per_solve``: milliseconds in which an operation ran on
the card, per solve of the traced window (the union of the device
operations' intervals over the solves). A steadier reading of the device's
work than ``tts_s``, which the host's pace also moves."""


def read(ctx):
    if not ctx["work"] or not ctx["infos"]:
        return None
    return 1e3 * ctx["busy_s"] / len(ctx["infos"])
