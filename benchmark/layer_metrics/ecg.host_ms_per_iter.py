"""``ecg.host_ms_per_iter``: the host's own time to enqueue one ECG
iteration: each ``ecg.step`` span's time less its ``host.read`` children's,
averaged over the traced window's iterations (program spans,
``info["trace"]``)."""

from benchmark import program_trace as pt


def read(ctx):
    trs = pt.traces(ctx["infos"])
    if trs is None:
        return None
    own, steps = 0, 0
    for t in trs:
        spans = t["spans"]
        waits = [0] * len(spans)
        for s in spans:
            if s["name"] == "host.read" and s["parent"] >= 0:
                waits[s["parent"]] += s["end_ns"] - s["start_ns"]
        for k, s in enumerate(spans):
            if s["name"] == "ecg.step":
                own += s["end_ns"] - s["start_ns"] - waits[k]
                steps += 1
    return own / steps / 1e6 if steps else None
