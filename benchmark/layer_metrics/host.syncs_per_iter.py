"""``host.syncs_per_iter``: blocking device-to-host reads an ECG iteration,
Σ ``host.syncs`` over Σ iterations of the traced window's solves (the
program's counter, ``info["trace"]``). Read only where the device trace
holds one ``Memcpy DtoH`` for each counted read: else a read went
uncounted, and the count would say less than the host waits."""

from benchmark import program_trace as pt


def read(ctx):
    trs = pt.traces(ctx["infos"])
    if trs is None or not pt.counts_match(trs, ctx["work"]):
        return None
    iters = sum(int(i["iters"]) for i in ctx["infos"])
    return pt.syncs(trs) / iters if iters else None
