"""The program's own spans and counters, on the device trace's clock.

While the traced window's profiler records, prealps_tpu_torch hands back
each solve's spans and counters in ``info["trace"]``
(``prealps_tpu_torch/utils/timing.py``): spans with name, start_ns, end_ns
and the index of their parent in the solve's list (the root ``solve``
first), and counters, among them ``host.syncs``, the solve's blocking
device-to-host reads, each spanned ``host.read``. A checkout whose program
records none gives no traces here, and every reader of them reads nothing.

``export_events`` keeps no base time, so the two clocks are aligned by the
reads: each read is one ``Memcpy DtoH`` in the device trace, and the k-th
``host.read`` span of the window is paired with the k-th such copy. A copy
cannot start before its read's span opened, and the span cannot close
before the copy ended, so one offset for the window (device µs = host µs +
offset) lies in [max_k(copy end − read end), min_k(copy start − read
start)] (``pairs``, ``align``: the bracket's midpoint and width). The card's
trace clock can drift against the host's within a window (by up to 1.3 %,
then snap back: the bracket is then empty, its width negative), so spans are
placed by ``local_offsets``: at each copy, the largest lower bound (copy
end − read end) of its read and the reads around it, held inside the read's
own bracket; it holds while the device time runs to the next copy. Where the counts differ a read
went uncounted (or a copy was lost), and the readers read nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

DTOH = "Memcpy DtoH"
ROOT = "solve"


def traces(infos: list):
    """The solves' traces, or None where a solve has none."""
    out = [i.get("trace") for i in infos]
    return out if out and all(t is not None for t in out) else None


def syncs(trs: list) -> int:
    return sum(int(t["counters"].get("host.syncs", 0)) for t in trs)


def copies(work: list) -> list:
    """The window's device-to-host copies, in order of start."""
    return [e for e in work if e["name"].startswith(DTOH)]


def counts_match(trs: list, work: list) -> bool:
    """The trace's device-to-host copies are the solves' counted reads."""
    reads = sum(s["name"] == "host.read" for t in trs for s in t["spans"])
    return reads == syncs(trs) == len(copies(work))


def host_us(trs: list):
    """A function from the program's ns to µs after the first solve's
    start (integer arithmetic first: ns since the epoch overflow a
    double's exact range)."""
    ref = trs[0]["spans"][0]["start_ns"]
    return lambda ns: (ns - ref) / 1e3


def pairs(trs: list, work: list):
    """[(read start, read end, copy start, copy end)] in µs, the k-th
    ``host.read`` with the k-th copy (the read on the host clock, the copy
    on the device trace's), or None where the counts differ or there is no
    read."""
    if not counts_match(trs, work) or not syncs(trs):
        return None
    us = host_us(trs)
    reads = sorted((s for t in trs for s in t["spans"] if s["name"] == "host.read"),
                   key=lambda s: s["start_ns"])
    return [(us(r["start_ns"]), us(r["end_ns"]), c["ts"], c["ts"] + c["dur"])
            for r, c in zip(reads, copies(work))]


def align(prs: list):
    """(offset µs, bracket width µs) of one offset for the whole window."""
    lo = max(ce - re for rs, re, cs, ce in prs)
    hi = min(cs - rs for rs, re, cs, ce in prs)
    return 0.5 * (lo + hi), hi - lo


def local_offsets(prs: list, reach: int = 2) -> list:
    """[(device µs of a copy's end, offset µs)] in device order: at each
    copy, the largest lower bound (copy end − read end) among its read and
    ``reach`` reads each side, held under its own read's upper bound (copy
    start − read start). A read that returned late lowers only its own
    lower bound; a neighbour's bound across a drift cannot carry the offset
    outside the read's own bracket. It holds while the device time runs to
    the next copy."""
    lows = [ce - re for rs, re, cs, ce in prs]
    return [(ce, min(cs - rs, max(lows[max(0, k - reach):k + reach + 1])))
            for k, (rs, re, cs, ce) in enumerate(prs)]


def busy_on_host(work: list, offsets: list) -> list:
    """The device operations' intervals on the host clock, merged: each
    shifted by the offset in force at its start (``local_offsets``; a
    single [(-inf, offset)] for one offset)."""
    marks = [m for m, _ in offsets]
    shifted = []
    for e in work:
        off = offsets[max(bisect.bisect_right(marks, e["ts"]) - 1, 0)][1]
        shifted.append((e["ts"] - off, e["ts"] + e["dur"] - off))
    out = []
    for a, b in sorted(shifted):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def segments(spans: list, us) -> list:
    """(start µs, end µs, name) of the innermost span over the root's
    interval, in order (spans nest: each lies inside its parent)."""
    order = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
    out, stack, cur = [], [], us(order[0]["start_ns"])
    for s in order:
        start = us(s["start_ns"])
        while stack and stack[-1][0] <= start:
            end, name = stack.pop()
            out.append((cur, end, name))
            cur = end
        if stack and start > cur:
            out.append((cur, start, stack[-1][1]))
        cur = max(cur, start)
        stack.append((us(s["end_ns"]), s["name"]))
    while stack:
        end, name = stack.pop()
        out.append((cur, end, name))
        cur = end
    return [seg for seg in out if seg[1] > seg[0]]


def idle(busy: list, lo: float, hi: float) -> list:
    """The gaps in [lo, hi] between merged busy intervals (sorted)."""
    gaps, cur = [], lo
    for a, b in busy:
        if b <= cur:
            continue
        if a >= hi:
            break
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


def idle_by_span(trs: list, busy: list) -> dict:
    """µs of device idle time inside the solves, by the innermost program
    span open at that instant (the root's own name where no other is);
    ``busy`` the device's merged intervals on the host clock."""
    us = host_us(trs)
    out: dict = defaultdict(float)
    for t in trs:
        segs = segments(t["spans"], us)
        root = t["spans"][0]
        j = 0
        for a, b in idle(busy, us(root["start_ns"]), us(root["end_ns"])):
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                out[segs[k][2]] += min(b, segs[k][1]) - max(a, segs[k][0])
                k += 1
    return dict(out)
