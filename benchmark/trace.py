"""Spans the benchmark records around the program's calls, and the reading
of the device trace of a traced window.

The profiler records the device's activity only (kernels, copies, sets):
with the host's operator events too, reading the trace of one solve took
tens of seconds. So a span cannot be a host range. Instead each span's
begin and end enqueue a marker kernel (``torch.cuda._sleep(1)``, named
``spin_kernel`` in the trace) on the current stream, which is the stream
the program launches on. In stream order, the device operations between a
span's two markers are the ones the span launched; ``Spans.marks`` keeps
the host's sequence of markers with each span's arguments, and
``attribute`` pairs the trace's markers with it one by one. Where the
counts differ, the trace lost records, and the span metrics read nothing.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


class Spans:
    """Wraps instance attributes of the program's objects in spans."""

    def __init__(self, mark=None):
        self.marks: list = []          # (kind "b"/"e", span name, args)
        self._mark = mark

    def _enqueue(self):
        if self._mark is None:
            import torch

            self._mark = lambda: torch.cuda._sleep(1)
        self._mark()

    def wrap(self, obj, attr: str, name: str, args=None) -> None:
        """Replace ``obj.attr`` (looked up at call time by the program) by
        the same call inside span ``name``; ``args(*a, **k)`` gives the
        span's arguments (e.g. the panel width of a product)."""
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            self.marks.append(("b", name, args(*a, **k) if args else None))
            self._enqueue()
            try:
                return fn(*a, **k)
            finally:
                self.marks.append(("e", name, None))
                self._enqueue()

        setattr(obj, attr, wrapped)


def export_events(prof) -> list:
    """The device operations of a torch.profiler window, sorted by start:
    dicts with name, ts and dur in microseconds."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ops = [{"name": e["name"], "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0))}
           for e in events
           if e.get("ph") == "X" and e.get("cat", "").lower() in DEVICE_CATS]
    ops.sort(key=lambda e: e["ts"])
    return ops


def short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.removeprefix("void ")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cut)] if cut else name).strip()


def union_s(ops: list) -> float:
    """Seconds in which at least one of ``ops`` ran."""
    total, end = 0.0, -float("inf")
    for e in ops:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total * 1e-6


def attribute(ops: list, marks: list):
    """Give each device operation the innermost span open when it was
    enqueued. Returns (work, instances): ``work`` the operations that are
    not markers, each with ``span`` (None outside every span) and ``inst``
    (the index of its span's instance); ``instances`` each span instance's
    (name, args). ``instances`` is None where the trace's markers do not
    match the host's."""
    markers = [e for e in ops if MARKER in e["name"]]
    work = [dict(e) for e in ops if MARKER not in e["name"]]
    if len(markers) != len(marks):
        for e in work:
            e["span"], e["inst"] = None, None
        return work, None
    bounds = sorted([(m["ts"], k) for k, m in enumerate(markers)])
    instances, stack, j = [], [], 0
    for e in work:
        while j < len(bounds) and bounds[j][0] <= e["ts"]:
            kind, name, args = marks[bounds[j][1]]
            if kind == "b":
                instances.append((name, args))
                stack.append(len(instances) - 1)
            elif stack:
                stack.pop()
            j += 1
        inst = stack[-1] if stack else None
        e["span"] = instances[inst][0] if inst is not None else None
        e["inst"] = inst
    return work, instances


def breakdown(work: list, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between two operations, each named by the span the next one ran
    in and the two operations' names."""
    by_op: dict = defaultdict(float)
    gaps: dict = defaultdict(float)
    prev = None
    for e in work:
        by_op[short(e["name"])] += e["dur"] * 1e-6
        if prev is not None:
            gap = e["ts"] - (prev["ts"] + prev["dur"])
            if gap > 0:
                label = (f"{e['span'] or 'outside spans'}: "
                         f"{short(prev['name'])} -> {short(e['name'])}")
                gaps[label] += gap * 1e-6
        if prev is None or e["ts"] + e["dur"] > prev["ts"] + prev["dur"]:
            prev = e
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}
