"""Timing, profiling, and the program's spans and counters.

Counterpart of ``prealps_tpu/utils/timing.py`` (reference: the per-kernel
wall-clock accumulators of the solver struct, ecg.h:87-98, and
preAlps_dstats_display, preAlps_utils.c:720):

* ``Timers`` / ``timed`` — accumulating host-phase timers (the ECGPrint
  analog); a ``Timers`` given a ``device`` synchronises it at both ends of
  every block, so a block's time covers the card's work it queued;
* ``sync`` — wait for the work queued on a device (a no-op off the card);
* ``scope``, ``traced``, ``host_read``, ``Stages``, ``counter`` / ``add``
  — the program's spans and counters (below);
* ``profile_trace`` — a ``torch.profiler`` trace of a block, written to a
  directory as Chrome trace JSON (TensorBoard's profiler plugin, Perfetto,
  ``chrome://tracing``) with the program's spans in it; CUDA activity is
  recorded where a card is present.

Spans and counters: the contract.

* **When they record.** Only while a ``torch.profiler`` records, and then
  inside a trace. A root, ``traced(name)`` (``DistributedECG.solve`` and
  ``.build``, ``profile_trace``'s block), tests the profiler's flag
  (``torch._C._autograd._profiler_enabled()``) once; if it is set, the root
  opens a ``Trace`` and every ``scope``, ``host_read`` and ``Stages`` call
  below it records into that trace. Outside a trace a span reads one module
  global and records nothing. The profiler is the switch: the benchmark's
  traced window and ``profile_trace`` open one; there is no option of its
  own.
* **What a record holds.** A span: its name, its start and end in ns, the
  index of its parent span in its trace (-1 for the root) and the trace's
  id (all spans of one solve share it). A
  trace's counters: ``host.syncs``, the blocking device-to-host reads made
  through ``host_read`` (each one ``Memcpy DtoH`` in the device trace),
  ``launches.<wrapper>``, the change over the trace of each kernel
  wrapper's ``.launches`` counter (``count_launches``), and the change of
  each program counter (``counter`` / ``add``: ``ecg.graph_steps``,
  ``ecg.graph_captures``).
* **Which clock.** The one torch.profiler stamps its Chrome trace with:
  ``ts``·1000 + ``baseTimeNanoseconds`` reads ``time.time_ns()``. A trace
  takes ``time.perf_counter_ns()`` and converts it with one
  (``perf_counter_ns``, ``time_ns``) pair read when it opens (the
  tightest of three, ``_clock_offset``).
* **Where they go.** A solve's trace is handed back in its
  ``info["trace"]`` (``Trace.as_dict``) while recording, and not otherwise;
  every trace that closes inside a ``profile_trace`` block is written into
  that block's trace file as host-side "X" events, on a track of its own.
* **What they never do.** Enqueue device work, synchronise, or read a
  tensor's value: ``host_read`` makes only the read its caller asks for. So every
  device-trace reading is the same with the spans recording as without.

One trace records at a time, in the thread that opened it: a solve is one
host thread (a sharded solve one process a rank).

The device time of a call (CUDA events behind a spin kernel) is the
port-only ``prealps_tpu_torch/timing.py::device_ms``; the JAX
``scan_differential_ms`` is not ported (a remote-TPU measurement device).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import socket
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_perf_ns = time.perf_counter_ns

_trace: "Trace | None" = None       # the trace spans record into, if any
_exports: list = []                 # the open profile_trace blocks' trace lists
_ids = itertools.count()
LAUNCH_COUNTERS: dict = {}          # wrapper name -> wrapper with ``.launches``
COUNTERS: dict = {}                 # program counter name -> its running count
_SPAN_TID = 0                        # the spans' track in an exported trace


def sync(device) -> None:
    """Wait for the work queued on ``device``; a no-op off the card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Timers:
    """Accumulating host-side phase timers (the ECGPrint analog).
    ``device`` (None: none) is synchronised on entering and leaving every
    timed block."""

    acc: dict = field(default_factory=lambda: defaultdict(float))
    count: dict = field(default_factory=lambda: defaultdict(int))
    device: object = None

    @contextlib.contextmanager
    def time(self, name: str):
        if self.device is not None:
            sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None:
                sync(self.device)
            self.acc[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> str:
        lines = ["=== Timings ==="]
        for name in sorted(self.acc):
            lines.append(
                f"  {name:<20s} {self.acc[name]:10.4f} s  (x{self.count[name]})"
            )
        return "\n".join(lines)

    def as_dict(self):
        return dict(self.acc)


@contextlib.contextmanager
def timed(timers: Timers | None, name: str):
    if timers is None:
        yield
    else:
        with timers.time(name):
            yield


# --- spans and counters -------------------------------------------------


def count_launches(fn):
    """Decorator of a kernel wrapper: gives it a ``.launches`` counter (0),
    which the wrapper adds to at each launch, and registers it, so every
    trace carries its change as ``launches.<name>``."""
    fn.launches = 0
    LAUNCH_COUNTERS[fn.__name__] = fn
    return fn


def counter(name: str) -> str:
    """Register program counter ``name`` (at 0), so every trace carries its
    change, 0 included; returns the name for ``add``."""
    COUNTERS.setdefault(name, 0)
    return name


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to a registered program counter; it counts with or without
    a trace (one dict update)."""
    COUNTERS[name] += n


def _clock_offset() -> int:
    """``time_ns()`` − ``perf_counter_ns()``, from the tightest of three
    (time, perf, time) reads: a pair of reads that the scheduler splits
    would shift every span of a trace by the time it lost."""
    best = None
    for _ in range(3):
        t0 = time.time_ns()
        p = _perf_ns()
        t1 = time.time_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, (t0 + t1) // 2 - p)
    return best[1]


class Trace:
    """The spans and counters of one traced call (see the module
    docstring). A span is kept as [name, start, end, parent], its times on
    ``perf_counter_ns``."""

    __slots__ = ("id", "spans", "stack", "syncs", "counters", "_clock",
                 "_launches", "_counts")

    def __init__(self, name: str):
        self.id = next(_ids)
        self.spans: list = []
        self.stack: list = []
        self.syncs = 0
        self.counters: dict = {}
        self._launches = {k: f.launches for k, f in LAUNCH_COUNTERS.items()}
        self._counts = dict(COUNTERS)
        self._clock = _clock_offset()
        self.begin(name)

    def begin(self, name: str) -> None:
        stack = self.stack
        stack.append(len(self.spans))
        self.spans.append([name, _perf_ns(), 0, stack[-2] if len(stack) > 1 else -1])

    def end(self) -> None:
        self.spans[self.stack.pop()][2] = _perf_ns()

    def record(self, name: str, start: int, end: int) -> None:
        """A span that has already ended, a child of the open one."""
        self.spans.append([name, start, end, self.stack[-1]])

    def close(self) -> None:
        """End the root and take the counters."""
        self.end()
        self.counters = {"host.syncs": self.syncs}
        for k, f in LAUNCH_COUNTERS.items():
            self.counters[f"launches.{k}"] = f.launches - self._launches.get(k, 0)
        for k, n in COUNTERS.items():
            self.counters[k] = n - self._counts.get(k, 0)

    def as_dict(self) -> dict:
        """The trace on the profiler's clock: ``spans`` (dicts with name,
        start_ns, end_ns, parent and id; the root first) and
        ``counters``."""
        c = self._clock
        spans = [{"name": name, "start_ns": start + c, "end_ns": end + c,
                  "parent": parent, "id": self.id}
                 for name, start, end, parent in self.spans]
        return {"id": self.id, "spans": spans, "counters": dict(self.counters)}


class scope:
    """Span ``name`` around a block, as a context manager or a decorator;
    it records inside a trace only."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tr = _trace
        if tr is not None:
            tr.begin(self.name)
        return self

    def __exit__(self, *exc):
        tr = _trace
        if tr is not None:
            tr.end()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with self:
                return fn(*a, **k)
        return wrapped


class traced:
    """The root span of a call: while a profiler records, the call's own
    ``Trace`` (as ``with traced(name) as tr``; None when nothing records),
    which every span below it records into, and which is handed to the open
    ``profile_trace`` blocks when it closes. As a decorator, each call is
    its own root."""

    __slots__ = ("name", "trace", "_outer")

    def __init__(self, name: str):
        self.name = name
        self.trace = None

    def __enter__(self):
        global _trace
        self.trace = None
        if _profiler_enabled():
            self._outer = _trace
            self.trace = _trace = Trace(self.name)
        return self.trace

    def __exit__(self, *exc):
        global _trace
        tr = self.trace
        if tr is not None:
            tr.close()
            _trace = self._outer
            for traces in _exports:
                traces.append(tr)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with traced(name):
                return fn(*a, **k)
        return wrapped


def host_read(read, value):
    """``read(value)``, a blocking device-to-host read (``bool``, ``int``,
    ``float`` of a device scalar, ``torch.Tensor.cpu``): inside a trace
    counted in ``host.syncs`` and spanned ``host.read``."""
    tr = _trace
    if tr is None:
        return read(value)
    tr.syncs += 1
    tr.begin("host.read")
    try:
        return read(value)
    finally:
        tr.end()


class Stages:
    """Consecutive stages of a build: ``stages(name)`` ends stage ``name``,
    which began where the previous one ended (or at construction). It adds
    the stage's seconds to ``timings[name]`` and, inside a trace, records
    span ``<prefix>.<name>``."""

    def __init__(self, prefix: str = "build"):
        self.prefix = prefix
        self.timings: dict = {}
        self._mark = _perf_ns()

    def __call__(self, name: str) -> None:
        now = _perf_ns()
        self.timings[name] = self.timings.get(name, 0.0) + (now - self._mark) * 1e-9
        tr = _trace
        if tr is not None:
            tr.record(f"{self.prefix}.{name}", self._mark, now)
        self._mark = now


def _chrome_events(trace: dict, base_ns: int) -> list:
    """A trace (``Trace.as_dict``) as Chrome trace "X" events on the
    spans' track, ``ts`` in µs after ``base_ns``; the root carries the
    counters in its args."""
    out = []
    for s in trace["spans"]:
        args = {"trace": s["id"]}
        if s["parent"] < 0:
            args.update(trace["counters"])
        out.append({"ph": "X", "cat": "program_span", "name": s["name"],
                    "pid": os.getpid(), "tid": _SPAN_TID,
                    "ts": (s["start_ns"] - base_ns) / 1e3,
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "args": args})
    return out


def _write_trace(prof, log_dir: str, traces: list) -> None:
    """The profiler's Chrome trace with ``traces``' spans in it, named as
    ``tensorboard_trace_handler`` names its files."""
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}"
    path = os.path.join(log_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"].append({"ph": "M", "name": "thread_name", "pid": os.getpid(),
                               "tid": _SPAN_TID,
                               "args": {"name": "prealps_tpu_torch spans"}})
    for tr in traces:
        doc["traceEvents"].extend(_chrome_events(tr.as_dict(), base))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a torch.profiler trace around a block into ``log_dir`` (one
    ``*.pt.trace.json`` file a block), with the program's spans of the
    block (a root ``profile_trace`` and every trace that closed inside it)
    beside the profiler's events on one clock. No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    traces: list = []
    _exports.append(traces)
    try:
        with profile(activities=activities,
                     on_trace_ready=lambda p: _write_trace(p, log_dir, traces)):
            with traced("profile_trace"):
                yield
    finally:
        _exports.remove(traces)
