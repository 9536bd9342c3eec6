"""Device time of a call on the card: the yardstick of the port's timing
scripts (``examples/kernel_ab.py``, ``examples/bench_spmm.py``).

CUDA events around calls issued as the host goes time the host's launch
path wherever a kernel is shorter than it (~40-50 µs a wrapper call on the
H100's machine, more than most stencil kernels). ``device_ms`` enqueues the
calls behind a spin kernel that outlasts their enqueueing, so the events
time the device's work alone; ``call_ms`` uses it on the card and the
host clock on the CPU. ``profiled_device_ms`` gives a whole call's busy
device time under torch.profiler (``device_busy_ms`` that of any profiled
window: the union of the device operations' intervals in the window's
exported trace, so overlapping operations count once and none is left
out), and ``card_line`` the card's name and power limit, which every
measurement script prints.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import torch


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(prof) -> list:
    """The device operations (kernels, copies, sets) of a torch.profiler
    window as (start, duration) pairs in µs, from its exported Chrome
    trace, sorted by start."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return sorted((float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                  if e.get("ph") == "X" and e.get("cat", "").lower() in DEVICE_CATS)


def union_ms(intervals) -> float:
    """Milliseconds in which at least one of the (start, duration) µs
    intervals, sorted by start, runs."""
    total, end = 0.0, -float("inf")
    for lo, dur in intervals:
        hi = lo + dur
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def device_busy_ms(prof) -> float:
    """Busy device time of a torch.profiler window: the union of its device
    operations' intervals (the card's busy time, its idle gaps left out)."""
    return union_ms(device_intervals(prof))


def profiled_device_ms(fn) -> float:
    """Busy device time of one fn() call under torch.profiler, recording the
    device's activity only (``device_busy_ms`` of its window)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof)


def device_ms(fn, reps: int = 20, batches: int = 3, warm: int = 3):
    """Device time of one fn() call in ms: each of ``batches`` samples is
    ``reps`` calls back to back between two CUDA events, enqueued behind a
    spin kernel (``torch.cuda._sleep``) that outlasts their enqueueing.
    Returns (median, samples)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # SM cycles to spin: twice the host's enqueue time plus 1 ms, at 2 GHz
    # (at or above the card's clock, so the spin lasts at least as long)
    cycles = int(2e9 * min(1.0, 2.0 * host_s + 1e-3))
    times = []
    for _ in range(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times), times


def call_ms(fn, arg, reps: int, device) -> float:
    """Time of one fn(arg) call in ms: ``reps`` back-to-back calls after a
    warm one, on the card by ``device_ms`` (so the host's launch path is
    not timed), on the CPU by the host clock."""
    if device.type == "cuda":
        return device_ms(lambda: fn(arg), reps=reps, batches=1, warm=1)[0]
    fn(arg)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(arg)
    return 1e3 * (time.perf_counter() - t0) / reps
