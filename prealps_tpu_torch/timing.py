"""Device time of a call on the card: the yardstick of the port's timing
scripts (``examples/kernel_ab.py``, ``examples/bench_spmm.py``).

CUDA events around calls issued as the host goes time the host's launch
path wherever a kernel is shorter than it (~40-50 µs a wrapper call on the
H100's machine, more than most stencil kernels). ``device_ms`` enqueues the
calls behind a spin kernel that outlasts their enqueueing, so the events
time the device's work alone.
"""

from __future__ import annotations

import statistics
import time

import torch


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
