"""Timing and profiling.

Counterpart of ``prealps_tpu/utils/timing.py`` (reference: the per-kernel
wall-clock accumulators of the solver struct, ecg.h:87-98, and
preAlps_dstats_display, preAlps_utils.c:720):

* ``Timers`` / ``timed`` — accumulating host-phase timers for build and
  solve stages (the ECGPrint analog); a ``Timers`` given a ``device``
  synchronises it at both ends of every block, so a block's time covers
  the card's work it queued, not only its launches;
* ``sync`` — wait for the work queued on a device (a no-op off the card);
* ``profile_trace`` — a ``torch.profiler`` trace of a block, written to a
  directory (Chrome trace JSON, readable by TensorBoard's profiler plugin
  or ``chrome://tracing``); CUDA activity is recorded where a card is
  present;
* ``scope`` — a named range in that trace (``record_function``).

The device time of a call (CUDA events behind a spin kernel) is the
port-only ``prealps_tpu_torch/timing.py::device_ms``; the JAX
``scan_differential_ms`` is not ported (a remote-TPU measurement device).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


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


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a torch.profiler trace around a block into ``log_dir`` (one
    ``*.pt.trace.json`` file a block). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def scope(name: str):
    """A named profiler range (context manager or decorator) for the
    solver's phases."""
    return torch.profiler.record_function(name)
