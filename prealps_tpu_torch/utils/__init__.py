"""Utilities: host phase timers, profiler traces, the program's spans and
counters, debug printing (the counterparts of ``prealps_tpu/utils``)."""

from prealps_tpu_torch.utils.timing import (
    Stages,
    Timers,
    add,
    counter,
    host_read,
    profile_trace,
    scope,
    sync,
    timed,
    traced,
)

__all__ = ["Timers", "timed", "profile_trace", "scope", "traced", "host_read",
           "Stages", "counter", "add", "sync"]
