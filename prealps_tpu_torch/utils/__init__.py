"""Utilities: host phase timers, profiler traces and scopes, debug printing
(the counterparts of ``prealps_tpu/utils``)."""

from prealps_tpu_torch.utils.timing import Timers, profile_trace, scope, sync, timed

__all__ = ["Timers", "timed", "profile_trace", "scope", "sync"]
