"""Debug printing.

Counterpart of ``prealps_tpu/utils/debug.py`` (reference: -DDEBUG
synchronized per-rank printing, utils/preAlps_utils.c:758
preAlps_int_printSynchronized). Each rank prints its own line, tagged with
its rank in the group, when ``PREALPS_TPU_DEBUG=1`` (``config.DEBUG``).
"""

from __future__ import annotations

import torch

from prealps_tpu_torch import config
from prealps_tpu_torch.parallel.mesh import rank_of


def print_sharded(name: str, value, group=None):
    """Print a summary of a value (shape, smallest and largest magnitude)
    from every rank, tagged by its rank in ``group`` (0 without one).
    No-op unless ``config.DEBUG`` (mirrors the reference's -DDEBUG gate)."""
    if not config.DEBUG:
        return
    v = torch.as_tensor(value).abs()
    print(f"[shard {rank_of(group)}] {name}: shape={tuple(v.shape)} "
          f"|min|={float(v.min()):.3e} |max|={float(v.max()):.3e}", flush=True)
