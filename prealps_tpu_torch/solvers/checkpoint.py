"""Solver-state checkpoint and resume.

The PyTorch counterpart of ``prealps_tpu/solvers/checkpoint.py``: the ECG
state (``ECGState``, stacked, or ``ECGPanelState``, one tensor a panel) is
saved every ``every`` iterations to a ``.npz`` file and restored into a
fresh process; a resumed solve equals the straight one. There is no Orbax
path: the ``.npz`` file is the only format.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from prealps_tpu_torch.config import resolve_device
from prealps_tpu_torch.solvers.ecg import (
    ECGOptions,
    ECGPanelState,
    ECGResult,
    ECGState,
    ecg_finalize,
    ecg_init,
    ecg_run,
)

_KINDS = {"stacked": ECGState, "panel": ECGPanelState}


def save_state(path: str, state, normb: torch.Tensor) -> None:
    """Write ``state`` and ``normb`` to ``path`` (.npz): every tensor field
    as an array, ``it`` and the stacked state's panel shape as integers."""
    kind = "stacked" if isinstance(state, ECGState) else "panel"
    arrays = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        arrays[f.name] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v, dtype=np.int64))
    np.savez(path, _kind=np.asarray(kind), normb=normb.detach().cpu().numpy(),
             **arrays)


def load_state(path: str, device="cuda"):
    """(state, normb) from a file ``save_state`` wrote, on ``device``
    ("cuda" unless named; raises without a card)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        cls = _KINDS[str(data["_kind"])]
        kw = {}
        for f in dataclasses.fields(cls):
            v = data[f.name]
            if f.name == "it":
                kw[f.name] = int(v)
            elif f.name == "panel_shape":
                kw[f.name] = tuple(int(s) for s in v)
            else:
                kw[f.name] = torch.from_numpy(v).to(dev)
        return cls(**kw), torch.from_numpy(data["normb"]).to(dev)


def ecg_solve_checkpointed(
    a_apply,
    m_apply,
    b: torch.Tensor,
    opts: ECGOptions,
    checkpoint_path: str,
    every: int = 100,
    split_assign=None,
    resume: bool = True,
    on_chunk: Optional[Callable[[int, float], None]] = None,
    group=None,
) -> ECGResult:
    """Run ``every`` iterations at a time, saving the state to
    ``checkpoint_path`` after each chunk; with ``resume``, start from the
    file where it exists."""
    if m_apply is None:
        m_apply = lambda v: v
    if resume and os.path.exists(checkpoint_path):
        state, normb = load_state(checkpoint_path, device=b.device)
    else:
        state, normb = ecg_init(a_apply, m_apply, b, opts, split_assign, group)
    tol_abs = float(opts.tol) * float(normb)
    prev_it = state.it
    while True:
        state = ecg_run(a_apply, m_apply, state, normb, opts, max_steps=every,
                        group=group)
        res = float(state.res)
        save_state(checkpoint_path, state, normb)
        if on_chunk is not None:
            on_chunk(state.it, res)
        if res <= tol_abs or state.it >= opts.maxiter or bool(state.breakdown):
            break
        if float(torch.sum(state.mask)) <= 0:
            break
        # the stall guard can end ecg_run with none of the tests above met;
        # a chunk without progress would otherwise repeat forever
        if opts.stall_window > 0 and int(state.stall) >= opts.stall_window:
            break
        if state.it == prev_it:
            break
        prev_it = state.it
    return ecg_finalize(state, normb, opts.layout)
