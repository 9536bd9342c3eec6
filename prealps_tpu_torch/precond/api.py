"""Preconditioner protocol and factory.

The PyTorch counterpart of ``prealps_tpu/precond/api.py``: every
preconditioner object has an ``apply`` taking an (m, t) panel to M⁻¹ times
it; ``make_preconditioner`` builds one by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import torch

from prealps_tpu_torch.config import resolve_device


@runtime_checkable
class Preconditioner(Protocol):
    def apply(self, z: torch.Tensor) -> torch.Tensor:
        """Return M⁻¹ z for an (m, t) panel."""
        ...


@dataclass
class Identity:
    """NOPREC."""

    def apply(self, z):
        return z


def make_preconditioner(kind: str, a, device="cuda", **kwargs):
    """Factory: kind in {none, block_jacobi, lorasc, presc}, built on
    ``device`` (default "cuda", which raises without a card); the keywords
    go to the build function. LORASC and PRESC return (precond, arrow), as
    their build functions do."""
    kind = kind.lower()
    if kind in ("none", "noprec", "identity"):
        return Identity()
    if kind in ("block_jacobi", "bj", "blockjacobi"):
        from prealps_tpu_torch.precond.block_jacobi import build_block_jacobi as build
    elif kind == "lorasc":
        from prealps_tpu_torch.precond.lorasc import build_lorasc as build
    elif kind == "presc":
        from prealps_tpu_torch.precond.presc import build_presc as build
    else:
        raise ValueError(f"unknown preconditioner {kind!r}")
    return build(a, device=resolve_device(device), **kwargs)
