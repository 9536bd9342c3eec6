"""Dtype and device policy.

* ``float64`` is the bit-comparable correctness path (CPU tests, and f64
  solves on the card).
* ``float32`` is the fast path on the card. Every f32 matrix product must
  run in true f32: TF32 keeps ~10 mantissa bits and silently breaks the
  A-orthogonality of the ECG recurrences, so ``strict_fp32`` switches it off
  (the counterpart of ``jax_default_matmul_precision="highest"`` in the JAX
  driver). Tolerances below the f32 floor are reached by double-float
  iterative refinement (parallel/driver.py).

The device is never picked automatically: callers name it, and asking for
CUDA where there is no card raises.
"""

from __future__ import annotations

import torch


def strict_fp32() -> None:
    """Full-f32 matmuls and convolutions: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the host")
    return dev
