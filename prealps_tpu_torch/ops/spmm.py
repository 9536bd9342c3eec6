"""Stencil-BSR SpMM: the CUDA kernel's wrapper and its plain versions.

* ``stencil_flat_ext`` — the flat stencil SpMM on a pre-extended k-major
  panel (the TPU kernel ``prealps_tpu/ops/spmm.py::stencil_flat_ext``). For
  CUDA tensors it launches the hand-written kernel
  (``csrc/stencil_flat.cu``); for CPU tensors it runs
  ``stencil_flat_ext_ref``. There is no other route: a CUDA tensor that the
  kernel does not take raises.
* ``stencil_flat_ext_ref`` — the same product in plain PyTorch, with the
  TPU kernel's summation order (offset, then m, then k).
* ``stencil_scan_accumulate`` — the lane-major 4-D oracle every stencil
  kernel is checked against.
* ``stencil_scan_accumulate_df`` — the double-float (hi, lo) product of the
  refinement residual, in eager PyTorch: every error-free transform step is
  its own kernel, so nothing contracts a·b + c into an FMA (do not wrap it
  in ``torch.compile``).

Layouts are those of ops/formats.py.
"""

from __future__ import annotations

import torch

from prealps_tpu_torch.ops import _kernels
from prealps_tpu_torch.ops.doublefloat import two_prod, two_sum


def stencil_flat_ext_ref(blocks_flat: torch.Tensor, offsets, x_ext: torch.Tensor,
                         halo: int, br: int) -> torch.Tensor:
    """Plain PyTorch flat stencil SpMM.

    blocks_flat: (S·br², nrb), row s·br² + m·br + k = block entry (m, k) of
    offset s over all nodes; x_ext: (br·t, nrb + 2·halo) k-major rows with
    halos attached. Returns y (br·t, nrb), row m·t + j.
    """
    _, nrb = blocks_flat.shape
    t = x_ext.shape[0] // br
    acc = [torch.zeros((t, nrb), dtype=x_ext.dtype, device=x_ext.device)
           for _ in range(br)]
    for s, off in enumerate(offsets):
        xs = x_ext[:, halo + off:halo + off + nrb]
        for m in range(br):
            a = acc[m]
            for k in range(br):
                brow = blocks_flat[s * br * br + m * br + k]
                a = a + brow[None, :] * xs[k * t:(k + 1) * t]
            acc[m] = a
    return torch.cat(acc, dim=0)


def _check_flat_args(blocks_flat, offsets, x_ext, halo, br):
    if blocks_flat.dim() != 2 or x_ext.dim() != 2:
        raise ValueError("blocks_flat and x_ext must be 2-D")
    sbb, nrb = blocks_flat.shape
    if sbb != len(offsets) * br * br:
        raise ValueError(f"blocks_flat has {sbb} rows; expected "
                         f"S·br² = {len(offsets)}·{br}² rows")
    if x_ext.shape[0] % br:
        raise ValueError(f"x_ext rows {x_ext.shape[0]} not a multiple of br={br}")
    if x_ext.shape[1] != nrb + 2 * halo:
        raise ValueError(f"x_ext has {x_ext.shape[1]} columns; expected "
                         f"nrb + 2·halo = {nrb + 2 * halo}")
    if offsets and max(abs(o) for o in offsets) > halo:
        raise ValueError(f"halo {halo} smaller than the widest offset")


def stencil_flat_ext(blocks_flat: torch.Tensor, offsets, x_ext: torch.Tensor,
                     halo: int, br: int) -> torch.Tensor:
    """Flat stencil SpMM on a pre-extended k-major panel -> (br·t, nrb).

    CPU tensors run ``stencil_flat_ext_ref``. CUDA tensors launch the CUDA
    kernel, which takes f32, contiguous operands on one card, and count one
    launch in ``stencil_flat_ext.launches``.
    """
    offsets = tuple(int(o) for o in offsets)
    _check_flat_args(blocks_flat, offsets, x_ext, halo, br)
    if blocks_flat.device.type == "cpu" and x_ext.device.type == "cpu":
        return stencil_flat_ext_ref(blocks_flat, offsets, x_ext, halo, br)
    if blocks_flat.device.type != "cuda" or x_ext.device != blocks_flat.device:
        raise ValueError(f"stencil_flat_ext: operands on {blocks_flat.device} "
                         f"and {x_ext.device}; both must be on one CUDA card "
                         "(or both on the CPU)")
    if blocks_flat.dtype != torch.float32 or x_ext.dtype != torch.float32:
        raise TypeError(f"stencil_flat_ext kernel takes float32, got "
                        f"{blocks_flat.dtype} and {x_ext.dtype}")
    if not (blocks_flat.is_contiguous() and x_ext.is_contiguous()):
        raise ValueError("stencil_flat_ext kernel takes contiguous operands")
    nrb = blocks_flat.shape[1]
    t = x_ext.shape[0] // br
    y = torch.empty((br * t, nrb), dtype=torch.float32,
                    device=blocks_flat.device)
    if nrb == 0 or t == 0:
        return y
    _kernels.stencil_flat_f32(blocks_flat, offsets, x_ext, y, halo, br, t)
    stencil_flat_ext.launches += 1
    return y


stencil_flat_ext.launches = 0


def extend_wrap(xf: torch.Tensor, halo: int) -> torch.Tensor:
    """Attach single-shard wrap halos along the last (node) axis:
    [x[..., nrb-halo:], x, x[..., :halo]]. Exact for stencil operators
    because the wrapped entries only ever meet zero boundary blocks."""
    nrb = xf.shape[-1]
    if halo > nrb:
        raise ValueError(f"halo {halo} exceeds the node count {nrb}")
    return torch.cat([xf[..., nrb - halo:], xf, xf[..., :halo]], dim=-1)


def stencil_scan_accumulate(blocks_t: torch.Tensor, offsets, x_ext: torch.Tensor,
                            halo: int) -> torch.Tensor:
    """Lane-major stencil SpMM oracle.

    blocks_t: (S, br, br, nrb); x_ext: (t, br, nrb + 2·halo) with halos
    attached -> y (t, br, nrb)."""
    _, br, _, nrb = blocks_t.shape
    t = x_ext.shape[0]
    y = [torch.zeros((t, nrb), dtype=x_ext.dtype, device=x_ext.device)
         for _ in range(br)]
    for s, off in enumerate(offsets):
        xs = x_ext[:, :, halo + off:halo + off + nrb]
        for m in range(br):
            acc = y[m]
            for k in range(br):
                acc = acc + blocks_t[s, m, k][None, :] * xs[:, k, :]
            y[m] = acc
    return torch.stack(y, dim=1)


def stencil_scan_accumulate_df(blocks_t: torch.Tensor, offsets,
                               x_ext: torch.Tensor, halo: int):
    """Lane-major stencil SpMM in double-float: returns (y_hi, y_lo).

    Same contraction as stencil_scan_accumulate, with every product an
    error-free two_prod and every accumulation a compensated two_sum, so
    (y_hi, y_lo) carries ~49 mantissa bits. Used once per refinement round
    for the residual, where a plain f32 SpMM's rounding floor (~1e-5
    relative) would cap the attainable tolerance."""
    _, br, _, nrb = blocks_t.shape
    t = x_ext.shape[0]
    z = torch.zeros((t, nrb), dtype=x_ext.dtype, device=x_ext.device)
    hi = [z] * br
    lo = [z] * br
    for s, off in enumerate(offsets):
        xs = x_ext[:, :, halo + off:halo + off + nrb]
        for m in range(br):
            h, l = hi[m], lo[m]
            for k in range(br):
                p, e = two_prod(blocks_t[s, m, k][None, :], xs[:, k, :])
                h, e1 = two_sum(h, p)
                l = l + (e1 + e)
            hi[m], lo[m] = h, l
    return torch.stack(hi, dim=1), torch.stack(lo, dim=1)
