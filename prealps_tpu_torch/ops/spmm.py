"""SpMM: the CUDA kernels' wrappers and their plain versions.

General formats, row-major (n, t) panels:

* ``ell_spmm`` — ELL gather + contraction (the XLA formulation of
  ``prealps_tpu/ops/spmm.py::ell_spmm``).
* ``ell_gather_spmm_df`` — the same contraction in double-float (hi, lo),
  for the refinement residual of ``fmt="ell"``; eager PyTorch, like
  ``stencil_scan_accumulate_df`` below.
* ``block_ell_spmm`` — block-ELL gather + contraction: the plain version of
  the block-ELL kernel, and the route of ``fmt="block_ell_xla"``.
* ``block_ell_spmm_pallas`` — the block-ELL SpMM (the TPU kernel
  ``prealps_tpu/ops/spmm.py::block_ell_spmm_pallas``). CUDA tensors launch
  the hand-written kernel (``csrc/block_ell.cu``), CPU tensors run
  ``block_ell_spmm``; anything else raises.

Stencil formats, lane-major panels:

* ``stencil_flat_ext`` — the flat stencil SpMM on a pre-extended k-major
  panel (the TPU kernel ``prealps_tpu/ops/spmm.py::stencil_flat_ext``). For
  CUDA tensors it launches the hand-written kernel
  (``csrc/stencil_flat.cu``); for CPU tensors it runs
  ``stencil_flat_ext_ref``. There is no other route: a CUDA tensor that the
  kernel does not take raises.
* ``stencil_flat_ext_ref`` — the same product in plain PyTorch, with the
  TPU kernel's summation order (offset, then m, then k).
* ``stencil_bsr_spmm_t`` — the lane-major stencil SpMM with wrap halos,
  (t, br, nrb) -> (t, br, nrb), at any width: the operator of the LORASC
  path. It makes its panel contiguous and calls B2a.
* ``stencil_bsr_spmm_t_pallas_bs`` (B2a) and ``stencil_pallas_bs_ext``
  (B2b) — the lane-major stencil SpMM with wrap halos taken inside, and on
  a pre-extended (t, br, nrb + 2·halo) panel (the TPU kernels of the same
  names in ``prealps_tpu/ops/spmm.py``, one body). CUDA tensors launch the
  hand-written kernel (``csrc/stencil_lane.cu``), CPU tensors run
  ``stencil_scan_accumulate`` (after ``extend_wrap`` for B2a).
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
from prealps_tpu_torch.ops.formats import (
    BlockEllMatrix,
    EllMatrix,
    StencilBsrTMatrix,
)


def ell_spmm(a: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in ELL. x: (ncols, t) -> y: (n, t)."""
    return torch.einsum("nl,nlt->nt", a.vals, x[a.cols])


def ell_gather_spmm_df(vals: torch.Tensor, gathered: torch.Tensor):
    """einsum('ml,mlt->mt') in double-float: returns (y_hi, y_lo).

    vals: (m, L) ELL values; gathered: (m, L, t) pre-gathered x rows. Every
    product is an error-free two_prod and the L-axis reduction a compensated
    two_sum, in slot order (the JAX version's scan)."""
    p, e = two_prod(vals[:, :, None], gathered)     # (m, L, t)
    hi = torch.zeros((p.shape[0], p.shape[2]), dtype=p.dtype, device=p.device)
    lo = torch.zeros_like(hi)
    for j in range(p.shape[1]):
        hi, e1 = two_sum(hi, p[:, j])
        lo = lo + (e1 + e[:, j])
    return hi, lo


def block_ell_spmm(a: BlockEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in block-ELL, plain PyTorch. x: (ncols_pad, t).

    Gathers the (nrb, S, bk, t) tensor of referenced X blocks first (t/bm
    times the bytes of the blocks themselves), then contracts."""
    nrb, _, bm, bk = a.blocks.shape
    t = x.shape[1]
    gathered = x.reshape(-1, bk, t)[a.blkcols]       # (nrb, S, bk, t)
    y = torch.einsum("rsmk,rskt->rmt", a.blocks, gathered)
    return y.reshape(nrb * bm, t)


def block_ell_spmm_pallas(a: BlockEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMM -> (n_pad, t); x: (ncols_pad, t) = (a.shape[1], t).

    CPU tensors run ``block_ell_spmm``. CUDA tensors launch the CUDA kernel,
    which takes f32 contiguous operands on one card with bm = 8 and bk a
    multiple of 8 up to 128, and count one launch in
    ``block_ell_spmm_pallas.launches``.
    """
    blocks, blkcols = a.blocks, a.blkcols
    if blocks.dim() != 4 or blkcols.shape != blocks.shape[:2]:
        raise ValueError(f"block-ELL blocks {tuple(blocks.shape)} and blkcols "
                         f"{tuple(blkcols.shape)} do not match")
    nrb, s_max, bm, bk = blocks.shape
    if x.dim() != 2 or x.shape[0] != a.shape[1] or x.shape[0] % bk:
        raise ValueError(f"x has shape {tuple(x.shape)}; expected "
                         f"({a.shape[1]}, t) with a multiple of bk={bk} rows")
    devs = {blocks.device, blkcols.device, x.device}
    if devs == {torch.device("cpu")}:
        return block_ell_spmm(a, x)
    if len(devs) != 1 or blocks.device.type != "cuda":
        raise ValueError(f"block_ell_spmm_pallas: operands on {sorted(map(str, devs))}; "
                         "all must be on one CUDA card (or all on the CPU)")
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"block_ell_spmm_pallas kernel takes float32, got "
                        f"{blocks.dtype} and {x.dtype}")
    if blkcols.dtype != torch.int32:
        raise TypeError(f"blkcols must be int32, got {blkcols.dtype}")
    if not (blocks.is_contiguous() and blkcols.is_contiguous() and x.is_contiguous()):
        raise ValueError("block_ell_spmm_pallas kernel takes contiguous operands")
    if bm != 8 or bk % 8 or not 8 <= bk <= 128:
        raise ValueError(f"block_ell_spmm_pallas kernel takes bm = 8 and bk a "
                         f"multiple of 8 up to 128, got bm={bm} bk={bk}")
    t = x.shape[1]
    y = torch.empty((nrb * bm, t), dtype=torch.float32, device=x.device)
    if nrb == 0 or t == 0:
        return y
    _kernels.block_ell_f32(blocks, blkcols, x, y, s_max, bk, t)
    block_ell_spmm_pallas.launches += 1
    return y


block_ell_spmm_pallas.launches = 0


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


def _check_lane_args(name, blocks_t, offsets, x, halo, wrap):
    """Shape, device, type and layout checks of B2a / B2b; returns True
    when every operand lies on the CPU (the plain route)."""
    if blocks_t.dim() != 4 or x.dim() != 3:
        raise ValueError(f"{name}: blocks_t must be (S, br, br, nrb) and the "
                         f"panel (t, br, ncol), got {tuple(blocks_t.shape)} "
                         f"and {tuple(x.shape)}")
    s_max, br, br2, nrb = blocks_t.shape
    if s_max != len(offsets) or br2 != br or x.shape[1] != br:
        raise ValueError(f"{name}: blocks_t {tuple(blocks_t.shape)} does not "
                         f"match {len(offsets)} offsets and panel "
                         f"{tuple(x.shape)}")
    if x.shape[2] != nrb + 2 * halo:
        raise ValueError(f"{name}: panel has {x.shape[2]} columns; expected "
                         f"nrb + 2·halo = {nrb + 2 * halo}")
    reach = nrb if wrap else halo
    if offsets and max(abs(o) for o in offsets) > reach:
        raise ValueError(f"{name}: an offset exceeds the "
                         f"{'node count' if wrap else 'halo'} {reach}")
    if blocks_t.device.type == "cpu" and x.device.type == "cpu":
        return True
    if blocks_t.device.type != "cuda" or x.device != blocks_t.device:
        raise ValueError(f"{name}: operands on {blocks_t.device} and "
                         f"{x.device}; both must be on one CUDA card (or both "
                         "on the CPU)")
    if blocks_t.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32, got {blocks_t.dtype} "
                        f"and {x.dtype}")
    if not (blocks_t.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous operands")
    return False


def stencil_bsr_spmm_t_pallas_bs(a: StencilBsrTMatrix, xt: torch.Tensor) -> torch.Tensor:
    """B2a: lane-major stencil SpMM with wrap halos, (t, br, nrb) -> same.

    CPU tensors run ``stencil_scan_accumulate`` on ``extend_wrap(xt)``.
    CUDA tensors launch the CUDA kernel, which takes f32 contiguous operands
    on one card and wraps the columns itself, and count one launch in
    ``stencil_bsr_spmm_t_pallas_bs.launches``.
    """
    offsets = tuple(int(o) for o in a.offsets)
    halo = max(abs(o) for o in offsets)
    if _check_lane_args("stencil_bsr_spmm_t_pallas_bs", a.blocks_t, offsets,
                        xt, 0, wrap=True):
        return stencil_scan_accumulate(a.blocks_t, offsets,
                                       extend_wrap(xt, halo), halo)
    y = torch.empty(xt.shape, dtype=torch.float32, device=xt.device)
    if y.numel() == 0:
        return y
    _kernels.stencil_lane_f32(a.blocks_t, offsets, xt, y, 0, wrap=True)
    stencil_bsr_spmm_t_pallas_bs.launches += 1
    return y


stencil_bsr_spmm_t_pallas_bs.launches = 0


def stencil_pallas_bs_ext(blocks_t: torch.Tensor, offsets, x_ext: torch.Tensor,
                          halo: int) -> torch.Tensor:
    """B2b: lane-major stencil SpMM on a pre-extended panel,
    x_ext (t, br, nrb + 2·halo) -> (t, br, nrb).

    CPU tensors run ``stencil_scan_accumulate``. CUDA tensors launch the
    CUDA kernel (f32, contiguous, one card) and count one launch in
    ``stencil_pallas_bs_ext.launches``.
    """
    offsets = tuple(int(o) for o in offsets)
    if _check_lane_args("stencil_pallas_bs_ext", blocks_t, offsets, x_ext, halo,
                        wrap=False):
        return stencil_scan_accumulate(blocks_t, offsets, x_ext, halo)
    t, br = x_ext.shape[:2]
    y = torch.empty((t, br, blocks_t.shape[3]), dtype=torch.float32,
                    device=x_ext.device)
    if y.numel() == 0:
        return y
    _kernels.stencil_lane_f32(blocks_t, offsets, x_ext, y, halo, wrap=False)
    stencil_pallas_bs_ext.launches += 1
    return y


stencil_pallas_bs_ext.launches = 0


def stencil_bsr_spmm_t(a: StencilBsrTMatrix, xt: torch.Tensor) -> torch.Tensor:
    """Lane-major stencil SpMM: xt (t, br, nrb) -> yt (t, br, nrb), wrap
    halos. Every width goes to B2a (on the card the lane-major product is
    the natural form; the TPU's relayouts to the flat kernel for narrow
    panels have no counterpart here)."""
    return stencil_bsr_spmm_t_pallas_bs(a, xt.contiguous())
