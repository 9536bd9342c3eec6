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
  the hand-written kernel (``csrc/block_ell.cu``) on the blocks' nonzero
  entries (``formats.py::pack_block_ell_entries``), CPU tensors run
  ``block_ell_spmm``; anything else raises.
* ``block_ell_entries_spmm`` — the same product on the packed entries, plain
  PyTorch (a gather, then a sum in slot order): the tests hold the pack to
  the JAX package with it; no path of the port calls it.
* ``dia_ell_spmm`` — hybrid DIA+ELL: one shifted FMA per promoted
  diagonal (``dia_window_spmm``) plus the ELL remainder (XLA in the JAX
  package, plain PyTorch here). The driver's ``fmt="dia"`` on row-major
  panels calls ``dia_window_spmm`` on its ring window, on one shard or
  many.

Stencil formats. Every stencil kernel below launches the one hand-written
kernel of ``csrc/stencil.cu`` with its own index maps (panel rows, columns,
block rows); CPU tensors run the plain version, and a CUDA tensor the
kernel does not take raises. Each wrapper counts its own launches. The
lane-major wrappers of the LORASC path (B2a, B2b) take f32 or bf16 blocks
with an f32 panel and give an f32 result, as the TPU kernels promote bf16
blocks; the kernel widens each bf16 entry to f32 (exact) and sums in the
f32 instance's order, and the plain versions widen the table first. They
also take f64 blocks with an f64 panel (the f64 instance, f64 sums; the
JAX package runs this product in f64 through XLA): the f64
``StencilLorascECG`` on the card. B1, B3 and B4 take f32 blocks on the
card (B3 also f64, through B2a's maps): no path of the port sends them
bf16 tables, nor B1 and B4 f64 ones (ROADMAP.md queue B).

* ``stencil_flat_ext`` (B1) — the flat stencil SpMM on a pre-extended
  k-major panel (the TPU kernel ``prealps_tpu/ops/spmm.py::stencil_flat_ext``);
  also the br = 1 operator of ``fmt="dia"`` on lane-major panels. Plain
  version: ``stencil_flat_ext_ref``, with the TPU kernel's summation order
  (offset, then m, then k).
* ``stencil_bsr_spmm_t`` — the lane-major stencil SpMM with wrap halos,
  (t, br, nrb) -> (t, br, nrb), at any width: the operator of the LORASC
  path. It makes its panel contiguous and calls B2a.
* ``stencil_bsr_spmm_t_pallas_bs`` (B2a), ``stencil_bsr_spmm_t_pallas``
  (B3) and ``stencil_pallas_bs_ext`` (B2b) — the lane-major stencil SpMM
  with wrap halos taken inside (B2a, B3: the same function), and on a
  pre-extended (t, br, nrb + 2·halo) panel (B2b). Plain version:
  ``stencil_scan_accumulate`` (after ``extend_wrap`` for B2a and B3).
* ``stencil_spmm_planar`` (B4) — the planar panel (t, br·nrb) with the
  plane-major block table of ``stencil_blocks_planar``. Plain version:
  ``stencil_spmm_planar_ref``.
* ``extend_wrap`` / ``extend_ring`` — the halo columns of a pre-extended
  panel: wrapped on one shard, from the ring neighbours on several.
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
    BlockEllEntries,
    BlockEllMatrix,
    DiaEllMatrix,
    EllMatrix,
    StencilBsrTMatrix,
)
from prealps_tpu_torch.parallel.mesh import (
    all_gather,
    rank_of,
    ring_exchange,
    size_of,
    timing_no_collectives,
)


def ell_spmm(a: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in ELL. x: (ncols, t) -> y: (n, t)."""
    return torch.einsum("nl,nlt->nt", a.vals, x[a.cols])


def dia_window_spmm(diags: torch.Tensor, offsets, x_ext: torch.Tensor,
                    halo: int) -> torch.Tensor:
    """Σ_d diags[d][:, None] · x_ext[halo + off_d : halo + off_d + m]: the
    promoted diagonals (D, m) on a (m + 2·halo, t) panel extended by
    ``halo`` >= max|offset| rows each side, one broadcast FMA per diagonal
    in offset order."""
    m = diags.shape[1]
    y = torch.zeros((m, x_ext.shape[1]), dtype=x_ext.dtype, device=x_ext.device)
    for d, off in enumerate(offsets):
        y = y + diags[d][:, None] * x_ext[halo + off:halo + off + m]
    return y


def dia_ell_spmm(a: DiaEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for hybrid DIA+ELL. x: (n, t) -> y: (n, t).

    ``dia_window_spmm`` on the zero-padded panel; only the remainder
    gathers."""
    halo = max(abs(o) for o in a.offsets)
    x_pad = torch.nn.functional.pad(x, (0, 0, halo, halo))
    y = dia_window_spmm(a.diags, a.offsets, x_pad, halo)
    if a.rem is not None:
        y = y + ell_spmm(a.rem, x)
    return y


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


def block_ell_entries_spmm(entries: BlockEllEntries, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the packed entries, plain PyTorch -> (n_pad, t): the
    rows padded to the longest with zeros, then one gather and one
    multiply-add per slot, in slot order."""
    n = entries.row_ptr.numel() - 1
    counts = torch.diff(entries.row_ptr.long())
    width = int(counts.max()) if n else 0
    rows = torch.repeat_interleave(torch.arange(n, device=x.device), counts)
    slot = (torch.arange(entries.nnz, device=x.device)
            - torch.repeat_interleave(entries.row_ptr[:-1].long(), counts))
    vals = torch.zeros((n, width), dtype=entries.vals.dtype, device=x.device)
    cols = torch.zeros((n, width), dtype=torch.int64, device=x.device)
    vals[rows, slot] = entries.vals
    cols[rows, slot] = entries.cols.long()
    y = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for s in range(width):
        y = y + vals[:, s, None] * x[cols[:, s]]
    return y


def block_ell_spmm_pallas(a: BlockEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMM -> (n_pad, t); x: (ncols_pad, t) = (a.shape[1], t).

    CPU tensors run ``block_ell_spmm``. CUDA tensors launch the CUDA kernel
    on ``a.entries`` (``pack_block_ell_entries``, packed once per operator:
    a matrix without them raises), which takes f32 contiguous operands on
    one card, and count one launch in ``block_ell_spmm_pallas.launches``.
    """
    blocks, blkcols = a.blocks, a.blkcols
    if blocks.dim() != 4 or blkcols.shape != blocks.shape[:2]:
        raise ValueError(f"block-ELL blocks {tuple(blocks.shape)} and blkcols "
                         f"{tuple(blkcols.shape)} do not match")
    nrb, _, bm, bk = blocks.shape
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
    e = a.entries
    if e is None:
        raise ValueError("block_ell_spmm_pallas: the matrix carries no packed "
                         "entries; pack them once with "
                         "formats.pack_block_ell_entries(mat)")
    if ({e.row_ptr.device, e.cols.device, e.vals.device} != {x.device}
            or e.row_ptr.dtype != torch.int32 or e.cols.dtype != torch.int32
            or e.vals.dtype != torch.float32 or e.row_ptr.numel() != nrb * bm + 1):
        raise ValueError("block_ell_spmm_pallas: entries must be int32 row_ptr "
                         f"({nrb * bm + 1},), int32 cols and f32 vals on {x.device}")
    if not (x.is_contiguous() and e.row_ptr.is_contiguous() and e.cols.is_contiguous()
            and e.vals.is_contiguous()):
        raise ValueError("block_ell_spmm_pallas kernel takes contiguous operands")
    if e.cols.data_ptr() % 16 or e.vals.data_ptr() % 16:
        raise ValueError("block_ell_spmm_pallas kernel takes 16-byte aligned "
                         "entries")
    t = x.shape[1]
    if t > 1024:
        raise ValueError(f"block_ell_spmm_pallas kernel takes t <= 1024, got {t}")
    y = torch.empty((nrb * bm, t), dtype=torch.float32, device=x.device)
    if nrb == 0 or t == 0:
        return y
    _kernels.block_ell_f32(e, x, y)
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
                        f"{blocks_flat.dtype} and {x_ext.dtype} (bf16 flat "
                        "blocks have no port path: ROADMAP.md queue B)")
    if not (blocks_flat.is_contiguous() and x_ext.is_contiguous()):
        raise ValueError("stencil_flat_ext kernel takes contiguous operands")
    nrb = blocks_flat.shape[1]
    t = x_ext.shape[0] // br
    y = torch.empty((br * t, nrb), dtype=torch.float32,
                    device=blocks_flat.device)
    if nrb == 0 or t == 0:
        return y
    _kernels.stencil(blocks_flat, offsets, x_ext, y, br=br, t=t, nrb=nrb,
                         ncol=x_ext.shape[1], lead=halo, kmajor=True,
                         wrap=False, planar=False, what="stencil_flat_ext")
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


def extend_ring(xf: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Attach ring halos along the last (node) axis on a sharded panel:
    [left, x, right], ``left`` the last ``halo`` nodes of rank − 1 and
    ``right`` the first ``halo`` of rank + 1 (mod the group's size), as the
    JAX driver's two ``ppermute`` build it (prealps_tpu/parallel/driver.py:
    735-742). Exact for stencil operators: the wrapped entries meet zero
    boundary blocks. A shard thinner than the halo gathers the whole panel
    from every rank instead and takes its window of the panel's periodic
    extension, nodes s·nrb − halo to (s + 1)·nrb + halo (mod the node
    count): the JAX driver's all-gather-and-roll branch (:749-754), which
    also holds where the window is longer than the panel. One shard (or no
    group) is ``extend_wrap``, and so is every shard under the timing
    ablation (``mesh.timing_no_collectives``: the JAX driver's
    prealps_tpu/parallel/driver.py:727-733; wrong results by construction,
    no communication)."""
    world = size_of(group)
    if world == 1 or timing_no_collectives():
        return extend_wrap(xf, halo)
    nrb = xf.shape[-1]
    if halo <= nrb:
        left, right = ring_exchange(xf[..., :halo], xf[..., nrb - halo:], group)
        return torch.cat([left, xf, right], dim=-1)
    x_all = all_gather(xf, group, dim=-1)
    first = rank_of(group) * nrb - halo
    cols = torch.arange(first, first + nrb + 2 * halo, device=xf.device) % (world * nrb)
    return x_all[..., cols]


def stencil_scan_accumulate(blocks_t: torch.Tensor, offsets, x_ext: torch.Tensor,
                            halo: int) -> torch.Tensor:
    """Lane-major stencil SpMM oracle.

    blocks_t: (S, br, br, nrb), in the panel's type or bf16 (widened to it
    first, exactly); x_ext: (t, br, nrb + 2·halo) with halos attached -> y
    (t, br, nrb)."""
    blocks_t = blocks_t.to(x_ext.dtype)
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
    relative) would cap the attainable tolerance. bf16 blocks are widened
    to the panel's type first (exactly)."""
    blocks_t = blocks_t.to(x_ext.dtype)
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
    if not ((blocks_t.dtype in (torch.float32, torch.bfloat16)
             and x.dtype == torch.float32)
            or (blocks_t.dtype == torch.float64 and x.dtype == torch.float64)):
        raise TypeError(f"{name} kernel takes float32 or bfloat16 blocks with a "
                        "float32 panel, or float64 blocks with a float64 panel, "
                        f"got {blocks_t.dtype} and {x.dtype}")
    if not (blocks_t.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous operands")
    return False


def _lane_launch(blocks, offsets, x, y, lead, *, wrap, what, planar=False):
    """Launch the stencil kernel on a lane-major panel x (t, br, ncol) into
    y (t, br, nrb)."""
    t, br, nrb = y.shape
    _kernels.stencil(blocks, offsets, x, y, br=br, t=t, nrb=nrb,
                         ncol=x.shape[2], lead=lead, kmajor=False, wrap=wrap,
                         planar=planar, what=what)


def _wrap_product(name: str, a: StencilBsrTMatrix, xt: torch.Tensor):
    """The lane-major product with wrap halos of B2a and B3: (y, whether
    the kernel was launched). CPU tensors run ``stencil_scan_accumulate``
    on ``extend_wrap(xt)``; CUDA tensors launch the kernel (f32 panel with
    f32 or bf16 blocks, or f64 panel and blocks; contiguous, one card),
    which wraps the columns itself."""
    offsets = tuple(int(o) for o in a.offsets)
    halo = max(abs(o) for o in offsets)
    if _check_lane_args(name, a.blocks_t, offsets, xt, 0, wrap=True):
        return stencil_scan_accumulate(a.blocks_t, offsets,
                                       extend_wrap(xt, halo), halo), False
    y = torch.empty(xt.shape, dtype=xt.dtype, device=xt.device)
    if y.numel() == 0:
        return y, False
    _lane_launch(a.blocks_t, offsets, xt, y, 0, wrap=True, what=name)
    return y, True


def stencil_bsr_spmm_t_pallas_bs(a: StencilBsrTMatrix, xt: torch.Tensor) -> torch.Tensor:
    """B2a: lane-major stencil SpMM with wrap halos, (t, br, nrb) -> same
    (``_wrap_product``); counts its launches in
    ``stencil_bsr_spmm_t_pallas_bs.launches`` and, of those, the launches
    of the bf16-block instance in ``.bf16_launches`` and of the f64
    instance in ``.f64_launches``."""
    y, launched = _wrap_product("stencil_bsr_spmm_t_pallas_bs", a, xt)
    stencil_bsr_spmm_t_pallas_bs.launches += launched
    stencil_bsr_spmm_t_pallas_bs.bf16_launches += (
        launched and a.blocks_t.dtype == torch.bfloat16)
    stencil_bsr_spmm_t_pallas_bs.f64_launches += (
        launched and a.blocks_t.dtype == torch.float64)
    return y


stencil_bsr_spmm_t_pallas_bs.launches = 0
stencil_bsr_spmm_t_pallas_bs.bf16_launches = 0
stencil_bsr_spmm_t_pallas_bs.f64_launches = 0


def stencil_pallas_bs_ext(blocks_t: torch.Tensor, offsets, x_ext: torch.Tensor,
                          halo: int) -> torch.Tensor:
    """B2b: lane-major stencil SpMM on a pre-extended panel,
    x_ext (t, br, nrb + 2·halo) -> (t, br, nrb).

    CPU tensors run ``stencil_scan_accumulate``. CUDA tensors launch the
    CUDA kernel (f32 panel with f32 or bf16 blocks, or f64 panel and
    blocks; contiguous, one card) and count one launch in
    ``stencil_pallas_bs_ext.launches`` (and in ``.bf16_launches`` for bf16
    blocks, ``.f64_launches`` for f64 ones).
    """
    offsets = tuple(int(o) for o in offsets)
    if _check_lane_args("stencil_pallas_bs_ext", blocks_t, offsets, x_ext, halo,
                        wrap=False):
        return stencil_scan_accumulate(blocks_t, offsets, x_ext, halo)
    t, br = x_ext.shape[:2]
    y = torch.empty((t, br, blocks_t.shape[3]), dtype=x_ext.dtype,
                    device=x_ext.device)
    if y.numel() == 0:
        return y
    _lane_launch(blocks_t, offsets, x_ext, y, halo, wrap=False,
                 what="stencil_pallas_bs_ext")
    stencil_pallas_bs_ext.launches += 1
    stencil_pallas_bs_ext.bf16_launches += blocks_t.dtype == torch.bfloat16
    stencil_pallas_bs_ext.f64_launches += blocks_t.dtype == torch.float64
    return y


stencil_pallas_bs_ext.launches = 0
stencil_pallas_bs_ext.bf16_launches = 0
stencil_pallas_bs_ext.f64_launches = 0


def stencil_bsr_spmm_t_pallas(a: StencilBsrTMatrix, xt: torch.Tensor) -> torch.Tensor:
    """B3: lane-major stencil SpMM with wrap halos, (t, br, nrb) -> same
    (the TPU kernel of the same name, the SpMM sweep's ``stencil_t_pallas``).

    The TPU kernel reads its wrap-extended, zero-padded panel at
    i·chunk + halo + off, which is B2a's wrap map, so it is the same
    product (``_wrap_product``), counted in
    ``stencil_bsr_spmm_t_pallas.launches``. Its kernel takes f32 blocks
    (and, B2a's maps being its own, f64 blocks with an f64 panel): no port
    path sends bf16 blocks through B3.
    """
    if a.blocks_t.dtype == torch.bfloat16 and xt.device.type == "cuda":
        raise TypeError("stencil_bsr_spmm_t_pallas kernel takes float32 blocks, "
                        "got torch.bfloat16 (bf16 blocks through B3 have no "
                        "port path: ROADMAP.md queue B)")
    y, launched = _wrap_product("stencil_bsr_spmm_t_pallas", a, xt)
    stencil_bsr_spmm_t_pallas.launches += launched
    return y


stencil_bsr_spmm_t_pallas.launches = 0


def stencil_blocks_planar(blocks_t: torch.Tensor) -> torch.Tensor:
    """(S, br, br, nrb) -> (br, S·br, nrb) output-plane-major block table:
    row s·br + k of plane m is block entry (m, k) of offset s."""
    s, br, _, nrb = blocks_t.shape
    return blocks_t.permute(1, 0, 2, 3).reshape(br, s * br, nrb)


def stencil_spmm_planar_ref(blocks3: torch.Tensor, x2: torch.Tensor, *,
                            offsets, br: int, nrb: int) -> torch.Tensor:
    """Plain planar stencil SpMM: x2 (t, br·nrb) -> (t, br·nrb), through
    the lane-major oracle (the planar panel is a (t, br, nrb) panel)."""
    t_dim = x2.shape[0]
    s = len(offsets)
    blocks_t = blocks3.reshape(br, s, br, nrb).permute(1, 0, 2, 3)
    halo = max(abs(o) for o in offsets)
    x_ext = extend_wrap(x2.reshape(t_dim, br, nrb), halo)
    y = stencil_scan_accumulate(blocks_t, offsets, x_ext, halo)
    return y.reshape(t_dim, br * nrb)


def stencil_spmm_planar(blocks3: torch.Tensor, x2: torch.Tensor, *, offsets,
                        br: int, nrb: int) -> torch.Tensor:
    """B4: planar stencil SpMM, x2 (t, br·nrb) -> (t, br·nrb), blocks3
    (br, S·br, nrb) from ``stencil_blocks_planar``, wrap halos (the TPU
    kernel of the same name).

    CPU tensors run ``stencil_spmm_planar_ref``. CUDA tensors launch the
    stencil kernel with the plane-major block map (f32, contiguous, one
    card) and count one launch in ``stencil_spmm_planar.launches``.
    """
    offsets = tuple(int(o) for o in offsets)
    s_max = len(offsets)
    if blocks3.dim() != 3 or x2.dim() != 2:
        raise ValueError(f"stencil_spmm_planar: blocks3 must be (br, S·br, nrb) "
                         f"and x2 (t, br·nrb), got {tuple(blocks3.shape)} and "
                         f"{tuple(x2.shape)}")
    if tuple(blocks3.shape) != (br, s_max * br, nrb) or x2.shape[1] != br * nrb:
        raise ValueError(f"stencil_spmm_planar: blocks3 {tuple(blocks3.shape)} "
                         f"and x2 {tuple(x2.shape)} do not match br={br}, "
                         f"nrb={nrb} and {s_max} offsets")
    if offsets and max(abs(o) for o in offsets) > nrb:
        raise ValueError(f"stencil_spmm_planar: an offset exceeds the node "
                         f"count {nrb}")
    if blocks3.device.type == "cpu" and x2.device.type == "cpu":
        return stencil_spmm_planar_ref(blocks3, x2, offsets=offsets, br=br, nrb=nrb)
    if blocks3.device.type != "cuda" or x2.device != blocks3.device:
        raise ValueError(f"stencil_spmm_planar: operands on {blocks3.device} "
                         f"and {x2.device}; both must be on one CUDA card (or "
                         "both on the CPU)")
    if blocks3.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError(f"stencil_spmm_planar kernel takes float32, got "
                        f"{blocks3.dtype} and {x2.dtype} (bf16 planar blocks "
                        "have no port path: ROADMAP.md queue B)")
    if not (blocks3.is_contiguous() and x2.is_contiguous()):
        raise ValueError("stencil_spmm_planar kernel takes contiguous operands")
    t = x2.shape[0]
    y = torch.empty((t, br * nrb), dtype=torch.float32, device=x2.device)
    if y.numel() == 0:
        return y
    _lane_launch(blocks3, offsets, x2.view(t, br, nrb), y.view(t, br, nrb), 0,
                 wrap=True, planar=True, what="stencil_spmm_planar")
    stencil_spmm_planar.launches += 1
    return y


stencil_spmm_planar.launches = 0


def stencil_bsr_spmm_t(a: StencilBsrTMatrix, xt: torch.Tensor) -> torch.Tensor:
    """Lane-major stencil SpMM: xt (t, br, nrb) -> yt (t, br, nrb), wrap
    halos. Every width goes to B2a (on the card the lane-major product is
    the natural form; the TPU's relayouts to the flat kernel for narrow
    panels have no counterpart here)."""
    return stencil_bsr_spmm_t_pallas_bs(a, xt.contiguous())
