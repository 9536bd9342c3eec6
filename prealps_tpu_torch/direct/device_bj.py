"""On-device block-Jacobi construction from the stencil operator.

Counterparts of ``prealps_tpu/direct/device_bj.py`` (XLA there, plain
PyTorch here): the dense diagonal blocks are assembled on the device from
the stencil block table, inverted by batched Cholesky (or Newton–Schulz
GEMMs), and applied as batched GEMMs:

* ``bj_apply_flat``: flat (nb, mb, mb) inverses, one batched GEMM (the
  driver's "bj_flat" and the block part of bj2l);
* ``bj_apply_lane_major``: 5-D inverses, stored in bf16 with the
  split-input apply and f32 sums (the driver's "bj_lane");
* ``bj_apply_grouped``: one inverse per group of identical blocks
  (``csr_slab_groups``), one GEMM per group (the driver's "bj_dedup").

Beside them, ``bj_apply_pallas`` is the flat apply through a hand-written
CUDA kernel (``csrc/bj_apply.cu``) on blocks packed to a multiple of 128
rows, reading and writing the lane-major panels directly; it is checked and
timed against the GEMM, and no driver path calls it.

Index convention inside a block (component-major): block b holds nodes
[b·mbn, (b+1)·mbn); its row m·mbn + rl is component m of local node rl. A
lane-major panel (t, br, nrb) maps onto blocks as
``z.reshape(t, br, nb, mbn).permute(0, 2, 1, 3)`` — getting this wrong
still converges, only slower.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.ops import _kernels
from prealps_tpu_torch.utils.timing import count_launches


def dense_blocks_from_stencil(blocks_t: torch.Tensor, offsets, mbn: int) -> torch.Tensor:
    """(S, br, br, nrb) stencil -> (nb, br, mbn, br, mbn) dense diagonal
    blocks, nb = nrb // mbn. Couplings that leave a block are dropped."""
    s_max, br, _, nrb = blocks_t.shape
    if nrb % mbn:
        raise ValueError(f"mbn={mbn} must divide the node count {nrb}")
    nb = nrb // mbn
    dev = blocks_t.device
    dense = torch.zeros((nb, br, mbn, br, mbn), dtype=blocks_t.dtype, device=dev)
    r = torch.arange(nrb, device=dev)
    b_idx = (r // mbn)[None, None, :]
    rl = (r % mbn)[None, None, :]
    m_idx = torch.arange(br, device=dev)[:, None, None]
    k_idx = torch.arange(br, device=dev)[None, :, None]
    for s, off in enumerate(offsets):
        tgt = rl + off
        valid = (tgt >= 0) & (tgt < mbn)
        tgt_safe = tgt.clamp(0, mbn - 1)
        vals = torch.where(valid, blocks_t[s], torch.zeros((), dtype=blocks_t.dtype,
                                                            device=dev))
        idx = torch.broadcast_tensors(b_idx, m_idx, rl, k_idx, tgt_safe)
        dense.index_put_(idx, vals, accumulate=True)
    return dense


def batched_spd_inverse(dense5: torch.Tensor, method: str = "chol") -> torch.Tensor:
    """Explicit inverse of each (mb × mb) SPD block; 5-D in and out
    (nb, br, mbn, br, mbn).

    method="chol": batched Cholesky of the symmetrised block, triangular
    inverse, Lᵀ⁻¹L⁻¹. method="newton": Newton–Schulz, X ← X (2I − A X) from
    X₀ = Aᵀ/‖A‖₁² (which converges for SPD A), 50 steps of two batched
    GEMMs each, then symmetrised: the JAX package's GEMM-only inverse.
    Both run in the blocks' dtype; under ``config.strict_fp32`` f32 GEMMs
    take no TF32 pass."""
    nb, br, mbn, _, _ = dense5.shape
    mb = br * mbn
    a = dense5.reshape(nb, mb, mb)
    if method == "chol":
        a = 0.5 * (a + a.mT)
        low = torch.linalg.cholesky(a)
        eye = torch.eye(mb, dtype=a.dtype, device=a.device).expand(nb, mb, mb)
        linv = torch.linalg.solve_triangular(low, eye, upper=False)
        inv = linv.mT @ linv
    elif method == "newton":
        norm1 = a.abs().sum(dim=2).amax(dim=1)
        x = (a / (norm1 * norm1)[:, None, None]).mT
        eye2 = 2.0 * torch.eye(mb, dtype=a.dtype, device=a.device)
        for _ in range(50):
            x = torch.bmm(x, eye2 - torch.bmm(a, x))
        inv = 0.5 * (x + x.mT)
    else:
        raise ValueError(f"unknown method {method!r}")
    return inv.reshape(nb, br, mbn, br, mbn)


def build_device_block_jacobi(blocks_t, offsets, mbn: int,
                              method: str = "chol") -> torch.Tensor:
    """Stencil -> 5-D (nb, br, mbn, br, mbn) explicit block inverses."""
    return batched_spd_inverse(dense_blocks_from_stencil(blocks_t, offsets, mbn),
                               method)


def build_device_block_jacobi_flat(blocks_t, offsets, mbn: int,
                                   method: str = "chol") -> torch.Tensor:
    """Stencil -> FLAT (nb, mb, mb) explicit block inverses."""
    inv5 = build_device_block_jacobi(blocks_t, offsets, mbn, method)
    nb, br, mbn_, _, _ = inv5.shape
    return inv5.reshape(nb, br * mbn_, br * mbn_)


def _to_blocks(z: torch.Tensor, nb: int, rows: int) -> torch.Tensor:
    """(t, br, nrb) lane-major panel -> (nb, rows, t) block panel: row
    m·mbn + rl of block b is component m of node b·mbn + rl; rows beyond
    br·mbn are zero padding."""
    t, br, nrb = z.shape
    mbn = nrb // nb
    zb = z.reshape(t, br, nb, mbn).permute(2, 1, 3, 0).reshape(nb, br * mbn, t)
    if rows != br * mbn:
        zb = torch.nn.functional.pad(zb, (0, 0, 0, rows - br * mbn))
    return zb.contiguous()


def _from_blocks(w: torch.Tensor, br: int, mbn: int) -> torch.Tensor:
    """(nb, rows, t) block panel -> (t, br, nrb), dropping padded rows."""
    nb, _, t = w.shape
    w = w[:, :br * mbn, :].reshape(nb, br, mbn, t)
    return w.permute(3, 1, 0, 2).reshape(t, br, nb * mbn)


def bj_apply_flat(inv_flat: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """z: (t, br, nrb) -> (t, br, nrb) with flat (nb, mb, mb) inverses: one
    batched GEMM (the driver's apply for precond="bj" on the stencil path)."""
    nb, mb, _ = inv_flat.shape
    br = z.shape[1]
    w = torch.bmm(inv_flat, _to_blocks(z, nb, mb))       # (nb, mb, t)
    return _from_blocks(w, br, mb // br)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 operands with f32 sums and an f32 result. On the card
    one bf16 GEMM with an f32 output (``out_dtype``; under
    ``config.strict_fp32`` cuBLAS keeps its reductions in f32). On the CPU,
    which has no kernel for it, the operands are upcast first: the
    products of two bf16 values are exact in f32, and the sums are f32."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def bj_apply_lane_major(inv5: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """z: (t, br, nrb) -> (t, br, nrb) with 5-D (nb, br, mbn, br, mbn)
    inverses (the JAX driver's "bj_lane" apply).

    With bf16-stored inverses the input is not rounded to bf16 as a whole
    (that makes M nonlinear at ~4e-3 and breaks the ECG recurrences): z is
    split into a bf16 high part and a bf16 remainder, stacked on the
    column axis, so the inverses are read once for both, and the two
    products are summed in f32 -- M stays linear to ~1e-6. w comes out in
    f32 (then z's dtype), never rounded to bf16. Other dtypes: one GEMM in
    the inverses' dtype."""
    nb, br, mbn, _, _ = inv5.shape
    mb = br * mbn
    t = z.shape[0]
    inv = inv5.reshape(nb, mb, mb)
    zb = _to_blocks(z, nb, mb)                              # (nb, mb, t)
    if inv5.dtype == torch.bfloat16:
        zh = zb.to(torch.bfloat16)
        zl = (zb - zh.to(zb.dtype)).to(torch.bfloat16)
        w2 = _bmm_f32(inv, torch.cat([zh, zl], dim=2))     # (nb, mb, 2t) f32
        w = w2[:, :, :t] + w2[:, :, t:]
    else:
        w = torch.bmm(inv, zb)
    return _from_blocks(w, br, mbn).to(z.dtype)


# ---------------------------------------------------------------------------
# Deduplicated block Jacobi: identical diagonal blocks stored and read once
# ---------------------------------------------------------------------------
#
# A constant-coefficient stencil operator repeats its diagonal blocks when
# the block boundary is a whole grid x-line or z-slab: every interior slab
# assembles the same dense matrix (symmetric RAC scaling keeps this). The
# grouping functions are numpy copies of the JAX package's; the apply reads
# each unique inverse once for all the blocks of its group.


def stencil_slab_groups(blocks_host: np.ndarray, mbn: int):
    """Group bitwise-identical diagonal slabs of a host stencil array.

    blocks_host: (nrb, S, br, br) numpy. Returns (rep_idx, groups): the
    first block of each group, and each group's block ids, as tuples; None
    if mbn does not divide nrb. The key is the whole slab, couplings that
    leave it included, so grouping can only over-split."""
    nrb = blocks_host.shape[0]
    if nrb % mbn:
        return None
    nb = nrb // mbn
    flat = np.ascontiguousarray(blocks_host).reshape(nb, -1)
    seen, groups = {}, []
    for b in range(nb):
        key = flat[b].tobytes()
        g = seen.get(key)
        if g is None:
            seen[key] = len(groups)
            groups.append([b])
        else:
            groups[g].append(b)
    return tuple(g[0] for g in groups), tuple(tuple(g) for g in groups)


def csr_slab_groups(a_csr, rows_per_block: int):
    """Slab grouping from the (scaled, padded) CSR matrix: the key of a
    slice of rows_per_block rows is its row lengths, relative column
    indices and values, bitwise. Returns (rep_idx, groups) like
    ``stencil_slab_groups``, or None if rows_per_block does not divide n."""
    a_csr = sp.csr_matrix(a_csr)
    n = a_csr.shape[0]
    if n % rows_per_block:
        return None
    nb = n // rows_per_block
    indptr, indices, data = a_csr.indptr, a_csr.indices, a_csr.data
    seen, groups = {}, []
    for b in range(nb):
        r0 = b * rows_per_block
        p0, p1 = indptr[r0], indptr[r0 + rows_per_block]
        key = (np.diff(indptr[r0:r0 + rows_per_block + 1]).tobytes()
               + (indices[p0:p1] - r0).tobytes() + data[p0:p1].tobytes())
        g = seen.get(key)
        if g is None:
            seen[key] = len(groups)
            groups.append([b])
        else:
            groups[g].append(b)
    return tuple(g[0] for g in groups), tuple(tuple(g) for g in groups)


def build_device_block_jacobi_grouped(blocks_t, offsets, mbn: int, rep_idx,
                                      method: str = "chol") -> torch.Tensor:
    """Invert only the groups' representative blocks: (ng, br, mbn, br, mbn)."""
    dev = blocks_t.device
    gather = torch.cat([torch.arange(r * mbn, (r + 1) * mbn, device=dev)
                        for r in rep_idx])
    return build_device_block_jacobi(blocks_t[..., gather], offsets, mbn, method)


@dataclass(frozen=True)
class BlockGroups:
    """A block grouping as device index tensors, made once at build time:
    ``order`` lists the blocks group by group, ``inv_order`` undoes it, and
    group g owns positions ``bounds[g]`` of ``order``."""

    order: torch.Tensor       # (nb,) int64
    inv_order: torch.Tensor   # (nb,) int64
    bounds: tuple             # ((start, end), ...) per group

    @property
    def num_groups(self) -> int:
        return len(self.bounds)


def block_groups(groups, device) -> BlockGroups:
    """``BlockGroups`` on ``device`` from a tuple of block-id tuples."""
    order = np.concatenate([np.asarray(g, dtype=np.int64) for g in groups])
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(order.size)
    ends = np.cumsum([len(g) for g in groups])
    bounds = tuple((int(e - len(g)), int(e)) for g, e in zip(groups, ends))
    return BlockGroups(order=torch.from_numpy(order).to(device),
                       inv_order=torch.from_numpy(inv_order).to(device),
                       bounds=bounds)


def bj_apply_grouped(inv_u: torch.Tensor, groups: BlockGroups,
                     z: torch.Tensor) -> torch.Tensor:
    """z: (t, br, nrb) -> (t, br, nrb), reading each unique inverse once.

    inv_u: (ng, br, mbn, br, mbn) from ``build_device_block_jacobi_grouped``;
    groups: their ``BlockGroups``, made once at build time. The panel is
    gathered group by group into an (mb, nb·t) matrix, so each group is
    one (mb × mb)·(mb × |g|·t) GEMM on a column slice, and scattered back:
    plain PyTorch, as the JAX apply is an einsum."""
    ng, br, mbn, _, _ = inv_u.shape
    mb = br * mbn
    t, _, nrb = z.shape
    nb = nrb // mbn
    inv = inv_u.reshape(ng, mb, mb)
    # (t, br, nb, mbn) -> (br, mbn, nb, t), blocks in group order
    zp = z.reshape(t, br, nb, mbn).permute(1, 3, 2, 0).index_select(
        2, groups.order).reshape(mb, nb * t)
    wp = torch.cat([inv[g] @ zp[:, s * t:e * t]
                    for g, (s, e) in enumerate(groups.bounds)], dim=1)
    w = wp.reshape(br, mbn, nb, t).index_select(2, groups.inv_order)
    return w.permute(3, 0, 2, 1).reshape(t, br, nrb).to(z.dtype)


# ---------------------------------------------------------------------------
# The block-Jacobi apply kernel on pre-packed dense inverses
# ---------------------------------------------------------------------------

def pack_bj_dense(inv: torch.Tensor) -> torch.Tensor:
    """(nb, br, mbn, br, mbn) or flat (nb, mb, mb) inverses -> (nb, mbp, mbp)
    with mbp = mb rounded up to a multiple of 128. One-time build step for
    ``bj_apply_pallas``; the zero padding is exact (padded z rows are zero)."""
    nb = inv.shape[0]
    mb = inv.shape[1] * inv.shape[2] if inv.dim() == 5 else inv.shape[1]
    mbp = -(-mb // 128) * 128
    b2 = inv.reshape(nb, mb, mb)
    return torch.nn.functional.pad(b2, (0, mbp - mb, 0, mbp - mb)).contiguous()


def bj_apply_pallas_ref(b2: torch.Tensor, z: torch.Tensor, br: int) -> torch.Tensor:
    """Plain PyTorch ``bj_apply_pallas``: the same block panel and one
    batched GEMM on the padded blocks."""
    nb, mbp, _ = b2.shape
    mbn = z.shape[2] // nb
    return _from_blocks(torch.bmm(b2, _to_blocks(z, nb, mbp)), br, mbn)


@count_launches
def bj_apply_pallas(b2: torch.Tensor, z: torch.Tensor, br: int) -> torch.Tensor:
    """Block-Jacobi apply from pre-packed dense inverses (the TPU kernel
    ``prealps_tpu/direct/device_bj.py::bj_apply_pallas``).

    b2: (nb, mbp, mbp) from ``pack_bj_dense``; z: (t, br, nrb) lane-major;
    returns w of z's shape. CPU tensors run ``bj_apply_pallas_ref``. CUDA
    tensors launch the CUDA kernel (``csrc/bj_apply.cu``; f32, b2
    contiguous, one card) and count one launch in
    ``bj_apply_pallas.launches``. The driver does not call it: its apply is
    ``bj_apply_flat``'s batched GEMM, as the JAX driver's is an einsum.

    On the card the product is bound by the bytes of the inverses. The
    kernel reads only their valid mb × mb part (mb = br·nrb/nb), streamed
    through a shared-memory ring with cp.async so that bytes stay in
    flight whatever the thread count, and reads z and writes w in the
    lane-major layout itself: the wrapper makes no block panel (the first
    cut's two copies) and allocates only w. One thread owns one row of a
    block and up to 12 panel columns, so each sum runs over k in order in
    one thread.
    """
    if b2.dim() != 3 or b2.shape[1] != b2.shape[2] or z.dim() != 3:
        raise ValueError(f"bj_apply_pallas: b2 {tuple(b2.shape)} must be "
                         f"(nb, mbp, mbp) and z {tuple(z.shape)} (t, br, nrb)")
    nb, mbp, _ = b2.shape
    t, zbr, nrb = z.shape
    if zbr != br or nrb % nb or br * (nrb // nb) > mbp:
        raise ValueError(f"z {tuple(z.shape)} does not fit {nb} blocks of "
                         f"{mbp} padded rows with br={br}")
    if b2.device.type == "cpu" and z.device.type == "cpu":
        return bj_apply_pallas_ref(b2, z, br)
    if b2.device.type != "cuda" or z.device != b2.device:
        raise ValueError(f"bj_apply_pallas: operands on {b2.device} and "
                         f"{z.device}; both must be on one CUDA card (or both "
                         "on the CPU)")
    if b2.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError(f"bj_apply_pallas kernel takes float32, got "
                        f"{b2.dtype} and {z.dtype}")
    if not b2.is_contiguous() or b2.data_ptr() % 16:
        raise ValueError("bj_apply_pallas kernel takes a contiguous, 16-byte "
                         "aligned b2")
    mb = br * (nrb // nb)
    max_rows = _kernels.bj_apply_max_rows(t, b2.device) if t else mb
    if mbp % 4 or mb > max_rows:
        raise ValueError(f"bj_apply_pallas kernel takes mbp a multiple of 4 "
                         f"and blocks of up to {max_rows} rows at t={t}, got "
                         f"mbp={mbp}, mb={mb}")
    z = z.contiguous()
    w = torch.empty_like(z)
    if t:
        _kernels.bj_apply_f32(b2, z, w, mb)
        bj_apply_pallas.launches += 1
    return w
