"""On-device block-Jacobi construction from the stencil operator.

Counterparts of ``prealps_tpu/direct/device_bj.py`` (XLA there, plain
PyTorch here): the dense diagonal blocks are assembled on the device from
the stencil block table, inverted by batched Cholesky, and applied as one
batched GEMM per preconditioner call (``bj_apply_flat``). Beside it,
``bj_apply_pallas`` is the same apply through a hand-written CUDA kernel
(``csrc/bj_apply.cu``) on blocks packed to a multiple of 128 rows, reading
and writing the lane-major panels directly; it is checked and timed
against the GEMM, and no driver path calls it.

Index convention inside a block (component-major): block b holds nodes
[b·mbn, (b+1)·mbn); its row m·mbn + rl is component m of local node rl. A
lane-major panel (t, br, nrb) maps onto blocks as
``z.reshape(t, br, nb, mbn).permute(0, 2, 1, 3)`` — getting this wrong
still converges, only slower.
"""

from __future__ import annotations

import torch

from prealps_tpu_torch.ops import _kernels


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
    """Explicit inverse of each (mb × mb) SPD block by Cholesky; 5-D in and
    out (nb, br, mbn, br, mbn)."""
    if method != "chol":
        raise NotImplementedError(
            f"batched_spd_inverse method={method!r} is not ported yet "
            "(ROADMAP.md queue A, item 1); use method='chol'")
    nb, br, mbn, _, _ = dense5.shape
    mb = br * mbn
    a = dense5.reshape(nb, mb, mb)
    a = 0.5 * (a + a.mT)
    low = torch.linalg.cholesky(a)
    eye = torch.eye(mb, dtype=a.dtype, device=a.device).expand(nb, mb, mb)
    linv = torch.linalg.solve_triangular(low, eye, upper=False)
    inv = linv.mT @ linv
    return inv.reshape(nb, br, mbn, br, mbn)


def build_device_block_jacobi_flat(blocks_t, offsets, mbn: int,
                                   method: str = "chol") -> torch.Tensor:
    """Stencil -> FLAT (nb, mb, mb) explicit block inverses."""
    inv5 = batched_spd_inverse(dense_blocks_from_stencil(blocks_t, offsets, mbn),
                               method)
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


bj_apply_pallas.launches = 0
