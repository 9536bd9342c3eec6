"""On-device block-Jacobi construction from the stencil operator.

Counterparts of ``prealps_tpu/direct/device_bj.py`` (XLA there, plain
PyTorch here): the dense diagonal blocks are assembled on the device from
the stencil block table, inverted by batched Cholesky, and applied as one
batched GEMM per preconditioner call.

Index convention inside a block (component-major): block b holds nodes
[b·mbn, (b+1)·mbn); its row m·mbn + rl is component m of local node rl. A
lane-major panel (t, br, nrb) maps onto blocks as
``z.reshape(t, br, nb, mbn).permute(0, 2, 1, 3)`` — getting this wrong
still converges, only slower.
"""

from __future__ import annotations

import torch


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
            "(ROADMAP.md queue A, item 2); use method='chol'")
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


def bj_apply_flat(inv_flat: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """z: (t, br, nrb) -> (t, br, nrb) with flat (nb, mb, mb) inverses."""
    nb, mb, _ = inv_flat.shape
    t, br, nrb = z.shape
    mbn = mb // br
    zb = z.reshape(t, br, nb, mbn).permute(2, 1, 3, 0).reshape(nb, mb, t)
    w = torch.bmm(inv_flat, zb)                       # (nb, mb, t)
    return w.reshape(nb, br, mbn, t).permute(3, 1, 0, 2).reshape(t, br, nrb)
