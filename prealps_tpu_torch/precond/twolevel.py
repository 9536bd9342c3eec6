"""Two-level block Jacobi: subdomain inverses + a rigid-body coarse space.

Counterpart of ``prealps_tpu/precond/twolevel.py``:

    M⁻¹ = M_BJ⁻¹ + Z A_c⁻¹ Zᵀ,      A_c = Zᵀ A Z,

where Z stacks q geometric rigid-body modes per block (Nicolaides coarse
space), or, without the node grid, one translation per component
(``translation_modes``). The host builders (``geometric_rbm_modes``,
``translation_modes``, ``coarse_matrix_host``) are numpy copies of the JAX
package's; ``bj2l_apply`` is plain PyTorch (batched GEMMs: XLA einsums in
the reference, cuBLAS here).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.parallel.mesh import all_gather, rank_of


def coarse_matrix_host(a_pad: sp.csr_matrix, y5: np.ndarray, br: int) -> np.ndarray:
    """A_c = Zᵀ A Z on the host (setup only). y5: (nb, br, mbn, q) numpy.
    Z's rows follow the natural padded row ordering (node-major)."""
    nb, _, mbn, q = y5.shape
    mb = br * mbn
    n = a_pad.shape[0]
    if n != nb * mb:
        raise ValueError(f"matrix size {n} != nb·mb = {nb}·{mb}")
    rows = []
    cols = []
    vals = []
    for b in range(nb):
        blk = y5[b]                       # (br, mbn, q)
        nat = blk.transpose(1, 0, 2).reshape(mb, q)  # (rl, m) -> natural
        r0 = b * mb
        rr, cc = np.nonzero(np.ones((mb, q)))
        rows.append(r0 + rr)
        cols.append(b * q + cc)
        vals.append(nat[rr, cc])
    z = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, nb * q),
    ).tocsr()
    ac = (z.T @ a_pad @ z).toarray()
    return 0.5 * (ac + ac.T)


def geometric_rbm_modes(grid, br: int, nrb: int, mbn: int,
                        scale_d: np.ndarray | None = None,
                        perm: np.ndarray | None = None,
                        q: int | None = None) -> np.ndarray:
    """Per-block geometric rigid-body modes (the Nicolaides coarse space).

    grid: (nx, ny, nz) node dims, lexicographic x-fastest ordering.
    scale_d: the symmetric scaling diagonal in the padded row order (the
    near-null space of D A D is D⁻¹·RBM). ``perm`` is accepted for
    signature parity with the JAX package and unused there too.
    Returns y5 (nb, br, mbn, q), per-block orthonormalised.
    """
    nx, ny, nz = (int(g) for g in grid)
    nb = nrb // mbn
    if q is None:
        q = 3 * (br - 1) if br == 2 else 6 if br == 3 else br
    n_nodes = nx * ny * nz
    j = np.arange(nrb)
    px = (j % nx).astype(np.float64)
    py = ((j // nx) % ny).astype(np.float64)
    pz = (j // (nx * ny)).astype(np.float64)
    pad = j >= n_nodes
    nraw = 12 if (br == 3 and q > 6) else 6
    modes = np.zeros((nrb, br, nraw), dtype=np.float64)
    # translations
    for k in range(min(br, 3)):
        modes[:, k, k] = 1.0
    if br == 3:
        # rotations about x/y/z: u = r × (p − c)
        modes[:, 1, 3], modes[:, 2, 3] = -pz, py     # about x
        modes[:, 0, 4], modes[:, 2, 4] = pz, -px     # about y
        modes[:, 0, 5], modes[:, 1, 5] = -py, px     # about z
        if nraw == 12:
            # linear strain modes u = ε·p (symmetric ε)
            modes[:, 0, 6] = px                       # exx
            modes[:, 1, 7] = py                       # eyy
            modes[:, 2, 8] = pz                       # ezz
            modes[:, 0, 9], modes[:, 1, 9] = py, px   # exy
            modes[:, 0, 10], modes[:, 2, 10] = pz, px # exz
            modes[:, 1, 11], modes[:, 2, 11] = pz, py # eyz
    modes[pad] = 0.0
    if scale_d is not None:
        d = np.asarray(scale_d, dtype=np.float64).reshape(nrb, br)
        modes /= np.where(d[:, :, None] == 0.0, 1.0, d[:, :, None])
        modes[pad] = 0.0
    y = modes.reshape(nb, mbn, br, nraw).transpose(0, 2, 1, 3)
    # orthonormalise per block by SVD (kept columns lie in span(modes) even
    # for rank-deficient blocks); padded-only blocks get zero columns
    out = np.zeros((nb, br, mbn, q), dtype=np.float64)
    for b in range(nb):
        m = y[b].transpose(1, 0, 2).reshape(mbn * br, nraw)  # natural rows
        uu, sv, _ = np.linalg.svd(m, full_matrices=False)
        rank = int(np.sum(sv > 1e-12 * max(1.0, sv[0] if sv.size else 1.0)))
        cols = uu[:, :rank]
        o = np.zeros((mbn * br, q))
        ncols = min(cols.shape[1], q)
        o[:, :ncols] = cols[:, :ncols]
        out[b] = o.reshape(mbn, br, q).transpose(1, 0, 2)
    return out


def translation_modes(nb: int, mbn: int, br: int,
                      d_pad: np.ndarray | None = None) -> np.ndarray:
    """Per-block translation modes, the grid-free coarse space of bj2l
    (prealps_tpu/parallel/driver.py:541-564): one constant per component,
    divided by the scaling ``d_pad`` (padded row order; zeros count as 1),
    orthonormalised per block by QR. Returns y5 (nb, br, mbn, br)."""
    nodes_pad = nb * mbn
    ones = np.zeros((nodes_pad, br, br))
    for k in range(br):
        ones[:, k, k] = 1.0
    if d_pad is not None:
        d = np.asarray(d_pad).reshape(nodes_pad, br)
        ones /= np.where(d[:, :, None] == 0.0, 1.0, d[:, :, None])
    y = ones.reshape(nb, mbn, br, br).transpose(0, 2, 1, 3)
    y5 = np.zeros((nb, br, mbn, br))
    for b in range(nb):
        m = y[b].transpose(1, 0, 2).reshape(mbn * br, br)
        qq, _ = np.linalg.qr(m)
        y5[b] = qq.reshape(mbn, br, br).transpose(1, 0, 2)
    return y5


def bj2l_apply(inv_flat: torch.Tensor, yq3: torch.Tensor, ac_inv: torch.Tensor,
               z: torch.Tensor, group=None) -> torch.Tensor:
    """(M_BJ⁻¹ + Z A_c⁻¹ Zᵀ) z in lane-major, sharing one block transpose.

    inv_flat: (nb, mb, mb) block inverses; yq3: (nb, q, mb) per-block modes;
    ac_inv: (nb_glob·q, nb_glob·q) dense coarse inverse, column index b·q + j;
    z: (t, br, nrb) -> (t, br, nrb).

    With a process group, inv_flat / yq3 / z hold this shard's blocks and
    ac_inv is replicated: the coarse residual Zᵀz (t × nb·q, small) is
    all-gathered along its columns, the coarse GEMM is replicated, and each
    shard keeps its own columns (prealps_tpu/precond/twolevel.py:198-207)."""
    nb, mb, _ = inv_flat.shape
    q = yq3.shape[1]
    t, br, nrb = z.shape
    mbn = mb // br
    zb = z.reshape(t, br, nb, mbn).permute(2, 1, 3, 0).reshape(nb, mb, t)
    w = torch.bmm(inv_flat, zb)                       # (nb, mb, t)
    c = torch.bmm(yq3, zb).reshape(nb * q, t)         # row b·q + j
    if group is not None:
        c = all_gather(c, group, dim=0)
    # (t, nb·q) as a transposed view, on one rank or several: the GEMM's
    # operand layout, and so its rounding, does not depend on the group
    c = c.T @ ac_inv
    if group is not None:
        s = rank_of(group)
        c = c[:, s * nb * q:(s + 1) * nb * q]
    w = w + torch.bmm(yq3.mT, c.reshape(t, nb, q).permute(1, 2, 0))
    return w.reshape(nb, br, mbn, t).permute(3, 1, 0, 2).reshape(t, br, nrb)
