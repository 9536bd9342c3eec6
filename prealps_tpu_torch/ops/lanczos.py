"""Generalized symmetric Lanczos eigensolvers (the PARPACK role).

The PyTorch counterpart of ``prealps_tpu/ops/lanczos.py``: S u = λ B u for
the smallest eigenpairs, with S symmetric and B SPD, by Lanczos on
OP = B⁻¹S in the B-inner product (reference: utils/eigsolver.c mode 2).
The operator callbacks are matrix-free closures. ``fori_loop`` becomes a
Python loop, and the small projected eigenproblems go to
``torch.linalg.eigh`` in the working dtype, where the JAX code calls
``jnp.linalg.eigh``. ``jnp.linalg.cholesky`` returns NaN on a failed
factor; ``_chol_nan`` keeps that contract on top of ``cholesky_ex``.
Each solver runs on ``device`` (default "cuda", which raises without a
card; pass device="cpu" to run on the host), where its start vector goes.
"""

from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple

import torch

from prealps_tpu_torch.config import resolve_device


class LanczosResult(NamedTuple):
    eigvalues: torch.Tensor   # (ncv,) Ritz values, ascending
    eigvectors: torch.Tensor  # (n, ncv) B-orthonormal Ritz vectors
    resid: torch.Tensor       # (ncv,) residual estimates
    niter: int


def _start(v0, n, dtype, device):
    device = resolve_device(device)
    if v0 is None:
        # deterministic start, the reference's fixed resid = 1e-2
        return torch.full((n,), 1e-2, dtype=dtype, device=device)
    return v0.to(device=device, dtype=dtype)


def _chol_nan(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all NaN where it fails (jnp.linalg.cholesky)."""
    l, info = torch.linalg.cholesky_ex(g)
    return torch.where(info == 0, l, torch.full_like(l, math.nan))


def lanczos_gen(
    op_apply: Callable[[torch.Tensor], torch.Tensor],   # v -> B⁻¹ S v
    b_apply: Callable[[torch.Tensor], torch.Tensor],    # v -> B v
    n: int,
    ncv: int,
    dtype=torch.float64,
    v0: torch.Tensor | None = None,
    device="cuda",
) -> LanczosResult:
    """Run ncv Lanczos steps with full two-pass B-reorthogonalisation;
    returns all ncv Ritz pairs (ascending)."""
    v0 = _start(v0, n, dtype, device)
    dev = v0.device

    def b_norm(v):
        return torch.sqrt(torch.clamp(torch.dot(v, b_apply(v)), min=0.0))

    v_basis = torch.zeros((n, ncv + 1), dtype=dtype, device=dev)
    v_basis[:, 0] = v0 / b_norm(v0)
    alphas = torch.zeros(ncv, dtype=dtype, device=dev)
    betas = torch.zeros(ncv, dtype=dtype, device=dev)
    idx = torch.arange(ncv + 1, device=dev)
    for j in range(ncv):
        vj = v_basis[:, j]
        w = op_apply(vj)
        bw = b_apply(w)
        alpha = torch.dot(vj, bw)
        mask = (idx <= j).to(dtype)
        proj = (v_basis.T @ bw) * mask
        w = w - v_basis @ proj
        bw2 = b_apply(w)
        proj2 = (v_basis.T @ bw2) * mask
        w = w - v_basis @ proj2
        beta = b_norm(w)
        v_basis[:, j + 1] = w / torch.where(beta > 0, beta, torch.ones_like(beta))
        alphas[j] = alpha
        betas[j] = beta
    tri = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
           + torch.diag(betas[:-1], -1))
    theta, y = torch.linalg.eigh(tri)
    vecs = v_basis[:, :ncv] @ y
    resid = torch.abs(betas[ncv - 1] * y[ncv - 1, :])
    return LanczosResult(eigvalues=theta, eigvectors=vecs, resid=resid,
                         niter=ncv)


def lanczos_thick_restart(
    op_apply: Callable[[torch.Tensor], torch.Tensor],
    b_apply: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    ncv: int,
    nev: int,
    restarts: int = 4,
    dtype=torch.float64,
    v0: torch.Tensor | None = None,
    device="cuda",
) -> LanczosResult:
    """Thick-restart Lanczos (Wu & Simon) in the B-inner product: each cycle
    extends the basis to ``ncv`` vectors, Rayleigh-Ritz-es the projected
    matrix and keeps the nkeep smallest Ritz vectors plus the residual
    direction; ``restarts + 1`` cycles in all."""
    v0 = _start(v0, n, dtype, device)
    dev = v0.device
    m = ncv
    nkeep = min(max(nev + (m - nev) // 3, 1), m - 2)

    def b_norm(v):
        return torch.sqrt(torch.clamp(torch.dot(v, b_apply(v)), min=0.0))

    v_basis = torch.zeros((n, m + 1), dtype=dtype, device=dev)
    v_basis[:, 0] = v0 / b_norm(v0)
    h = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    idx = torch.arange(m + 1, device=dev)

    def extend(j):
        w = op_apply(v_basis[:, j])
        bw = b_apply(w)
        mask = (idx <= j).to(dtype)
        proj = (v_basis.T @ bw) * mask
        w = w - v_basis @ proj
        bw2 = b_apply(w)
        proj2 = (v_basis.T @ bw2) * mask
        w = w - v_basis @ proj2
        beta = b_norm(w)
        v_basis[:, j + 1] = w / torch.where(beta > 0, beta, torch.ones_like(beta))
        h[:, j] = proj + proj2
        h[j + 1, j] = beta

    def rayleigh_ritz():
        return torch.linalg.eigh(0.5 * (h[:m, :] + h[:m, :].T))

    jstart = 0
    for _ in range(restarts):
        for j in range(jstart, m):
            extend(j)
        theta, y = rayleigh_ritz()
        s = h[m, m - 1] * y[m - 1, :]
        v_keep = v_basis[:, :m] @ y[:, :nkeep]
        v_res = v_basis[:, m].clone()
        v_basis.zero_()
        v_basis[:, :nkeep] = v_keep
        v_basis[:, nkeep] = v_res
        h.zero_()
        h[torch.arange(nkeep), torch.arange(nkeep)] = theta[:nkeep]
        h[nkeep, :nkeep] = s[:nkeep]
        jstart = nkeep
    for j in range(jstart, m):
        extend(j)
    theta, y = rayleigh_ritz()
    vecs = v_basis[:, :m] @ y
    resid = torch.abs(h[m, m - 1] * y[m - 1, :])
    return LanczosResult(eigvalues=theta, eigvectors=vecs, resid=resid,
                         niter=(restarts + 1) * m)


def resolve_block_policy(restarts: int, ncv_eff: int, nondeg_dim: int,
                         blk: int | None = None):
    """Block-vs-scalar Lanczos policy of the LORASC build
    (``prealps_tpu/ops/lanczos.py::resolve_block_policy``).

    Returns (blk, nblocks, restarts_eff); blk == 0 selects the scalar
    iteration. ``blk`` None reads PREALPS_LANCZOS_BLOCK (default 8). The
    basis dimension nblocks·blk is capped at nondeg_dim − 1; the block
    iteration runs ~2.5× the cycles (capped at 9 past ng = 8192, where the
    reference measured the yield saturating)."""
    if blk is None:
        blk = int(os.environ.get("PREALPS_LANCZOS_BLOCK", "8"))
    if blk <= 1 or restarts == 0:
        return 0, 0, restarts
    nblocks = min(-(-ncv_eff // blk), max(nondeg_dim - 1, 0) // blk)
    if nblocks < 3:
        return 0, 0, restarts
    eff = max(restarts, (restarts * 5) // 2 + 2)
    if nondeg_dim > 8192:
        eff = min(eff, max(9, restarts))
    return blk, nblocks, eff


def block_lanczos_thick_restart(
    op_apply_panel: Callable[[torch.Tensor], torch.Tensor],  # (n,bt) -> B⁻¹S panel
    b_apply_panel: Callable[[torch.Tensor], torch.Tensor],   # (n,bt) -> B panel
    n: int,
    nblocks: int,
    nev: int,
    bt: int = 8,
    restarts: int = 4,
    dtype=torch.float64,
    v0: torch.Tensor | None = None,
    device="cuda",
) -> LanczosResult:
    """Block thick-restart Lanczos in the B-inner product: the scalar
    iteration with bt-wide panels. Each step B-orthonormalises the new panel
    by Cholesky-QR of its B-Gram (two rounds, column-equilibrated, a
    trace-scaled ridge only as the rank-loss fallback; a dead block zeroes
    out). Thick restart keeps a block-aligned number of Ritz vectors plus
    the residual panel."""
    m = nblocks
    dim = m * bt
    if m < 3:
        raise ValueError(f"block thick-restart needs nblocks >= 3, got {m}")
    v0 = _start(v0, n, dtype, device)
    dev = v0.device
    if v0.dim() == 1:
        # deterministic full-rank start panel: columns modulated by
        # low-order Chebyshev-like waves
        i = torch.arange(n, dtype=dtype, device=dev)
        waves = torch.cos(math.pi * (i[:, None] + 0.5)
                          * (torch.arange(bt, dtype=dtype, device=dev)[None] + 1.0)
                          / n)
        v0 = v0[:, None] * (1.0 + 0.5 * waves)
    nkeep_b = min(max((nev + (dim - nev) // 3 + bt - 1) // bt, 1), m - 2)
    kdim = nkeep_b * bt
    eps = torch.finfo(dtype).eps
    eye = torch.eye(bt, dtype=dtype, device=dev)

    def b_qr(w):
        d2 = torch.einsum("ni,ni->i", w, b_apply_panel(w))
        d = torch.sqrt(torch.clamp(d2, min=1e-30))
        w = w / d[None, :]
        r_acc = torch.diag(d)
        for _ in range(2):
            g = w.T @ b_apply_panel(w)
            g = 0.5 * (g + g.T)
            l0 = _chol_nan(g)
            ridge = torch.clamp(torch.trace(g), min=1e-30) * (50.0 * eps)
            l1 = _chol_nan(g + ridge * eye)
            l = torch.where(torch.isnan(l0).any(), l1, l0)
            bad = torch.isnan(l).any()
            l = torch.where(bad, eye, l)
            q = torch.linalg.solve_triangular(l.T, w, upper=True, left=False)
            w = torch.where(bad, torch.zeros_like(q), q)
            r_acc = torch.where(bad, torch.zeros_like(r_acc), l.T @ r_acc)
        return w, r_acc

    v0q, _ = b_qr(v0)
    v_basis = torch.zeros((n, (m + 1) * bt), dtype=dtype, device=dev)
    v_basis[:, :bt] = v0q
    h = torch.zeros(((m + 1) * bt, dim), dtype=dtype, device=dev)
    cols = torch.arange((m + 1) * bt, device=dev)

    def extend(j):
        jb = j * bt
        w = op_apply_panel(v_basis[:, jb:jb + bt])
        bw = b_apply_panel(w)
        mask = (cols < (j + 1) * bt).to(dtype)[:, None]
        proj = (v_basis.T @ bw) * mask
        w = w - v_basis @ proj
        bw2 = b_apply_panel(w)
        proj2 = (v_basis.T @ bw2) * mask
        w = w - v_basis @ proj2
        q, r = b_qr(w)
        v_basis[:, jb + bt:jb + 2 * bt] = q
        hcol = proj + proj2
        hcol[jb + bt:jb + 2 * bt] = r
        h[:, jb:jb + bt] = hcol

    def rayleigh_ritz():
        return torch.linalg.eigh(0.5 * (h[:dim, :] + h[:dim, :].T))

    jstart = 0
    for _ in range(restarts):
        for j in range(jstart, m):
            extend(j)
        theta, y = rayleigh_ritz()
        s = h[dim:, dim - bt:] @ y[dim - bt:, :]
        v_keep = v_basis[:, :dim] @ y[:, :kdim]
        v_res = v_basis[:, dim:].clone()
        v_basis.zero_()
        v_basis[:, :kdim] = v_keep
        v_basis[:, kdim:kdim + bt] = v_res
        h.zero_()
        h[torch.arange(kdim), torch.arange(kdim)] = theta[:kdim]
        h[kdim:kdim + bt, :kdim] = s[:, :kdim]
        jstart = nkeep_b
    for j in range(jstart, m):
        extend(j)
    theta, y = rayleigh_ritz()
    vecs = v_basis[:, :dim] @ y
    s = h[dim:, dim - bt:] @ y[dim - bt:, :]
    resid = torch.sqrt(torch.einsum("ik,ik->k", s, s))
    return LanczosResult(eigvalues=theta, eigvectors=vecs, resid=resid,
                         niter=(restarts + 1) * m * bt)


def rayleigh_ritz_refine(vecs, sv, bv, drop_tol: float = 1e-3):
    """Subspace Rayleigh-Ritz refinement of candidate pairs of (S, B), given
    the candidate panel and its S·V / B·V products: project, B-equilibrate,
    whiten B (dropping near-dependent directions, which surface with theta
    1e6), re-solve. Returns (theta ascending, B-orthonormal vecs_r, bnorm2,
    true residual ‖S u − θ B u‖₂)."""
    hp = vecs.T @ sv
    bp = vecs.T @ bv
    hp = 0.5 * (hp + hp.T)
    bp = 0.5 * (bp + bp.T)
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(bp)), min=1e-30))
    hp = hp / d[:, None] / d[None, :]
    bp = bp / d[:, None] / d[None, :]
    dmu, u = torch.linalg.eigh(bp)
    keep = dmu > drop_tol
    dsafe = torch.where(keep, dmu, torch.ones_like(dmu))
    w = u * torch.where(keep, 1.0 / torch.sqrt(dsafe), torch.zeros_like(dsafe))[None, :]
    sw = w.T @ hp @ w
    sw = 0.5 * (sw + sw.T)
    sw = sw + torch.diag(torch.where(keep, torch.zeros_like(dmu),
                                     torch.full_like(dmu, 1e6)))
    theta, z = torch.linalg.eigh(sw)
    wz = (w @ z) / d[:, None]
    vecs_r = vecs @ wz
    svr = sv @ wz
    bvr = bv @ wz
    bnorm2 = torch.einsum("gk,gk->k", vecs_r, bvr)
    r_true = svr - theta[None, :] * bvr
    resid = torch.sqrt(torch.einsum("gk,gk->k", r_true, r_true))
    return theta, vecs_r, bnorm2, resid
