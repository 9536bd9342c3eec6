"""LORASC on a general sparse matrix: the single-device build.

The PyTorch counterpart of ``prealps_tpu/precond/lorasc.py`` (reference:
src/preconditioners/lorasc.c, lorasc_eigsolve.c). For an SPD matrix
permuted to block-arrow form

    A_arrow = [ Aii  Aig ]      Aii block-diagonal over k subdomain interiors,
              [ Agi  Agg ]      Agg the separator block,

the apply is

    zi = Aii⁻¹ vi ;  g = vg − Agi zi
    zg = Agg⁻¹ g + E diag(σ) Eᵀ g          (low-rank correction)
    wi = zi − Aii⁻¹ (Aig zg) ;  wg = zg

with (λ, E) the pairs of S u = λ Agg u, S = Agg − Agi Aii⁻¹ Aig, kept where
λ ≤ deflation_tol, σᵢ = (tol − λᵢ)/λᵢ, E Agg-orthonormal.

* Aii: ONE batched dense Cholesky over the RCM-ordered interiors
  (``direct/subdomain.py::build_block_solver``), factored on the host;
* Agg: a dense Cholesky (``DenseCholesky``);
* the eigenproblem: ``eig_method="direct"``, a dense generalized eigh of
  the explicit S on the host, or ``"lanczos"``, the matrix-free Lanczos of
  ``ops/lanczos.py::lanczos_gen`` on OP = Agg⁻¹ S in the build dtype on
  ``device``;
* the apply: batched triangular solves, two ELL products
  (``ops/spmm.py::ell_spmm``, XLA in the JAX package, plain PyTorch here)
  and two tall GEMMs.

Every operand lives on ``device`` (default "cuda", which raises without a
card; pass device="cpu" to run on the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from prealps_tpu_torch.config import resolve_device
from prealps_tpu_torch.core.partition import BlockArrowStruct, block_arrow_structure, permute
from prealps_tpu_torch.direct.subdomain import DenseCholesky, build_block_solver
from prealps_tpu_torch.ops.formats import EllMatrix, csr_to_ell
from prealps_tpu_torch.ops.spmm import ell_spmm
from prealps_tpu_torch.precond.block_jacobi import BlockJacobi


@dataclass
class Lorasc:
    aii_solver: BlockJacobi
    agg_solver: DenseCholesky
    aig: EllMatrix        # (ni, ng)
    agi: EllMatrix        # (ng, ni)
    e_mat: torch.Tensor   # (ng, nev) Agg-orthonormal deflation vectors
    sigma: torch.Tensor   # (nev,)
    ni: int               # interior rows
    ng: int               # separator rows

    @property
    def nev(self) -> int:
        return int(self.e_mat.shape[1])

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """(ni + ng, t) -> (ni + ng, t), rows in block-arrow order."""
        ni = self.ni
        vi, vg = v[:ni], v[ni:]
        zi = self.aii_solver.apply(vi)
        g = vg - ell_spmm(self.agi, zi)
        corr = (self.e_mat.T @ g) * self.sigma[:, None]
        zg = self.agg_solver.apply(g) + self.e_mat @ corr
        wi = zi - self.aii_solver.apply(ell_spmm(self.aig, zg))
        return torch.cat([wi, zg], dim=0)


def schur_complement_dense(aii: sp.csr_matrix, aig: sp.csr_matrix,
                           agi: sp.csr_matrix, agg: sp.csr_matrix) -> np.ndarray:
    """Explicit dense S = Agg − Agi Aii⁻¹ Aig (host, setup only)."""
    w = spla.spsolve(aii.tocsc(), aig.tocsc())
    if sp.issparse(w):
        w = w.toarray()
    w = np.atleast_2d(np.asarray(w))
    if w.shape[0] != aii.shape[0]:
        w = w.T
    s = agg.toarray() - agi @ w
    return 0.5 * (s + s.T)


def deflation_pairs(lam: np.ndarray, vecs: np.ndarray, ng: int,
                    deflation_tol: float, max_deflation: int):
    """(E, σ) of the pairs with λ ≤ deflation_tol, at most max_deflation;
    one zero-weight vector when none qualifies, so the shapes stay
    non-degenerate."""
    sel = np.flatnonzero(lam <= deflation_tol)[:max_deflation]
    if sel.size == 0:
        return np.zeros((ng, 1)), np.zeros((1,))
    lam_sel = lam[sel]
    return vecs[:, sel], (deflation_tol - lam_sel) / lam_sel


def arrow_blocks(ap: sp.csr_matrix, ni: int):
    """Aii, Aig, Agi, Agg of an arrow-permuted matrix."""
    return (ap[:ni, :ni].tocsr(), ap[:ni, ni:].tocsr(), ap[ni:, :ni].tocsr(),
            ap[ni:, ni:].tocsr())


def build_lorasc(
    a: sp.spmatrix,
    nparts: int = 8,
    deflation_tol: float = 1e-2,
    max_deflation: int = 64,
    eig_method: str = "direct",      # direct | lanczos
    lanczos_ncv: int | None = None,
    arrow: BlockArrowStruct | None = None,
    dtype=None,
    device="cuda",
) -> tuple[Lorasc, BlockArrowStruct]:
    """LORASC for A (original ordering). Returns (precond, arrow); the
    solver runs on permute(A, arrow.perm), as in the JAX package."""
    dev = resolve_device(device)
    a = sp.csr_matrix(a)
    dtype = np.dtype(dtype) if dtype is not None else a.dtype
    if arrow is None:
        arrow = block_arrow_structure(a, nparts)
    ap = permute(a, arrow.perm)
    ni, n = arrow.sep_start, arrow.n
    ng = n - ni
    aii, aig, agi, agg = arrow_blocks(ap, ni)

    aii_solver = build_block_solver(aii, arrow.interior_offsets, dtype=dtype,
                                    device=dev)
    agg_solver = DenseCholesky.build(agg, dtype=dtype, device=dev)

    if eig_method == "direct":
        lam, vecs = scipy.linalg.eigh(schur_complement_dense(aii, aig, agi, agg),
                                      agg.toarray())
    elif eig_method == "lanczos":
        lam, vecs = _lanczos_eigs(
            aii_solver, agg_solver, aig, agi, agg, ng,
            ncv=lanczos_ncv or min(ng, 2 * max_deflation + 1), dtype=dtype,
            device=dev)
    else:
        raise ValueError(f"unknown eig_method {eig_method!r}")
    e_mat, sigma = deflation_pairs(lam, vecs, ng, deflation_tol, max_deflation)

    precond = Lorasc(
        aii_solver=aii_solver, agg_solver=agg_solver,
        aig=csr_to_ell(aig, dtype=dtype, device=dev),
        agi=csr_to_ell(agi, dtype=dtype, device=dev),
        e_mat=torch.from_numpy(np.asarray(e_mat, dtype=dtype)).to(dev),
        sigma=torch.from_numpy(np.asarray(sigma, dtype=dtype)).to(dev),
        ni=ni, ng=ng)
    return precond, arrow


def _lanczos_eigs(aii_solver, agg_solver, aig, agi, agg, ng, ncv, dtype, device):
    """Matrix-free Lanczos on OP = Agg⁻¹ S in the Agg-inner product, in the
    build dtype (reference: utils/matrixVectorOp.c AggInvxS). Returns the
    Ritz pairs as numpy (ascending)."""
    from prealps_tpu_torch.ops.lanczos import lanczos_gen

    aig_e = csr_to_ell(aig, dtype=dtype, device=device)
    agi_e = csr_to_ell(agi, dtype=dtype, device=device)
    agg_e = csr_to_ell(agg, dtype=dtype, device=device)

    def s_apply(v):  # S v = Agg v − Agi Aii⁻¹ Aig v
        u = ell_spmm(agi_e, aii_solver.apply(ell_spmm(aig_e, v[:, None])))
        return (ell_spmm(agg_e, v[:, None]) - u)[:, 0]

    def op_apply(v):
        return agg_solver.apply(s_apply(v)[:, None])[:, 0]

    def b_apply(v):
        return ell_spmm(agg_e, v[:, None])[:, 0]

    res = lanczos_gen(op_apply, b_apply, ng, ncv,
                      dtype=getattr(torch, np.dtype(dtype).name), device=device)
    return res.eigvalues.cpu().numpy(), res.eigvectors.cpu().numpy()
