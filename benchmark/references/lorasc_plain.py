"""Plain float64 reference of the LORASC preconditioner and of PCG under it,
in plain PyTorch on dense matrices (the sizes of the CPU tests).

It follows preAlps' LORASC (Users' Guide §5.2.2; lorasc.c) from the
definition, and takes nothing the program made but the matrix and the
block-arrow partition (each unknown's domain, −1 on the separator):

* Aii⁻¹: a dense Cholesky of each interior block;
* S = Agg − Σ_p Agi,p Aii,p⁻¹ Aig,p, the exact Schur complement;
* the pairs S u = λ Agg u with 0 < λ ≤ ε from a dense generalized eigh
  (uᵀ Agg u = 1), and σ = (ε − λ)/λ, so that S̃⁻¹ = Agg⁻¹ + U σ Uᵀ sends each
  S uᵢ to ε uᵢ. ``lam_floor`` floors λ inside σ (0: none), for a comparison
  with a program that caps σ;
* M⁻¹ r = [I −Aii⁻¹Aig; 0 I] [Aii⁻¹ 0; 0 S̃⁻¹] [I 0; −Agi Aii⁻¹ I] r;
* ``pcg``: preconditioned CG from x0, stopping on the true residual
  ‖b − A x‖ ≤ tol ‖b‖; ``refined_pcg``: rounds of ``pcg`` on the f64
  residual, each to ``inner_tol`` of its own right-hand side, until
  ‖b − A x‖ ≤ tol ‖b‖ (the rounds a program with a lower-precision inner
  solve makes, here all in f64).

Departures: dense matrices, so no banded ordering and no Lanczos: every
pair with 0 < λ ≤ ε is kept, where the manual's PARPACK computes nev of
them.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64


class Lorasc:
    """M⁻¹ of LORASC for the dense SPD ``a`` (n, n) and ``dof_part`` (n,)
    (domain of each unknown, −1 on the separator)."""

    def __init__(self, a: torch.Tensor, dof_part: torch.Tensor, eps: float,
                 lam_floor: float = 0.0):
        a = a.to(F64)
        self.a = a
        self.sep = torch.nonzero(dof_part < 0).reshape(-1)
        self.parts = [torch.nonzero(dof_part == p).reshape(-1)
                      for p in range(int(dof_part.max()) + 1)]
        self.parts = [i for i in self.parts if i.numel()]
        g = self.sep
        agg = a[g][:, g]
        self.l_int = [torch.linalg.cholesky(a[i][:, i]) for i in self.parts]
        s = agg.clone()
        for i, l in zip(self.parts, self.l_int):
            aig = a[i][:, g]
            s -= aig.T @ torch.cholesky_solve(aig, l)
        self.schur = 0.5 * (s + s.T)
        self.l_sep = torch.linalg.cholesky(agg)
        # S u = λ Agg u through Agg = L Lᵀ: (L⁻¹ S L⁻ᵀ) y = λ y, u = L⁻ᵀ y
        c = torch.linalg.solve_triangular(self.l_sep, self.schur, upper=False)
        c = torch.linalg.solve_triangular(self.l_sep, c.T, upper=False)
        lam, y = torch.linalg.eigh(0.5 * (c + c.T))
        u = torch.linalg.solve_triangular(self.l_sep.T, y, upper=True)
        keep = (lam <= eps) & (lam > 0)
        self.lam, self.u = lam[keep], u[:, keep]
        lam_eff = torch.clamp(self.lam, min=lam_floor)
        self.sigma = (eps - lam_eff) / lam_eff

    def _interior(self, v: torch.Tensor) -> torch.Tensor:
        """Aii⁻¹ on the interior rows of v, zero on the separator."""
        out = torch.zeros_like(v)
        for i, l in zip(self.parts, self.l_int):
            out[i] = torch.cholesky_solve(v[i], l)
        return out

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """M⁻¹ r for r (n,) or (n, k)."""
        r = r.to(F64)
        col = r.dim() == 1
        r = r[:, None] if col else r
        g = self.sep
        z = self._interior(r)                          # Aii⁻¹ ri
        rg = r[g] - (self.a @ z)[g]                    # rg − Agi zi
        zg = torch.cholesky_solve(rg, self.l_sep)
        zg = zg + self.u @ (self.sigma[:, None] * (self.u.T @ rg))
        embed = torch.zeros_like(r)
        embed[g] = zg
        w = z - self._interior(self.a @ embed)         # zi − Aii⁻¹ Aig zg
        w[g] = zg
        return w[:, 0] if col else w


def pcg(a: torch.Tensor, b: torch.Tensor, minv, tol: float, maxiter: int = 10000,
        x0: torch.Tensor | None = None):
    """(x, iterations): CG on a x = b preconditioned by ``minv``, from x0
    (zero), until ‖b − a x‖ ≤ tol ‖b‖ in the recurrence residual."""
    a, b = a.to(F64), b.to(F64)
    x = torch.zeros_like(b) if x0 is None else x0.to(F64).clone()
    r = b - a @ x
    stop = tol * torch.linalg.norm(b)
    z = minv(r)
    p = z.clone()
    rz = torch.dot(r, z)
    for it in range(maxiter):
        if torch.linalg.norm(r) <= stop:
            return x, it
        q = a @ p
        alpha = rz / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = minv(r)
        rz, rz_old = torch.dot(r, z), rz
        p = z + (rz / rz_old) * p
    return x, maxiter


def refined_pcg(a: torch.Tensor, b: torch.Tensor, minv, tol: float, inner_tol: float,
                max_rounds: int = 8):
    """(x, iterations, rounds): rounds of ``pcg`` on the residual r = b − a x,
    each to ``inner_tol`` of its own r, until ‖b − a x‖ ≤ tol ‖b‖."""
    a, b = a.to(F64), b.to(F64)
    x = torch.zeros_like(b)
    total = rounds = 0
    normb = torch.linalg.norm(b)
    while rounds < max_rounds:
        r = b - a @ x
        if torch.linalg.norm(r) <= tol * normb:
            break
        dx, it = pcg(a, r, minv, inner_tol)
        x, total, rounds = x + dx, total + it, rounds + 1
    return x, total, rounds
