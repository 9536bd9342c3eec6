"""Test-problem generators (host side, numpy/scipy).

A copy of ``prealps_tpu/core/generators.py`` (elasticity3d, poisson3d): the
JAX package cannot be imported without JAX, and the machine with the card
has none. tests/test_torch_host.py holds both copies to ``array_equal``.

elasticity3d assembles trilinear (Q1) hexahedral 3-D linear elasticity with
an optionally heterogeneous Young's modulus ("_var"); poisson3d is the
7-point Laplacian. Deterministic, vectorised numpy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# 2x2x2 Gauss points for the unit cube [-1,1]^3
_GP = 1.0 / np.sqrt(3.0)
_GAUSS = np.array(
    [[sx * _GP, sy * _GP, sz * _GP] for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)]
)

# Q1 hex node order: x fastest, then y, then z (lexicographic corner order)
_CORNERS = np.array(
    [[sx, sy, sz] for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)], dtype=np.float64
)


def _hex_stiffness_unit(nu: float, hx: float, hy: float, hz: float) -> np.ndarray:
    """24x24 Q1 hexahedral elasticity stiffness for E=1, Poisson ratio nu,
    element size (hx, hy, hz); 2x2x2 Gauss quadrature."""
    lam = nu / ((1 + nu) * (1 - 2 * nu))
    mu = 1.0 / (2 * (1 + nu))
    d_mat = np.zeros((6, 6))
    d_mat[:3, :3] = lam
    d_mat[np.arange(3), np.arange(3)] = lam + 2 * mu
    d_mat[3:, 3:] = np.eye(3) * mu

    jac = np.diag([hx / 2, hy / 2, hz / 2])
    inv_jac = np.diag([2 / hx, 2 / hy, 2 / hz])
    det_jac = np.linalg.det(jac)

    ke = np.zeros((24, 24))
    for xi, eta, zeta in _GAUSS:
        # dN_i/d(xi,eta,zeta) for the 8 trilinear shape functions
        dn = np.zeros((8, 3))
        for i, (cx, cy, cz) in enumerate(_CORNERS):
            dn[i, 0] = cx * (1 + cy * eta) * (1 + cz * zeta) / 8.0
            dn[i, 1] = (1 + cx * xi) * cy * (1 + cz * zeta) / 8.0
            dn[i, 2] = (1 + cx * xi) * (1 + cy * eta) * cz / 8.0
        dndx = dn @ inv_jac  # (8,3) derivatives in physical coords
        b = np.zeros((6, 24))
        for i in range(8):
            bx, by, bz = dndx[i]
            c = 3 * i
            b[0, c] = bx
            b[1, c + 1] = by
            b[2, c + 2] = bz
            b[3, c] = by
            b[3, c + 1] = bx
            b[4, c + 1] = bz
            b[4, c + 2] = by
            b[5, c] = bz
            b[5, c + 2] = bx
        ke += b.T @ d_mat @ b * det_jac
    return 0.5 * (ke + ke.T)


def elasticity3d(
    nx: int,
    ny: int,
    nz: int,
    nu: float = 0.3,
    heterogeneous: bool = True,
    hx: float = 1.0,
    hy: float = 1.0,
    hz: float = 1.0,
    contrast: float = 1.0e3,
    fixed_face: str = "z0",
    dtype=np.float64,
) -> sp.csr_matrix:
    """Assemble a 3-D Q1 linear-elasticity stiffness matrix (SPD).

    nx, ny, nz: elements per direction. Nodes on ``fixed_face`` are clamped
    (Dirichlet, eliminated) so the operator is SPD. With ``heterogeneous``
    the Young's modulus alternates between 1 and ``contrast`` in z slabs.
    The node grid of the result is (nx+1, ny+1, nz) for fixed_face="z0".
    """
    nnx, nny, nnz_ = nx + 1, ny + 1, nz + 1

    def node_id(ix, iy, iz):
        return ix + iy * nnx + iz * nnx * nny

    # element -> 8 node ids, same corner order as _CORNERS
    ex, ey, ez = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ex, ey, ez = ex.ravel(), ey.ravel(), ez.ravel()
    corners = []
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                corners.append(node_id(ex + cx, ey + cy, ez + cz))
    enodes = np.stack(corners, axis=1)  # (ne, 8)
    ne = enodes.shape[0]

    if heterogeneous:
        e_mod = np.where(ez % 2 == 0, 1.0, contrast)
    else:
        e_mod = np.ones(ne)

    ke = _hex_stiffness_unit(nu, hx, hy, hz)  # (24,24), E=1

    edofs = (enodes[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(ne, 24)
    rows = np.repeat(edofs, 24, axis=1).ravel()
    cols = np.tile(edofs, (1, 24)).ravel()
    vals = (e_mod[:, None, None] * ke[None, :, :]).ravel()

    ndof = 3 * nnx * nny * nnz_
    a = sp.coo_matrix((vals, (rows, cols)), shape=(ndof, ndof)).tocsr()

    # Dirichlet elimination
    ix, iy, iz = np.meshgrid(np.arange(nnx), np.arange(nny), np.arange(nnz_), indexing="ij")
    if fixed_face == "z0":
        fixed_nodes = node_id(ix, iy, iz)[iz == 0]
    elif fixed_face == "x0":
        fixed_nodes = node_id(ix, iy, iz)[ix == 0]
    elif fixed_face == "none":
        fixed_nodes = np.array([], dtype=np.int64)
    else:
        raise ValueError(f"unknown fixed_face {fixed_face}")
    fixed_dofs = (np.asarray(fixed_nodes).ravel()[:, None] * 3 + np.arange(3)).ravel()
    keep = np.ones(ndof, dtype=bool)
    keep[fixed_dofs] = False
    if fixed_face == "none":
        # keep SPD by adding light springs everywhere instead of clamping
        a = a + sp.eye(ndof) * 1e-6 * a.diagonal().mean()
    a = a[keep][:, keep].tocsr()
    a.sort_indices()
    return a.astype(dtype)


def poisson3d(nx: int, ny: int, nz: int, dtype=np.float64) -> sp.csr_matrix:
    """Standard 7-point finite-difference Laplacian on an nx*ny*nz grid (SPD)."""
    def lap1d(n):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))

    ix, iy, iz = sp.identity(nx), sp.identity(ny), sp.identity(nz)
    a = (
        sp.kron(sp.kron(lap1d(nz), iy), ix)
        + sp.kron(sp.kron(iz, lap1d(ny)), ix)
        + sp.kron(sp.kron(iz, iy), lap1d(nx))
    )
    a = a.tocsr()
    a.sort_indices()
    return a.astype(dtype)
