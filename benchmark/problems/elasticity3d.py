"""3-D Q1 hexahedral linear elasticity, the benchmark's frozen input maker.

A frozen copy of the program's ``core/generators.py::elasticity3d``
(trilinear hexahedra, 2x2x2 Gauss points, Poisson ratio ``nu``, Young's
modulus 1, or alternating 1 and ``contrast`` in z slabs when
``heterogeneous``, the z = 0 face clamped). It imports nothing of the
program, so a change to the program cannot move the benchmark's inputs;
``benchmark/tests/test_bench_inputs.py`` holds the two equal at small sizes.

``make(params)`` returns the f64 CSR matrix and its node grid, which the
stencil format needs: (nx + 1, ny + 1, nz) nodes of three unknowns each.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

DEFAULTS = {"nu": 0.3, "heterogeneous": False, "contrast": 1.0e3}

_GP = 1.0 / np.sqrt(3.0)
_GAUSS = np.array(
    [[sx * _GP, sy * _GP, sz * _GP] for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)])
_CORNERS = np.array(
    [[sx, sy, sz] for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)], dtype=np.float64)


def _hex_stiffness_unit(nu: float) -> np.ndarray:
    """24x24 stiffness of a unit cube for E = 1 and Poisson ratio nu."""
    lam = nu / ((1 + nu) * (1 - 2 * nu))
    mu = 1.0 / (2 * (1 + nu))
    d_mat = np.zeros((6, 6))
    d_mat[:3, :3] = lam
    d_mat[np.arange(3), np.arange(3)] = lam + 2 * mu
    d_mat[3:, 3:] = np.eye(3) * mu
    jac = np.diag([0.5, 0.5, 0.5])
    inv_jac = np.diag([2.0, 2.0, 2.0])
    det_jac = np.linalg.det(jac)
    ke = np.zeros((24, 24))
    for xi, eta, zeta in _GAUSS:
        dn = np.zeros((8, 3))
        for i, (cx, cy, cz) in enumerate(_CORNERS):
            dn[i, 0] = cx * (1 + cy * eta) * (1 + cz * zeta) / 8.0
            dn[i, 1] = (1 + cx * xi) * cy * (1 + cz * zeta) / 8.0
            dn[i, 2] = (1 + cx * xi) * (1 + cy * eta) * cz / 8.0
        dndx = dn @ inv_jac
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


def assemble(nx: int, ny: int, nz: int, nu: float, heterogeneous: bool,
             contrast: float) -> sp.csr_matrix:
    """The SPD stiffness matrix with the z = 0 nodes eliminated."""
    nnx, nny, nnz_ = nx + 1, ny + 1, nz + 1

    def node_id(ix, iy, iz):
        return ix + iy * nnx + iz * nnx * nny

    ex, ey, ez = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ex, ey, ez = ex.ravel(), ey.ravel(), ez.ravel()
    enodes = np.stack([node_id(ex + cx, ey + cy, ez + cz)
                       for cz in (0, 1) for cy in (0, 1) for cx in (0, 1)], axis=1)
    ne = enodes.shape[0]
    e_mod = np.where(ez % 2 == 0, 1.0, contrast) if heterogeneous else np.ones(ne)
    ke = _hex_stiffness_unit(nu)
    edofs = (enodes[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(ne, 24)
    rows = np.repeat(edofs, 24, axis=1).ravel()
    cols = np.tile(edofs, (1, 24)).ravel()
    vals = (e_mod[:, None, None] * ke[None, :, :]).ravel()
    ndof = 3 * nnx * nny * nnz_
    a = sp.coo_matrix((vals, (rows, cols)), shape=(ndof, ndof)).tocsr()
    ix, iy, iz = np.meshgrid(np.arange(nnx), np.arange(nny), np.arange(nnz_), indexing="ij")
    fixed_nodes = node_id(ix, iy, iz)[iz == 0]
    fixed_dofs = (np.asarray(fixed_nodes).ravel()[:, None] * 3 + np.arange(3)).ravel()
    keep = np.ones(ndof, dtype=bool)
    keep[fixed_dofs] = False
    a = a[keep][:, keep].tocsr()
    a.sort_indices()
    return a.astype(np.float64)


def make(params: dict):
    """(A, {"grid": node grid}) for the traffic's ``problem`` parameters."""
    p = {**DEFAULTS, **params}
    a = assemble(int(p["nx"]), int(p["ny"]), int(p["nz"]), float(p["nu"]),
                 bool(p["heterogeneous"]), float(p["contrast"]))
    return a, {"grid": (int(p["nx"]) + 1, int(p["ny"]) + 1, int(p["nz"]))}
