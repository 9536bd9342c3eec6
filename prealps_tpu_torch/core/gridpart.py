"""Geometric box partitions of structured grids (node level), host side.

Numpy copy of ``prealps_tpu/core/gridpart.py``: for box-grid operators the
block-arrow structure is known analytically. Cut the node grid into
px×py×pz boxes and take, for every internal cut, the last node layer of the
lower box as the vertex separator; interiors of different boxes then never
couple directly, and each interior's natural (lexicographic) order is
banded. ``tests/test_torch_lorasc.py`` holds it bitwise equal to the
original.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def factor3(k: int) -> tuple[int, int, int]:
    """Split k into three near-equal factors px*py*pz = k (px ≥ py ≥ pz)."""
    best = (k, 1, 1)
    best_score = k + 2
    for px in range(1, k + 1):
        if k % px:
            continue
        rem = k // px
        for py in range(1, rem + 1):
            if rem % py:
                continue
            pz = rem // py
            score = max(px, py, pz) - min(px, py, pz)
            if score < best_score:
                best_score = score
                best = tuple(sorted((px, py, pz), reverse=True))
    return best


def grid_box_partition(
    gx: int, gy: int, gz: int, k: int, dims: tuple[int, int, int] | None = None
):
    """Partition a gx×gy×gz node grid (x fastest, z slowest) into k boxes
    with plane separators.

    Returns (node_part, in_sep): node_part[g] ∈ [0, k) box id for interior
    nodes (separator nodes keep the id of the box they sit in), in_sep[g]
    bool.
    """
    px, py, pz = dims if dims is not None else factor3(k)
    assert px * py * pz == k, (px, py, pz, k)
    # the longest grid axes get the most cuts
    order = np.argsort([gx, gy, gz])[::-1]
    p_axes = [0, 0, 0]
    for ax, p in zip(order, sorted([px, py, pz], reverse=True)):
        p_axes[ax] = p
    px, py, pz = p_axes

    def splits(g, p):
        base, rem = divmod(g, p)
        sizes = np.full(p, base)
        sizes[:rem] += 1
        return np.concatenate([[0], np.cumsum(sizes)])

    sx, sy, sz = splits(gx, px), splits(gy, py), splits(gz, pz)
    x = np.arange(gx)
    y = np.arange(gy)
    z = np.arange(gz)
    bx = np.searchsorted(sx, x, side="right") - 1
    by = np.searchsorted(sy, y, side="right") - 1
    bz = np.searchsorted(sz, z, side="right") - 1

    # separator: last layer of every box except the last one, per axis
    sep_x = np.isin(x, sx[1:-1] - 1)
    sep_y = np.isin(y, sy[1:-1] - 1)
    sep_z = np.isin(z, sz[1:-1] - 1)

    bx3, by3, bz3 = np.meshgrid(bx, by, bz, indexing="ij")
    part3 = bx3 + px * (by3 + py * bz3)
    sep3 = (
        np.broadcast_to(sep_x[:, None, None], (gx, gy, gz))
        | np.broadcast_to(sep_y[None, :, None], (gx, gy, gz))
        | np.broadcast_to(sep_z[None, None, :], (gx, gy, gz))
    )
    # flatten with x fastest: g = x + gx*(y + gy*z)
    node_part = part3.transpose(2, 1, 0).ravel().astype(np.int64)
    in_sep = sep3.transpose(2, 1, 0).ravel()
    return node_part, in_sep


def collapse_to_nodes(a, br: int):
    """Node-level adjacency pattern of a dof matrix with br dofs per node."""
    a = sp.csr_matrix(a)
    n = a.shape[0]
    assert n % br == 0
    coo = a.tocoo()
    nrb = n // br
    pat = sp.coo_matrix(
        (np.ones_like(coo.data, dtype=np.int8), (coo.row // br, coo.col // br)),
        shape=(nrb, nrb),
    ).tocsr()
    pat.sum_duplicates()
    pat.data[:] = 1
    return pat
