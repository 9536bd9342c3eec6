"""Row splits and orderings (host side, numpy/scipy).

Copies of the pieces of ``prealps_tpu/core/partition.py`` that the
one-device general-sparse path needs: the even split of a row range into
blocks, the row grouping of a partition, the reverse Cuthill-McKee
ordering, and the BFS pseudo-coordinates and Morton order of
``fmt="auto"``'s block clustering. ``tests/test_torch_general_host.py`` and
``tests/test_torch_dia_host.py`` hold them bitwise equal to the originals.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra, reverse_cuthill_mckee


def nsplit(n: int, k: int) -> np.ndarray:
    """Even split of n items into k chunks; the first n % k chunks get one
    extra. Returns the k + 1 offsets."""
    base, rem = divmod(n, k)
    sizes = np.full(k, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def rcm_order(a: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (bandwidth reduction)."""
    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(a), symmetric_mode=True))


def _adjacency(a: sp.spmatrix) -> sp.csr_matrix:
    """Symmetrized pattern without the diagonal."""
    a = sp.csr_matrix(a)
    pattern = sp.csr_matrix(
        (np.ones_like(a.data, dtype=np.int8), a.indices, a.indptr), shape=a.shape)
    adj = pattern + pattern.T
    adj.setdiag(0)
    adj.eliminate_zeros()
    adj.sort_indices()
    return adj


def pseudo_coords(a: sp.spmatrix, k: int = 3, smooth: int = 3) -> np.ndarray:
    """BFS landmark embedding: k hop-distance coordinates per vertex.

    Landmarks are picked greedily farthest-first from a double-BFS
    pseudo-peripheral seed; the hop distance to each is a coordinate, then
    ``smooth`` Jacobi sweeps against the adjacency interpolate fractional
    positions. On mesh-like graphs this recovers the geometry well enough
    for Morton row clustering."""
    adj = _adjacency(a)
    n = adj.shape[0]
    coords = np.zeros((n, k), dtype=np.float64)

    def _bfs(src):
        d = dijkstra(adj, indices=src, unweighted=True, directed=False)
        finite = np.isfinite(d)
        far = d[finite].max() if finite.any() else 0.0
        d[~finite] = far + 1   # disconnected: push to the far end
        return d

    lm = int(np.argmax(_bfs(0)))
    lm = int(np.argmax(_bfs(lm)))
    mindist = None
    for j in range(k):
        level = _bfs(lm)
        coords[:, j] = level
        mindist = level if mindist is None else np.minimum(mindist, level)
        lm = int(np.argmax(mindist))
    if smooth > 0:
        deg = np.maximum(np.asarray(adj.sum(axis=1)).ravel(), 1.0)
        for _ in range(smooth):
            coords = 0.5 * coords + 0.5 * (adj @ coords) / deg[:, None]
    return coords


def morton_perm(coords: np.ndarray, bits: int = 10) -> np.ndarray:
    """Row permutation by Morton (Z-order) code over up to 3 coordinates:
    geometrically near rows become adjacent, so fixed-size blocks of the
    permuted matrix fill up."""
    q = np.asarray(coords, dtype=np.float64)
    if q.ndim == 1:
        q = q[:, None]
    q = q[:, :3]
    lo, hi = q.min(axis=0), q.max(axis=0)
    span = np.maximum(hi - lo, 1e-300)
    qi = np.minimum(((q - lo) / span * (1 << bits)).astype(np.int64),
                    (1 << bits) - 1)

    def _spread(v):
        v = v.astype(np.int64)
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v

    code = _spread(qi[:, 0])
    if qi.shape[1] > 1:
        code = code | (_spread(qi[:, 1]) << 1)
    if qi.shape[1] > 2:
        code = code | (_spread(qi[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def partition_to_perm(part: np.ndarray, k: int):
    """Group rows by part id: (perm, offsets), offsets of length k + 1 and
    perm[i] = original index of the i-th row of the permuted matrix."""
    counts = np.bincount(part, minlength=k)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    perm = np.argsort(part, kind="stable").astype(np.int64)
    return perm, offsets
