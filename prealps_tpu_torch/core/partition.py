"""Row splits, partitions and orderings (host side, numpy/scipy).

Copies of the pieces of ``prealps_tpu/core/partition.py`` that the driver
needs: the even split of a row range into blocks, the k-way partition of
the multi-GPU row layout (recursive BFS bisection with boundary
refinement: the JAX package's Python algorithm), the row grouping of a
partition, the reverse Cuthill-McKee ordering, and the BFS
pseudo-coordinates and Morton order of ``fmt="auto"``'s block clustering.
``tests/test_torch_general_host.py``, ``tests/test_torch_dia_host.py`` and
``tests/test_torch_partition_kway.py`` hold them bitwise equal to the
originals (the k-way partition to the JAX Python version: the JAX package's
native C++ partitioner, which it prefers where built, gives other parts).
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


def _bfs_levels(adj: sp.csr_matrix, start: int, mask: np.ndarray) -> np.ndarray:
    """BFS level of every vertex in ``mask`` from ``start`` (-1 if unreached)."""
    n = adj.shape[0]
    level = np.full(n, -1, dtype=np.int64)
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    lv = 0
    indptr, indices = adj.indptr, adj.indices
    while frontier.size:
        lv += 1
        nbrs = np.concatenate([indices[indptr[v]: indptr[v + 1]] for v in frontier])
        nbrs = np.unique(nbrs)
        nbrs = nbrs[(level[nbrs] == -1) & mask[nbrs]]
        level[nbrs] = lv
        frontier = nbrs
    return level


def _pseudo_peripheral(adj: sp.csr_matrix, mask: np.ndarray) -> int:
    """Double-BFS pseudo-peripheral vertex within the masked subgraph."""
    cand = np.flatnonzero(mask)
    start = int(cand[0])
    for _ in range(3):
        level = _bfs_levels(adj, start, mask)
        reached = level >= 0
        far = np.flatnonzero(reached & (level == level[reached].max()))
        nxt = int(far[0])
        if nxt == start:
            break
        start = nxt
    return start


def _bisect(adj: sp.csr_matrix, vertices: np.ndarray, refine_passes: int = 8):
    """Split ``vertices`` into two balanced halves with a small edge cut: a
    BFS-grown half from a pseudo-peripheral vertex, then boundary
    refinement (greedy gain moves across the cut within a 5 % balance
    slack)."""
    n_all = adj.shape[0]
    mask = np.zeros(n_all, dtype=bool)
    mask[vertices] = True
    nv = vertices.size
    target = nv // 2

    src = _pseudo_peripheral(adj, mask)
    level = _bfs_levels(adj, src, mask)
    # disconnected pieces: level max + 1, so they land in side B
    level[mask & (level == -1)] = level.max() + 1

    order = vertices[np.lexsort((vertices, level[vertices]))]
    side = np.zeros(n_all, dtype=np.int8)
    side[order[target:]] = 1

    indptr, indices = adj.indptr, adj.indices

    def gains(cands):
        g = np.empty(cands.size, dtype=np.int64)
        for i, v in enumerate(cands):
            nb = indices[indptr[v]: indptr[v + 1]]
            nb = nb[mask[nb]]
            same = np.count_nonzero(side[nb] == side[v])
            g[i] = (nb.size - same) - same      # external - internal
        return g

    counts = np.array([target, nv - target], dtype=np.int64)
    slack = max(1, nv // 20)
    for _ in range(refine_passes):
        moved_any = False
        bnd = []
        for v in vertices:
            nb = indices[indptr[v]: indptr[v + 1]]
            nb = nb[mask[nb]]
            if nb.size and np.any(side[nb] != side[v]):
                bnd.append(v)
        if not bnd:
            break
        bnd = np.array(bnd, dtype=np.int64)
        g = gains(bnd)
        order_g = np.argsort(-g, kind="stable")
        for idx in order_g:
            v = bnd[idx]
            if g[idx] <= 0:
                break
            s = side[v]
            if (counts[s] - 1 < target - slack
                    or counts[1 - s] + 1 > (nv - target) + slack):
                continue
            side[v] = 1 - s
            counts[s] -= 1
            counts[1 - s] += 1
            moved_any = True
        if not moved_any:
            break

    return vertices[side[vertices] == 0], vertices[side[vertices] == 1]


def kway_partition(a: sp.spmatrix, k: int, refine_passes: int = 8) -> np.ndarray:
    """Partition the graph of A into k parts; returns the part id of each
    vertex. Recursive bisection into floor / ceil halves of k (any k): a
    BFS-ordered split at the ka/kk fraction, or ``_bisect`` where two parts
    remain. Deterministic."""
    adj = _adjacency(a)
    n = adj.shape[0]
    part = np.zeros(n, dtype=np.int64)
    if k <= 1:
        return part
    stack = [(np.arange(n, dtype=np.int64), 0, k)]
    while stack:
        verts, base, kk = stack.pop()
        if kk == 1:
            part[verts] = base
            continue
        ka = kk // 2
        kb = kk - ka
        mask = np.zeros(n, dtype=bool)
        mask[verts] = True
        src = _pseudo_peripheral(adj, mask)
        level = _bfs_levels(adj, src, mask)
        level[mask & (level == -1)] = level.max() + 1
        order = verts[np.lexsort((verts, level[verts]))]
        target = (verts.size * ka) // kk
        va, vb = order[:target], order[target:]
        if kk == 2:
            va, vb = _bisect(adj, verts, refine_passes)
        stack.append((np.sort(va), base, ka))
        stack.append((np.sort(vb), base + ka, kb))
    return part


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
