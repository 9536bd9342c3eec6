"""Row splits and orderings (host side, numpy/scipy).

Copies of the pieces of ``prealps_tpu/core/partition.py`` that the
one-device general-sparse path needs: the even split of a row range into
blocks, the row grouping of a partition, and the reverse Cuthill-McKee
ordering of a diagonal block. ``tests/test_torch_general_host.py`` holds
them bitwise equal to the originals.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


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


def partition_to_perm(part: np.ndarray, k: int):
    """Group rows by part id: (perm, offsets), offsets of length k + 1 and
    perm[i] = original index of the i-th row of the permuted matrix."""
    counts = np.bincount(part, minlength=k)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    perm = np.argsort(part, kind="stable").astype(np.int64)
    return perm, offsets
