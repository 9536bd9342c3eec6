"""The benchmark's inputs: a traffic file's ``problem`` names a generator
module of this package (``generator``) and its parameters.

The operator does not depend on the seed, so ``load`` keeps each one it
makes in a fixed directory inside the checkout, keyed by the generator and
its parameters: only the first run of a cell in a checkout assembles it.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
from pathlib import Path

import numpy as np
import scipy.sparse as sp

CACHE_DIR = Path(__file__).resolve().parents[1] / "_cache"


def cache_path(problem: dict, cache_dir: Path = CACHE_DIR) -> Path:
    key = json.dumps(problem, sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return Path(cache_dir) / f"{problem['generator']}_{digest}.npz"


def load(problem: dict, cache_dir: Path = CACHE_DIR):
    """(A as f64 CSR, meta) for ``problem``, from the cache where it is."""
    gen = importlib.import_module(f"{__name__}.{problem['generator']}")
    params = {k: v for k, v in problem.items() if k != "generator"}
    path = cache_path(problem, cache_dir)
    if path.is_file():
        with np.load(path) as f:
            a = sp.csr_matrix((f["data"], f["indices"], f["indptr"]),
                              shape=tuple(f["shape"]))
            meta = json.loads(str(f["meta"]))
        meta["grid"] = tuple(meta["grid"])
        return a, meta
    a, meta = gen.make(params)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, data=a.data, indices=a.indices, indptr=a.indptr,
             shape=np.array(a.shape), meta=json.dumps(meta))
    os.replace(tmp, path)
    return a, meta
