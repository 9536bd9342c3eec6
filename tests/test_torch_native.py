"""The port's native host library (prealps_tpu_torch/native.py) against the
JAX package's (prealps_tpu/native.py).

* The port's copies of graph.cpp and mmio.cpp are byte-equal to native/.
* The k-way partition (k = 2, 3, 4, 8), the RCM order, the vertex
  separator and the MatrixMarket load are bitwise the JAX package's native
  results on ela_small and poisson_small.
* ``core/partition.py::block_arrow_structure`` and ``kway_partition`` are
  bitwise JAX's with the native default and under PREALPS_TPU_NO_NATIVE
  (both packages read the knob).
* The checks of tests/test_native.py (balance and cut, determinism, RCM
  bandwidth, separator cover, the arrow's interiors decoupled, the load
  against scipy's) on the port.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from prealps_tpu import native as jnative
from prealps_tpu.core import partition as jpart
from prealps_tpu.core.io import save_mtx
from prealps_tpu_torch import native
from prealps_tpu_torch.core import partition as tpart

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's native library is not built")


@pytest.fixture(scope="module", params=["ela_small", "poisson_small"])
def matrix(request):
    return request.getfixturevalue(request.param)


@pytest.mark.parametrize("src", ["graph.cpp", "mmio.cpp"])
def test_sources_byte_equal(src):
    assert (ROOT / "prealps_tpu_torch" / "csrc" / "host" / src).read_bytes() == \
        (ROOT / "native" / src).read_bytes()


def test_library_builds():
    assert native.available(), native.build_info
    assert Path(native.build_info["path"]).is_file()


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_kway_bitwise(matrix, k):
    np.testing.assert_array_equal(native.kway_partition(matrix, k),
                                  jnative.kway_partition(matrix, k))


def test_rcm_and_separator_bitwise(matrix):
    np.testing.assert_array_equal(native.rcm_order(matrix), jnative.rcm_order(matrix))
    part = native.kway_partition(matrix, 4)
    np.testing.assert_array_equal(native.vertex_separator(matrix, part),
                                  jnative.vertex_separator(matrix, part))


@pytest.mark.parametrize("no_native", [False, True])
def test_partition_module_bitwise(matrix, monkeypatch, no_native):
    if no_native:
        monkeypatch.setenv("PREALPS_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("PREALPS_TPU_NO_NATIVE", raising=False)
    assert tpart._use_native() == jpart._use_native() == (not no_native)
    np.testing.assert_array_equal(tpart.kway_partition(matrix, 4),
                                  jpart.kway_partition(matrix, 4))
    s, s_j = tpart.block_arrow_structure(matrix, 4), jpart.block_arrow_structure(matrix, 4)
    for f in ("perm", "interior_offsets", "part"):
        np.testing.assert_array_equal(getattr(s, f), getattr(s_j, f))
    assert (s.sep_start, s.n) == (s_j.sep_start, s_j.n)


def test_native_and_python_partitions_differ(ela_small, monkeypatch):
    """The knob chooses another algorithm: the anchors of each differ."""
    monkeypatch.delenv("PREALPS_TPU_NO_NATIVE", raising=False)
    nat = tpart.kway_partition(ela_small, 4)
    monkeypatch.setenv("PREALPS_TPU_NO_NATIVE", "1")
    assert not np.array_equal(nat, tpart.kway_partition(ela_small, 4))


def test_load_mtx_bitwise(tmp_path):
    a = sp.random(50, 50, density=0.1, random_state=np.random.RandomState(3)).tocsr()
    path = str(tmp_path / "t.mtx")
    save_mtx(path, a)
    m, m_j = native.load_mtx(path), jnative.load_mtx(path)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(m, f), getattr(m_j, f))


def test_load_symmetric_expanded(tmp_path, ela_small):
    path = str(tmp_path / "sym.mtx")
    sym = sp.tril(ela_small).tocoo()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write(f"{ela_small.shape[0]} {ela_small.shape[1]} {sym.nnz}\n")
        for i, j, v in zip(sym.row, sym.col, sym.data):
            f.write(f"{i + 1} {j + 1} {float(v)!r}\n")
    m, m_j = native.load_mtx(path), jnative.load_mtx(path)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(m, f), getattr(m_j, f))
    low = sp.tril(ela_small, k=-1)
    assert abs(m - (low + low.T + sp.diags(ela_small.diagonal()))).max() == 0


def test_load_refuses_missing_file(tmp_path):
    with pytest.raises(RuntimeError, match="rc=1"):
        native.load_mtx(str(tmp_path / "missing.mtx"))


class TestNativeGraph:
    """tests/test_native.py on the port."""

    def test_kway_balance_and_cut(self, poisson_small):
        k = 8
        part = native.kway_partition(poisson_small, k)
        counts = np.bincount(part, minlength=k)
        assert counts.min() > 0
        assert counts.max() <= int(1.3 * poisson_small.shape[0] / k)
        coo = sp.triu(poisson_small, k=1).tocoo()
        assert np.count_nonzero(part[coo.row] != part[coo.col]) < 0.35 * coo.nnz

    def test_rcm_bandwidth(self, ela_small):
        perm = native.rcm_order(ela_small)
        assert sorted(perm.tolist()) == list(range(ela_small.shape[0]))
        p2 = np.asarray(reverse_cuthill_mckee(ela_small, symmetric_mode=True))

        def bw(p):
            ap = ela_small[p][:, p].tocoo()
            return np.abs(ap.row - ap.col).max()

        assert bw(perm) <= bw(p2) * 1.2

    def test_separator_covers_cut_and_arrow_decouples(self, ela_small, monkeypatch):
        monkeypatch.delenv("PREALPS_TPU_NO_NATIVE", raising=False)
        part = native.kway_partition(ela_small, 4)
        in_sep = native.vertex_separator(ela_small, part)
        coo = sp.triu(ela_small, k=1).tocoo()
        cut = part[coo.row] != part[coo.col]
        assert (in_sep[coo.row[cut]] | in_sep[coo.col[cut]]).all()
        ba = tpart.block_arrow_structure(ela_small, 4)
        ap = sp.triu(tpart.permute(ela_small, ba.perm), k=1).tocoo()
        inter = (ap.row < ba.sep_start) & (ap.col < ba.sep_start)
        off = ba.interior_offsets
        np.testing.assert_array_equal(
            np.searchsorted(off, ap.row[inter], side="right"),
            np.searchsorted(off, ap.col[inter], side="right"))


def test_build_is_shared_across_processes(tmp_path):
    """A second process finds the library the first built (same hashed
    name), so concurrent test workers build it once."""
    import subprocess
    import sys

    code = ("from prealps_tpu_torch import native; assert native.available(); "
            "print(native.build_info['path'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ}, timeout=300, check=True)
    assert out.stdout.strip() == native.build_info["path"]
