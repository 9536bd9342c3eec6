"""The port's file IO (prealps_tpu_torch/core/io.py) against the JAX
package's (prealps_tpu/core/io.py): round trips, as tests/test_core.py's
TestIO, and every load bitwise the JAX load of the same file.
"""

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from prealps_tpu.core import io as jio
from prealps_tpu_torch.core import io as tio


def _csr_equal(a, b):
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.shape == b.shape and a.dtype == b.dtype


def test_vector_roundtrip_bitwise(tmp_path, rng):
    v = rng.standard_normal(57)
    p = str(tmp_path / "v.txt")
    tio.save_vector(p, v)
    np.testing.assert_allclose(tio.load_vector(p), v, rtol=1e-12)
    np.testing.assert_array_equal(tio.load_vector(p), jio.load_vector(p))
    tio.save_vector(str(tmp_path / "v2.txt"), v)
    jio.save_vector(str(tmp_path / "v3.txt"), v)
    assert (tmp_path / "v2.txt").read_bytes() == (tmp_path / "v3.txt").read_bytes()


def test_vector_matrixmarket_array(tmp_path, rng):
    v = rng.standard_normal((12, 1))
    p = str(tmp_path / "v.mtx")
    scipy.io.mmwrite(p, v)
    np.testing.assert_array_equal(tio.load_vector(p), jio.load_vector(p))
    np.testing.assert_array_equal(tio.load_vector(p, dtype=np.float32),
                                  jio.load_vector(p, dtype=np.float32))


def test_matrix_roundtrip_bitwise(tmp_path):
    a = sp.random(30, 30, density=0.2, random_state=np.random.RandomState(1)).tocsr()
    p = str(tmp_path / "a.mtx")
    tio.save_mtx(p, a, comment="port")
    a2 = tio.load_mtx(p)
    assert abs(a - a2).max() < 1e-14
    _csr_equal(a2, jio.load_mtx(p))
    _csr_equal(tio.load_mtx(p, dtype=np.float32), jio.load_mtx(p, dtype=np.float32))


def test_symmetric_file_expanded(tmp_path, ela_small):
    p = str(tmp_path / "sym.mtx")
    scipy.io.mmwrite(p, sp.coo_matrix(sp.tril(ela_small)), symmetry="symmetric")
    m = tio.load_mtx(p)
    _csr_equal(m, jio.load_mtx(p))
    low = sp.tril(ela_small, k=-1)
    assert abs(m - (low + low.T + sp.diags(ela_small.diagonal()))).max() == 0


def test_partition_roundtrip_bitwise(tmp_path):
    part = np.array([0, 1, 1, -1, 2, 0, -1, 2], dtype=np.int64)
    p2, p3 = tmp_path / "p2.txt", tmp_path / "p3.txt"
    tio.save_partition(str(p2), part)
    jio.save_partition(str(p3), part)
    assert p2.read_bytes() == p3.read_bytes()
    assert "separator rows marked -1" in p2.read_text().splitlines()[0]
    np.testing.assert_array_equal(tio.load_partition(str(p2), 8), part)
    np.testing.assert_array_equal(tio.load_partition(str(p2)), jio.load_partition(str(p2)))


def test_partition_length_mismatch(tmp_path):
    p = str(tmp_path / "p.txt")
    tio.save_partition(p, np.zeros(5, dtype=np.int64))
    with pytest.raises(ValueError, match="5 entries, matrix has 6 rows"):
        tio.load_partition(p, 6)
    with pytest.raises(ValueError, match="5 entries, matrix has 6 rows"):
        jio.load_partition(p, 6)
