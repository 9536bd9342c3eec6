"""The frozen input maker against the program's generator, and the
operator cache."""

import numpy as np
import pytest

from benchmark import problems
from benchmark.problems import elasticity3d
from prealps_tpu_torch.core import generators


@pytest.mark.parametrize("het", [False, True])
def test_frozen_generator_equals_the_programs(het):
    for shape in [(4, 4, 4), (3, 2, 5)]:
        mine, meta = elasticity3d.make({"nx": shape[0], "ny": shape[1], "nz": shape[2],
                                        "heterogeneous": het})
        theirs = generators.elasticity3d(*shape, heterogeneous=het)
        assert meta["grid"] == (shape[0] + 1, shape[1] + 1, shape[2])
        assert mine.dtype == np.float64 and mine.has_sorted_indices
        assert np.array_equal(mine.indptr, theirs.indptr)
        assert np.array_equal(mine.indices, theirs.indices)
        assert np.array_equal(mine.data, theirs.data)


def test_cache_round_trip(tmp_path):
    problem = {"generator": "elasticity3d", "nx": 3, "ny": 3, "nz": 3,
               "heterogeneous": True}
    a, meta = problems.load(problem, cache_dir=tmp_path)
    path = problems.cache_path(problem, tmp_path)
    assert path.is_file() and list(tmp_path.iterdir()) == [path]
    b, meta2 = problems.load(problem, cache_dir=tmp_path)
    assert meta2 == meta
    assert (a != b).nnz == 0 and a.shape == b.shape
    other = dict(problem, heterogeneous=False)
    assert problems.cache_path(other, tmp_path) != path
