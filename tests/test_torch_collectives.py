"""The collectives of the sharded port at 2 and 4 gloo ranks on the CPU,
against numpy on the global arrays.

One ``mesh.spawn`` a world size serves every case (``torch_shard_workers.
collectives``); the spawn has its own timeout that kills the ranks and
fails the test. The ranks meet through a ``FileStore`` in a fresh
directory, not a TCP port, so parallel test workers cannot collide.

* ``extend_ring``: the ring halo (at 2 ranks both neighbours are the same
  peer) and, for a shard thinner than the halo, the all-gather branch,
  each equal to the single-shard wrap (``extend_wrap``) of the global panel
  cut to the shard, also where the shard's window is longer than the
  panel (2 ranks);
* ``psum``: the sum over the ranks, bitwise equal on every rank, and the
  identity without a group;
* the tiled ``all_gather``, the raw ``all_to_all``, and the ELL operands'
  halo-plan exchange (the product of this shard's rows, in f64 and in
  double-float);
* ``spawn`` itself: a failing or hanging rank raises in the parent within
  its timeout, and no rank survives it.
"""

import time

import numpy as np
import pytest
import torch

import torch_shard_workers as workers
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu_torch.ops.spmm import extend_wrap
from prealps_tpu_torch.parallel import mesh

torch.set_num_threads(1)

NRB_LOC = 7
HALOS = (1, 3, 7, 9)         # 9 > NRB_LOC: the all-gather branch
SPAWN_TIMEOUT = 120


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    store = tmp_path_factory.mktemp(f"store{world}") / "store"
    ela = sym_rac_scaling(elasticity3d(4, 3, 3))[0]
    return mesh.spawn(workers.collectives, world,
                      args=(NRB_LOC, HALOS, ela), init_method=f"file://{store}",
                      timeout=SPAWN_TIMEOUT)


def _global(world):
    return workers.global_panel(1, 6, world * NRB_LOC)


@pytest.mark.parametrize("halo", HALOS)
def test_extend_ring_is_the_global_wrap(ranks, halo):
    world = ranks[0]["world"]
    x = torch.from_numpy(_global(world))
    want = extend_wrap(x, halo).numpy()
    for r in ranks:
        lo = r["rank"] * NRB_LOC
        np.testing.assert_array_equal(r["ring"][halo],
                                      want[:, lo:lo + NRB_LOC + 2 * halo])


def test_extend_ring_on_a_lane_major_panel(ranks):
    """(t, br, nrb) panels: the node axis last, the rows untouched."""
    world, halo = ranks[0]["world"], HALOS[0]
    x = _global(world).reshape(2, 3, -1)
    want = extend_wrap(torch.from_numpy(x), halo).numpy()
    for r in ranks:
        lo = r["rank"] * NRB_LOC
        np.testing.assert_array_equal(r["ring_3d"],
                                      want[..., lo:lo + NRB_LOC + 2 * halo])


def test_ring_and_gather_counts(ranks):
    """The ring halos went through the ring exchange, the thin-shard halo
    through the all-gather."""
    for r in ranks:
        thin = sum(h > NRB_LOC for h in HALOS)
        assert r["calls"]["ring_exchange"] == len(HALOS) - thin + 1
        assert r["calls"]["all_gather"] == thin + 1


def test_psum(ranks):
    parts = [np.random.default_rng(10 + r["rank"]).standard_normal((3, 4))
             for r in ranks]
    want = np.sum(parts, axis=0)
    for r in ranks:
        np.testing.assert_allclose(r["psum"], want, rtol=1e-14, atol=1e-14)
        np.testing.assert_array_equal(r["psum"], ranks[0]["psum"])
        np.testing.assert_array_equal(r["psum_none"], parts[r["rank"]])


def test_all_gather_tiled(ranks):
    x = _global(ranks[0]["world"])
    for r in ranks:
        np.testing.assert_array_equal(r["all_gather"], x)


def test_all_to_all(ranks):
    for r in ranks:
        got = r["all_to_all"]
        for s in range(r["world"]):
            v = s * 100 + r["rank"]
            np.testing.assert_array_equal(got[s], np.array([[v] * 3, [-v] * 3]))


def test_ell_halo_exchange_product(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["ell_y"], r["ell_ref"], rtol=1e-13, atol=1e-13)
        # double-float on f32 inputs: the f32 inputs' product to ~f64 accuracy
        np.testing.assert_allclose(r["ell_df"], r["ell_ref"], rtol=0, atol=1e-5)


def test_spawn_raises_on_a_failing_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*on purpose"):
        mesh.spawn(workers.fails, 2, init_method=f"file://{tmp_path}/store",
                   timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT


def test_spawn_times_out_on_a_hanging_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0\] of 2"):
        mesh.spawn(workers.hangs, 2, init_method=f"file://{tmp_path}/store", timeout=15)
    assert time.monotonic() - t0 < 60


def test_device_rule():
    """``device="cuda"`` is ``cuda:{rank}`` and raises without the card; the
    CPU is kept; an NCCL group of several ranks that do not each own their
    card is refused before any rank joins (NCCL refuses two ranks on one
    card), while gloo takes them and a one-rank NCCL group is allowed."""
    assert mesh.shard_device("cpu", 3) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.shard_device("cuda", 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh.check_backend_device("nccl", 2, "cuda:0", 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh.init_group("nccl", 1, 2, "file:///nonexistent/store", device="cuda:0")
    mesh.check_backend_device("gloo", 4, "cuda:0", 3)
    mesh.check_backend_device("nccl", 1, "cuda:0", 0)
