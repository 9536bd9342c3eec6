"""LORASC's banded solves as CUDA graphs (``precond/lorasc_scale.py``:
``_graph_solve``, ``_BandedGraph``) on the CPU: a CPU solve stays eager,
with the replay and capture counters at 0 and nothing cached; the build's
own calls (Lanczos, the pair refinement) pass no cache; the cache's
bookkeeping with a stand-in for the capture whose replay runs the body
again into the captured output: one entry per solve and panel layout, a
new one where the operands hold other factors, each call's answer its own
and bitwise the eager solve's; and a shape whose capture raises runs
eagerly, tried once. The capture itself needs a card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from prealps_tpu_torch.core.generators import elasticity3d
from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
from prealps_tpu_torch.precond import lorasc_scale as tls
from prealps_tpu_torch.solvers.ecg import ECGOptions
from prealps_tpu_torch.utils import timing

torch.set_num_threads(1)

# the benchmark cell's configuration (benchmark/configs/ela_lorasc.json) at 8³
LORASC = dict(nparts=16, br=3, grid=(9, 9, 8), deflation_tol=1e-2, max_deflation=16,
              pencil="agg", correction="sigma", dtype=np.float32, device="cpu")
OPTS = ECGOptions(t=1, tol=1e-5, maxiter=500, variant="omin", layout="tbn")
COUNTERS = ("lorasc.banded_solves", "lorasc.graph_solves", "lorasc.graph_captures")
# the banded solve's factors as stored: the build's type, f64, bf16
STORES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def _counts():
    return tuple(timing.COUNTERS[k] for k in COUNTERS)


@pytest.fixture(scope="module")
def lorasc():
    """The built solver, an eager solve's answer, and the cache argument of
    every banded solve the build made."""
    a = elasticity3d(8, 8, 8, heterogeneous=False)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    calls = []
    real = tls._graph_solve

    def spy(graphs, key, solve, v, factors):
        calls.append((key, graphs, tuple(v.shape)))
        return real(graphs, key, solve, v, factors)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tls, "_graph_solve", spy)
        s = StencilLorascECG.build(a, opts=OPTS, **LORASC)
    x, info = s.solve(b)
    return s, a, b, x, info, calls


class _Replay:
    """A CPU stand-in for a captured graph: ``replay`` runs the body again
    into the output of the first call, as a replay rewrites its pool."""

    def __init__(self, fn):
        self.fn, self.out = fn, fn()

    def replay(self):
        self.out.copy_(self.fn())


def _capture(fn, device):
    g = _Replay(fn)
    return g, g.out


@pytest.fixture
def uncaptured(monkeypatch):
    """Every banded solve takes the graph path, captured by ``_Replay``."""
    monkeypatch.setattr(tls, "_graph_path", lambda v: True)
    monkeypatch.setattr(tls, "capture_graph", _capture)


def test_build_passes_no_cache(lorasc):
    s, *_, calls = lorasc
    assert calls and all(graphs is None for _, graphs, _ in calls)
    assert {key for key, _, _ in calls} == {"aii", "agg"}
    assert max(shape[-2] for key, _, shape in calls if key == "aii") > OPTS.t


def test_cpu_solve_stays_eager(lorasc, monkeypatch):
    s, a, b, x0, info0, _ = lorasc
    assert not tls._graph_path(torch.zeros(1))
    before = _counts()
    monkeypatch.setattr(timing, "_profiler_enabled", lambda: True)
    x, info = s.solve(b)
    monkeypatch.undo()
    solves, graphed, captures = (n - m for n, m in zip(_counts(), before))
    counters = info["trace"]["counters"]
    assert solves == counters["lorasc.banded_solves"] > 3 * info["iters"]
    assert graphed == captures == counters["lorasc.graph_solves"] == 0
    assert counters["lorasc.graph_captures"] == 0
    assert s.precond.graphs == {}
    assert np.array_equal(x, x0) and info["iters"] == info0["iters"]
    assert np.linalg.norm(b - a @ x) <= 1e-5 * np.linalg.norm(b)


def test_uncaptured_cache_solves_bitwise_eager(lorasc, uncaptured):
    """A solve through the cache (the body run again in place of a replay):
    one entry for each banded solve, at the solve's panel width, captured
    once and replayed on every call, and x and iterations bitwise the eager
    solve's."""
    s, a, b, x0, info0, _ = lorasc
    before = _counts()
    x, info = s.solve(b)
    solves, graphed, captures = (n - m for n, m in zip(_counts(), before))
    assert graphed == solves > 3 * info["iters"] and captures == 2
    assert np.array_equal(x, x0) and info["iters"] == info0["iters"]
    assert info["refine_rounds"] == info0["refine_rounds"]
    keys = sorted(s.precond.graphs)
    assert [k[0] for k in keys] == ["agg", "aii"]
    assert all(isinstance(g.graph, _Replay) for g in s.precond.graphs.values())
    pl = s.precond.plan
    shapes = {k[0]: k[1] for k in keys}
    assert shapes == {"agg": (pl.ng_pad, OPTS.t),
                      "aii": (pl.nblk_i, pl.nparts, OPTS.t, pl.bs_i)}
    s.precond.graphs.clear()


def test_a_shape_that_does_not_capture_runs_eager(lorasc, monkeypatch):
    """A capture that raises is tried once a shape: the cache keeps None
    for it, and every call solves its own panel eagerly, bitwise."""
    pc = lorasc[0].precond
    tries = []

    def refuse(fn, device):
        tries.append(device)
        raise RuntimeError("no capture off the card")

    monkeypatch.setattr(tls, "_graph_path", lambda v: True)
    monkeypatch.setattr(tls, "capture_graph", refuse)
    graphs = {}
    panels = [_panels(pc, 1, torch.float32, seed) for seed in (1, 2)]
    before = _counts()
    got = [tls._aii_solve(pc.plan, pc.operands, vi, graphs) for vi, _ in panels]
    assert len(tries) == 1 and list(graphs.values()) == [None]
    assert _counts()[1:] == before[1:]
    for (vi, _), zi in zip(panels, got):
        assert torch.equal(zi, tls._aii_solve(pc.plan, pc.operands, vi))


def _panels(pc, t, dtype, seed):
    """An interior band panel as the apply gathers it (not contiguous) and
    a separator panel, each of width t."""
    pl = pc.plan
    g = torch.Generator().manual_seed(seed)
    r = torch.randn((t, pl.br, pl.nrb), generator=g, dtype=dtype)
    vi = tls._gather_int(pl, pc.operands, tls._to_node_major(r))
    vg = torch.randn((pl.ng_pad, t), generator=g, dtype=dtype)
    return vi, vg


@pytest.mark.parametrize("store", sorted(STORES))
def test_each_call_returns_its_own_answer(lorasc, uncaptured, store):
    """Two calls of each solve through one cache, on other panels: each
    result bitwise the eager solve of its panel, the first unchanged by the
    second; new factors in the operands take a new entry that reads them."""
    pc = lorasc[0].precond
    ops = dict(pc.operands)
    for k in ("aii_linv", "aii_moff", "agg_linv", "agg_moff"):
        ops[k] = ops[k].to(STORES[store])
    dtype = torch.float64 if store == "f64" else torch.float32
    graphs = {}
    (vi1, vg1), (vi2, vg2) = _panels(pc, 3, dtype, 1), _panels(pc, 3, dtype, 2)
    assert not vi1.is_contiguous()
    zi1 = tls._aii_solve(pc.plan, ops, vi1, graphs)
    zg1 = tls._agg_solve(pc.plan, ops, vg1, graphs)
    zi2 = tls._aii_solve(pc.plan, ops, vi2, graphs)
    zg2 = tls._agg_solve(pc.plan, ops, vg2, graphs)
    assert len(graphs) == 2
    for got, want in ((zi1, tls._aii_solve(pc.plan, ops, vi1)),
                      (zi2, tls._aii_solve(pc.plan, ops, vi2)),
                      (zg1, tls._agg_solve(pc.plan, ops, vg1)),
                      (zg2, tls._agg_solve(pc.plan, ops, vg2))):
        assert got.dtype == want.dtype == dtype and torch.equal(got, want)
    assert not torch.equal(zi1, zi2)
    old = dict(graphs)
    ops["aii_linv"] = ops["aii_linv"] * 2
    zi3 = tls._aii_solve(pc.plan, ops, vi1, graphs)
    (k,) = [k for k in graphs if k[0] == "aii"]
    assert graphs[k] is not old[k] and graphs[k].reads((ops["aii_linv"], ops["aii_moff"]))
    assert torch.equal(zi3, tls._aii_solve(pc.plan, ops, vi1))
    assert not torch.equal(zi3, zi1)
