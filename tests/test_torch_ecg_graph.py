"""The stacked ODIR-fused step's graph runner (``solvers/ecg.py::_StepGraph``)
on the CPU: which runs take the graph path (a CUDA panel with no process
group, the stacked ODIR-fused step; everything else eager), the counters a
CPU run leaves at 0, and the runner's bookkeeping of its static buffers
with the algebra called in place of a replay, bitwise against the eager
loop: the thresholds and the state copied in at a run's start, the stop
flag, the history written at the device index, the results copied out at
its end. The capture itself needs a card (``tests/test_torch_cuda.py``)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from prealps_tpu_torch.core.generators import elasticity3d
from prealps_tpu_torch.core.layout import pad_to_padded
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers import ecg as tecg
from prealps_tpu_torch.utils import timing

torch.set_num_threads(1)

# the benchmark cell's configuration (benchmark/configs/ela_ecg12_bj.json)
BUILD = dict(fmt="stencil", br=3, precond="bj", block_size=768, bj_dedupe=False,
             dtype=np.float32, device="cpu")
OPTS = tecg.ECGOptions(t=12, tol=1e-5, maxiter=3000, variant="odir_fused", layout="tbn")
# a direct f32 run: a tolerance f32 reaches without refinement
RUN = replace(OPTS, tol=1e-3, maxiter=400)


@pytest.fixture(scope="module")
def solver():
    a = elasticity3d(8, 8, 8)
    b = np.random.default_rng(5).standard_normal(a.shape[0])
    return DistributedECG.build(a, nshards=1, opts=OPTS, **BUILD), a, b


@pytest.fixture
def uncaptured(monkeypatch):
    """Every eligible-looking run goes through a fresh runner whose replay
    is its algebra called eagerly; returns the runners made."""
    made = []

    def step_graph(state, opts):
        sg = tecg._StepGraph(state.mask.shape[0], state.w.dtype, state.w.device, opts,
                             capture=False)
        made.append(sg)
        return sg

    monkeypatch.setattr(tecg, "_graph_path", lambda device, opts, group: True)
    monkeypatch.setattr(tecg, "_step_graph", step_graph)
    return made


def _rhs(s, b):
    """b in the operands' space, and the split of its columns."""
    rhs = s._to_shard(pad_to_padded(s.layout, b.astype(np.float32)))
    return rhs, s.operands.split_assign(OPTS.t, s.layout.n_pad)


def _run(s, b, opts, a_apply=None, max_steps=None, chunks=True):
    """ecg_init, then ecg_run (in chunks of ``max_steps`` until a chunk
    makes no step, or one chunk)."""
    a_apply = a_apply or s.operands.a_apply
    rhs, assign = _rhs(s, b)
    state, normb = tecg.ecg_init(a_apply, s.operands.m_apply, rhs, opts, assign)
    if not chunks:
        return tecg.ecg_run(a_apply, s.operands.m_apply, state, normb, opts,
                            max_steps=max_steps)
    while True:
        nxt = tecg.ecg_run(a_apply, s.operands.m_apply, state, normb, opts,
                           max_steps=max_steps)
        done = max_steps is None or nxt.it == state.it
        state = nxt
        if done:
            return state


def _assert_same_state(got, want):
    assert got.it == want.it
    for name in ("w", "mask", "res", "breakdown", "history", "best_res", "stall"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_graph_path_choice():
    """A CUDA panel, no group, the stacked ODIR-fused step: the graph. The
    CPU, a group, the unstacked or ``nt`` variants and stacked omin: eager."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert tecg._graph_path(cuda, OPTS, None)
    assert tecg._graph_path(cuda, replace(OPTS, adaptive=True), None)
    assert not tecg._graph_path(cpu, OPTS, None)
    assert not tecg._graph_path(cuda, OPTS, object())
    assert not tecg._graph_path(cuda, replace(OPTS, stacked=False), None)
    assert not tecg._graph_path(cuda, replace(OPTS, layout="nt"), None)
    assert not tecg._graph_path(cuda, replace(OPTS, variant="omin", stacked=True), None)
    assert not tecg._graph_path(cuda, replace(OPTS, variant="odir"), None)


def test_cpu_solve_runs_eager_with_the_counters_at_zero(solver):
    from torch.profiler import ProfilerActivity, profile

    s, a, b = solver
    before = dict(timing.COUNTERS)
    with profile(activities=[ProfilerActivity.CPU]):
        x, info = s.solve(b)
    assert timing.COUNTERS == before
    counters = info["trace"]["counters"]
    assert counters["ecg.graph_steps"] == counters["ecg.graph_captures"] == 0
    assert np.linalg.norm(b - a @ x) <= 1e-5 * np.linalg.norm(b)


def test_split_step_composes_the_eager_step(solver):
    """(a) + (b) + (c) called in turn give the eager step's state, and
    (b)'s stop flag is the loop's test on that state."""
    s, _, b = solver
    ops = s.operands
    state = _run(s, b, RUN, max_steps=3, chunks=False)
    assert state.it == 3
    normb = torch.ones((), dtype=torch.float32)     # the step does not read it
    red_tol = torch.tensor(1e-7, dtype=torch.float32)
    tol_abs = torch.tensor(1e-3, dtype=torch.float32)
    want = tecg._iter_odir_fused_stacked(state, ops.a_apply, ops.m_apply, OPTS, normb,
                                         red_tol)
    alg = tecg._step_algebra(tecg._gram(state.w), state.mask, state.best_res,
                             state.stall, state.breakdown, red_tol, OPTS, tol_abs)
    w = tecg._panel_update(state.w, alg.c, ops.a_apply, ops.m_apply, state.panel_shape)
    assert torch.equal(w, want.w) and torch.equal(alg.res, want.res)
    assert torch.equal(alg.best_res, want.best_res) and torch.equal(alg.stall, want.stall)
    assert bool(alg.ok) == bool(tecg._go_on(want.res, want.mask, want.breakdown,
                                            want.stall, tol_abs, OPTS.stall_window))
    assert alg.c.shape == (84, 84) and tecg._step_algebra(
        tecg._gram(state.w), state.mask, state.best_res, state.stall, state.breakdown,
        red_tol, OPTS).ok is None


CASES = {
    "default": dict(),
    "stall_window": dict(opts=dict(stall_window=3, stall_rtol=0.5)),
    "no_history": dict(opts=dict(record_history=False)),
    "max_steps": dict(max_steps=7),
    "zero_columns": dict(zero_columns=True),
    "breakdown": dict(negate=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_matches_the_eager_loop_bitwise(solver, uncaptured, monkeypatch, case):
    """Each case's run through the runner, against the eager loop on the
    same solver and b: every field of the final state bitwise equal."""
    s, _, b = solver
    spec = CASES[case]
    opts = replace(RUN, **spec.get("opts", {}))
    b = b.copy()
    if spec.get("zero_columns"):
        b[: b.size // 3] = 0.0           # the first split columns empty
    a_apply = None
    if spec.get("negate"):
        a_apply = lambda x: -s.operands.a_apply(x)   # PᵀAP negative: breakdown
    before = dict(timing.COUNTERS)
    got = _run(s, b, opts, a_apply, spec.get("max_steps"))
    assert uncaptured and timing.COUNTERS == before     # no replay, no capture
    monkeypatch.undo()
    want = _run(s, b, opts, a_apply, spec.get("max_steps"))
    _assert_same_state(got, want)
    assert 0 < got.it < opts.maxiter
    if case == "zero_columns":
        assert 0 < float(torch.sum(want.mask)) < opts.t
    if case == "breakdown":
        assert bool(want.breakdown) and want.it == 1
    if case == "stall_window":
        assert int(want.stall) == 3
    if case == "no_history":
        assert bool((want.history == -1).all())


def test_runner_solve_matches_eager_solve(solver, uncaptured, monkeypatch):
    """A whole refined solve through the runner, a runner for every round:
    x, iterations, rounds and history bitwise the eager solve's."""
    s, _, b = solver
    x_g, info_g = s.solve(b)
    assert len(uncaptured) == info_g["refine_rounds"] >= 1
    monkeypatch.undo()
    x_e, info_e = s.solve(b)
    assert np.array_equal(x_g, x_e) and np.array_equal(info_g["history"], info_e["history"])
    assert (info_g["iters"], info_g["refine_rounds"]) == (info_e["iters"],
                                                          info_e["refine_rounds"])
