"""The program's spans and counters (``prealps_tpu_torch/utils/timing.py``)
on the CPU: nothing recorded without a profiler; under one, a
``DistributedECG`` solve's spans nested as ``parallel/driver.py`` opens them, one trace
id, ``host.syncs`` equal to the ``host.read`` spans; the build stages as
spans that ``solver.timings`` is filled from; the same for
``StencilLorascECG`` (``parallel/lorasc_stencil.py``), whose ``host.syncs``
also equals the tensor reads the solve makes, and whose build carries the
pair-refinement counters; the spans on the clock of the
profiler's exported trace; a span's cost off and on (printed); and the
port's busy-time helpers on a synthetic interval list."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from prealps_tpu_torch import timing as ptiming
from prealps_tpu_torch.core.generators import elasticity3d
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
from prealps_tpu_torch.solvers.ecg import ECGOptions
from prealps_tpu_torch.utils import timing

torch.set_num_threads(1)

# the benchmark cell's configuration (benchmark/configs/ela_ecg12_bj.json)
BUILD = dict(fmt="stencil", br=3, precond="bj", block_size=768, bj_dedupe=False,
             dtype=np.float32, device="cpu")
OPTS = ECGOptions(t=12, tol=1e-5, maxiter=3000, variant="odir_fused", layout="tbn")
# each span's parent, as parallel/driver.py and the solver open them
PARENTS = {
    "solve.prep": {"solve"}, "refine.round": {"solve"}, "solve.gather": {"solve"},
    "solve.host_check": {"solve"}, "ecg.init": {"refine.round", "solve"},
    "ecg.step": {"refine.round", "solve"}, "ecg.finalize": {"refine.round", "solve"},
    "refine.resid": {"refine.round"},
    "spmm": {"ecg.init", "ecg.step", "refine.resid"},
    "precond": {"ecg.init", "ecg.step"},
    "host.read": {"solve", "refine.round", "ecg.finalize", "solve.gather"},
}


@pytest.fixture(scope="module")
def solver():
    a = elasticity3d(10, 10, 10)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    return DistributedECG.build(a, nshards=1, opts=OPTS, **BUILD), a, b


def test_no_profiler_records_nothing(solver, monkeypatch):
    s, a, b = solver

    class Refused:
        def __init__(self, *args):
            raise AssertionError("a trace was opened with no profiler recording")

    monkeypatch.setattr(timing, "Trace", Refused)
    x, info = s.solve(b)
    assert "trace" not in info and timing._trace is None
    assert np.linalg.norm(b - a @ x) <= 1e-5 * np.linalg.norm(b)


def test_traced_solve_nests_its_spans(solver):
    s, a, b = solver
    with profile(activities=[ProfilerActivity.CPU]):
        x, info = s.solve(b)
    tr = info["trace"]
    spans, counters = tr["spans"], tr["counters"]
    root = spans[0]
    assert root["name"] == "solve" and root["parent"] == -1
    assert {sp["id"] for sp in spans} == {tr["id"]}
    names = [sp["name"] for sp in spans]
    assert set(names) == set(PARENTS) | {"solve"}
    for sp in spans[1:]:
        parent = spans[sp["parent"]]
        assert parent["name"] in PARENTS[sp["name"]], (sp["name"], parent["name"])
        assert parent["start_ns"] <= sp["start_ns"] <= sp["end_ns"] <= parent["end_ns"]
    assert counters["host.syncs"] == names.count("host.read") > 0
    assert names.count("ecg.step") == info["iters"]
    assert names.count("refine.round") == info["device_rounds"]
    assert {"launches.stencil_flat_ext", "launches.bj_apply_pallas"} <= set(counters)
    # the same answer as an untraced solve
    x0, info0 = s.solve(b)
    assert info0["iters"] == info["iters"] and np.array_equal(x0, x)


def test_build_stages_are_spans_and_timings(tmp_path):
    a = elasticity3d(4, 4, 4)
    with timing.profile_trace(str(tmp_path)):
        s = DistributedECG.build(a, nshards=1, opts=OPTS, **BUILD)
    events = _program_events(tmp_path)
    stages = {e["name"]: e for e in events if e["name"].startswith("build.")}
    assert set(stages) == {f"build.{k}" for k in s.timings} == {
        "build.layout", "build.fmt_convert", "build.precond"}
    for k, v in s.timings.items():
        assert stages[f"build.{k}"]["dur"] == pytest.approx(v * 1e6, abs=1e-3)
    (root,) = [e for e in events if e["name"] == "build"]
    assert all(root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
               for e in stages.values())
    assert {e["args"]["trace"] for e in stages.values()} == {root["args"]["trace"]}


def test_spans_share_the_exported_trace_clock(tmp_path):
    """A span around a ``record_function`` range brackets it in the file
    the profiler writes (``ts``·1000 + ``baseTimeNanoseconds`` on the
    spans' converted clock)."""
    with timing.profile_trace(str(tmp_path)):
        with timing.scope("outer"):
            time.sleep(0.002)
            with record_function("inner_range"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.002)
    (doc,) = _docs(tmp_path)
    (outer,) = [e for e in doc["traceEvents"]
                if e.get("name") == "outer" and e.get("cat") == "program_span"]
    (inner,) = [e for e in doc["traceEvents"]
                if e.get("name") == "inner_range" and e.get("ph") == "X"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_traced_roots_and_host_reads():
    """Each decorated call is its own trace, the outer one restored after
    it; ``host_read`` counts and spans its read; outside a profiler the
    root yields None."""
    calls = []

    @timing.traced("inner")
    def inner():
        with timing.traced("probe") as tr:
            calls.append(tr)
        return timing.host_read(bool, torch.ones(()))

    with timing.traced("off") as tr:
        assert tr is None and inner() is True
    assert calls == [None]
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.traced("outer") as outer:
            with timing.scope("s"):
                assert inner() is True
            assert timing._trace is outer
    assert timing._trace is None
    d = outer.as_dict()
    assert [sp["name"] for sp in d["spans"]] == ["outer", "s"]
    assert d["counters"]["host.syncs"] == 0
    probe = calls[-1].as_dict()
    assert probe["id"] != d["id"] and [sp["name"] for sp in probe["spans"]] == ["probe"]


def test_span_cost_off_and_on():
    """The cost of one span, recording and not (printed, not bound)."""
    span, n = timing.scope("cost"), 20000

    def per_span_ns():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span:
                pass
        return (time.perf_counter_ns() - t0) / n

    off = per_span_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.traced("root") as tr:
            on = per_span_ns()
    assert len(tr.spans) == n + 1
    print(f"span cost on this host's CPU: {off:.0f} ns off, {on:.0f} ns on")
    assert off > 0 and on > 0


def test_busy_ms_is_the_union_of_device_intervals(tmp_path):
    """``timing.py``'s busy time: overlapping device operations once, gaps
    left out, host events and flow events ignored."""
    assert ptiming.union_ms([(0.0, 10.0), (5.0, 10.0), (30.0, 1.0)]) == pytest.approx(0.016)
    assert ptiming.union_ms([(0.0, 10.0), (2.0, 3.0)]) == pytest.approx(0.010)
    assert ptiming.union_ms([]) == 0.0
    events = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 100.0, "dur": 10.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 105.0,
               "dur": 10.0},
              {"ph": "X", "cat": "Kernel", "name": "k2", "ts": 130.0, "dur": 1.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 90.0, "dur": 100.0},
              {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 100.0}]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    assert ptiming.device_intervals(Prof()) == [(100.0, 10.0), (105.0, 10.0), (130.0, 1.0)]
    assert ptiming.device_busy_ms(Prof()) == pytest.approx(0.016)


# the benchmark cell ela_lorasc's configuration at 8³ (16 parts, 16 pairs at
# most: one kept)
LORASC = dict(nparts=16, br=3, grid=(9, 9, 8), deflation_tol=1e-2, max_deflation=16,
              pencil="agg", correction="sigma", dtype=np.float32, device="cpu")
LORASC_OPTS = ECGOptions(t=1, tol=1e-5, maxiter=500, variant="omin", layout="tbn")
LORASC_PARENTS = {
    "solve.prep": {"solve"}, "refine.round": {"solve"}, "solve.gather": {"solve"},
    "solve.host_check": {"solve"}, "ecg.init": {"refine.round"},
    "ecg.step": {"refine.round"}, "ecg.finalize": {"refine.round"},
    "refine.resid": {"refine.round"}, "spmm": {"ecg.init", "ecg.step"},
    "precond": {"ecg.init", "ecg.step"}, "precond.banded": {"precond"},
    "host.read": {"refine.round", "ecg.finalize", "solve.gather"},
}
LORASC_STAGES = {"build.fmt_convert", "build.plan", "build.factor", "build.lanczos",
                 "build.pair_refine"}
# the tensor methods through which a solve can read a device value
READS = ("__bool__", "__float__", "__int__", "item", "cpu")


@pytest.fixture(scope="module")
def lorasc():
    """The build traced, with the profiler's flag read as set (the switch
    the spans test): a CPU profiler recording every operation of the
    Lanczos would take five times the build."""
    a = elasticity3d(8, 8, 8, heterogeneous=False)
    traces = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(timing, "_profiler_enabled", lambda: True)
        m.setattr(timing, "_exports", [traces])
        s = StencilLorascECG.build(a, opts=LORASC_OPTS, **LORASC)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    (build,) = [t.as_dict() for t in traces]
    return s, a, b, build


def test_lorasc_build_stages_and_counters(lorasc):
    s, _, _, build = lorasc
    spans, counters = build["spans"], build["counters"]
    assert spans[0]["name"] == "build" and spans[0]["parent"] == -1
    stages = [sp for sp in spans if sp["name"].startswith("build.")]
    assert {sp["name"] for sp in stages} == LORASC_STAGES == {f"build.{k}" for k in s.timings}
    assert all(sp["parent"] == 0 for sp in stages)
    assert counters["lorasc.pairs_kept"] == s.precond.deflated > 0
    assert counters["lorasc.pair_candidates"] >= s.precond.deflated
    for k, v in s.timings.items():
        ns = sum(sp["end_ns"] - sp["start_ns"] for sp in stages if sp["name"] == f"build.{k}")
        assert ns * 1e-9 == pytest.approx(v, abs=1e-9)
    assert set(s.precond.timings) == {"plan", "factor", "lanczos", "pair_refine"}


def test_traced_lorasc_solve_nests_its_spans(lorasc, monkeypatch):
    s, a, b, _ = lorasc
    reads = []
    for name in READS:
        method = getattr(torch.Tensor, name)

        def counted(self, *args, _method=method, **kw):
            reads.append(name)
            return _method(self, *args, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(timing, "_profiler_enabled", lambda: True)
    x, info = s.solve(b)
    monkeypatch.undo()
    tr = info["trace"]
    spans, counters = tr["spans"], tr["counters"]
    assert spans[0]["name"] == "solve" and spans[0]["parent"] == -1
    names = [sp["name"] for sp in spans]
    assert set(names) == set(LORASC_PARENTS) | {"solve"}
    for sp in spans[1:]:
        parent = spans[sp["parent"]]
        assert parent["name"] in LORASC_PARENTS[sp["name"]], (sp["name"], parent["name"])
        assert parent["start_ns"] <= sp["start_ns"] <= sp["end_ns"] <= parent["end_ns"]
    assert counters["host.syncs"] == names.count("host.read") == len(reads) > 0
    assert names.count("ecg.step") == info["iters"]
    assert names.count("refine.round") == info["refine_rounds"] == names.count("refine.resid")
    assert counters["launches.stencil_bsr_spmm_t_pallas_bs"] == 0     # plain route on the CPU
    assert np.linalg.norm(b - a @ x) <= 1e-5 * np.linalg.norm(b)
    x0, info0 = s.solve(b)
    assert "trace" not in info0 and info0["iters"] == info["iters"]
    assert np.array_equal(x0, x)


def _docs(log_dir):
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    return [json.loads(f.read_text()) for f in files]


def _program_events(log_dir):
    (doc,) = _docs(log_dir)
    return [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
