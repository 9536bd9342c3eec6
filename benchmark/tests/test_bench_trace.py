"""Span attribution, busy time and the breakdown on a synthetic trace, and
the span wrapper's markers."""

import pytest

from benchmark import trace

MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def op(name, ts, dur):
    return {"name": name, "ts": float(ts), "dur": float(dur)}


def synthetic():
    ops = [op("void gemm<float>(int)", 0, 10),
           op(MARK, 12, 1),
           op("void stencil_pipe<float, 3, 12>(float*)", 14, 20),
           op(MARK, 35, 1),
           op(MARK, 40, 1),
           op("bmm_kernel", 42, 30),
           op("copy", 73, 2),
           op(MARK, 80, 1),
           op("Memcpy DtoH (Device -> Pinned)", 90, 5)]
    marks = [("b", "spmm", {"t": 12}), ("e", "spmm", None),
             ("b", "precond", None), ("e", "precond", None)]
    return ops, marks


def test_attribute_by_stream_order():
    ops, marks = synthetic()
    work, instances = trace.attribute(ops, marks)
    assert [e["span"] for e in work] == [None, "spmm", "precond", "precond", None]
    assert instances == [("spmm", {"t": 12}), ("precond", None)]
    assert [e["inst"] for e in work] == [None, 0, 1, 1, None]


def test_nested_spans():
    ops = [op(MARK, 0, 1), op("a", 2, 1), op(MARK, 4, 1), op("b", 6, 1),
           op(MARK, 8, 1), op("c", 10, 1), op(MARK, 12, 1)]
    marks = [("b", "outer", None), ("b", "inner", None), ("e", "inner", None),
             ("e", "outer", None)]
    work, _ = trace.attribute(ops, marks)
    assert [e["span"] for e in work] == ["outer", "inner", "outer"]


def test_lost_markers_leave_the_spans_unread():
    ops, marks = synthetic()
    work, instances = trace.attribute(ops[:-2], marks)
    assert instances is None and all(e["span"] is None for e in work)


def test_union_and_breakdown():
    ops, marks = synthetic()
    work, _ = trace.attribute(ops, marks)
    assert trace.union_s(work) == pytest.approx(67e-6)
    assert trace.union_s([op("a", 0, 10), op("b", 5, 10), op("c", 30, 1)]) == \
        pytest.approx(16e-6)
    brk = trace.breakdown(work)
    assert brk["device_ops"][0] == ["bmm_kernel", pytest.approx(30e-6)]
    assert len(brk["device_ops"]) == 5
    gaps = dict((k, v) for k, v in brk["idle_gaps"])
    assert gaps["spmm: gemm -> stencil_pipe"] == pytest.approx(4e-6)
    assert gaps["outside spans: copy -> Memcpy DtoH"] == pytest.approx(15e-6)


def test_spans_wrap_marks_begin_and_end():
    class Ops:
        def a_apply(self, x):
            return x + 1

    calls = []
    spans = trace.Spans(mark=lambda: calls.append("m"))
    o = Ops()
    spans.wrap(o, "a_apply", "spmm", args=lambda x: {"t": x})
    assert o.a_apply(3) == 4
    assert spans.marks == [("b", "spmm", {"t": 3}), ("e", "spmm", None)]
    assert calls == ["m", "m"]


def test_short_names():
    assert trace.short("void stencil_pipe<float, 3>(float*)") == "stencil_pipe"
    assert trace.short("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
    assert trace.short("plain") == "plain"


def test_busy_per_solve_reader():
    from benchmark import harness

    reader = harness.load_module(harness.HERE / "layer_metrics" / "device.busy_ms_per_solve.py",
                                 "reader_busy")
    ctx = {"work": [op("k", 0, 1)], "busy_s": 2.7, "infos": [{}, {}, {}]}
    assert reader.read(ctx) == pytest.approx(900.0)
    assert reader.read(dict(ctx, work=[])) is None
    assert reader.read(dict(ctx, infos=[])) is None
