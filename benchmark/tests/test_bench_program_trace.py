"""The program's spans on the device trace's clock (``program_trace.py``) and
the four readers of them, on synthetic solves: a known offset recovered
inside its bracket, idle time given to the span open at that instant, a
device clock that drifts placed by the local offsets, the readers' numbers,
and no reading where the counts differ or the program records no spans."""

import math

import pytest

from benchmark import harness
from benchmark import program_trace as pt

BASE = 1_790_000_000_000_000_000      # ns since the epoch
OFFSET = 5000.0                       # device µs = host µs + OFFSET
# (name, parent index, start µs, end µs) of one solve, the root first
SPANS = [("solve", -1, 0, 1000),
         ("solve.prep", 0, 0, 50),
         ("refine.round", 0, 60, 900),
         ("ecg.step", 2, 100, 300),
         ("spmm", 3, 150, 200),
         ("host.read", 2, 300, 345),
         ("ecg.step", 2, 400, 600),
         ("host.read", 6, 450, 470),
         ("host.read", 2, 600, 635),
         ("solve.gather", 0, 900, 950),
         ("host.read", 9, 900, 925),
         ("solve.host_check", 0, 950, 990)]
# host µs of the device's kernels and device-to-host copies of one solve
# (each read returns 10 µs after its copy ends)
KERNELS = [(160, 190), (250, 320), (450, 550)]
COPIES = [(330, 335), (455, 460), (620, 625), (910, 915)]
SOLVE_US = 2000                       # the second solve starts here


def solve_trace(k):
    shift = k * SOLVE_US
    spans = [{"name": n, "parent": p, "id": k,
              "start_ns": BASE + 1000 * (a + shift), "end_ns": BASE + 1000 * (b + shift)}
             for n, p, a, b in SPANS]
    return {"id": k, "spans": spans, "counters": {"host.syncs": 4}}


def ops(n_solves=2, rate=1.0):
    """The device operations, on a trace clock that runs ``rate`` times as
    fast as the host's."""
    out = []
    for k in range(n_solves):
        for name, spans in (("void kernel<float>(float*)", KERNELS),
                            ("Memcpy DtoH (Device -> Pageable)", COPIES)):
            out += [{"name": name, "ts": rate * (a + k * SOLVE_US) + OFFSET,
                     "dur": rate * (b - a)} for a, b in spans]
    return sorted(out, key=lambda e: e["ts"])


def true_busy(n_solves=2):
    """The device's busy intervals on the host clock, merged."""
    return pt.busy_on_host(ops(n_solves), [(-math.inf, OFFSET)])


def ctx(infos=None, work=None):
    infos = infos or [{"iters": 2, "trace": solve_trace(k)} for k in range(2)]
    work = ops() if work is None else work
    busy_s = 2 * 215e-6
    return {"infos": infos, "work": work, "busy_s": busy_s, "window_s": 4000e-6}


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py",
                               f"reader_{name.replace('.', '_')}")


def test_align_recovers_the_offset_inside_its_bracket():
    trs = [solve_trace(k) for k in range(2)]
    offset, width = pt.align(pt.pairs(trs, ops()))
    lo, hi = offset - width / 2, offset + width / 2
    assert lo <= OFFSET <= hi and width == pytest.approx(15)
    # the tightest pairs: copy end − read end, copy start − read start
    assert lo == pytest.approx(OFFSET + 460 - 470)
    assert hi == pytest.approx(OFFSET + 455 - 450)


def test_idle_goes_to_the_span_open_at_that_instant():
    trs = [solve_trace(k) for k in range(2)]
    by = pt.idle_by_span(trs, true_busy())
    # per solve: gaps [0,160], [190,250], [320,330], [335,450], [550,620],
    # [625,910], [915,1000] split by the innermost span
    expect = {"solve.prep": 50, "solve": 10 + 10, "refine.round": 40 + 55 + 265,
              "ecg.step": 50 + 50 + 50 + 50, "spmm": 10 + 10,
              "host.read": 10 + 10 + 20 + 10 + 10 + 10,
              "solve.gather": 25, "solve.host_check": 40}
    expect = {k: 2.0 * v for k, v in expect.items()}
    assert by == pytest.approx(expect)
    assert sum(by.values()) == pytest.approx(2 * (1000 - 215))


def test_segments_cover_the_root_with_the_innermost_span():
    us = pt.host_us([solve_trace(0)])
    segs = pt.segments(solve_trace(0)["spans"], us)
    assert segs[0] == (0, 50, "solve.prep") and segs[-1] == (990, 1000, "solve")
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert (150, 200, "spmm") in segs and (450, 470, "host.read") in segs


def test_readers_on_the_synthetic_solves(capsys):
    c = ctx()
    assert reader("host.syncs_per_iter").read(c) == pytest.approx(8 / 4)
    # steps of 200 and 200 − 20 µs (its read child): 0.19 ms an iteration
    assert reader("ecg.host_ms_per_iter").read(c) == pytest.approx(0.19)
    assert reader("refine.host_check_ms").read(c) == pytest.approx(0.04)
    named = reader("device.idle_named_pct").read(c)
    trs = [solve_trace(k) for k in range(2)]
    offsets = pt.local_offsets(pt.pairs(trs, c["work"]))
    by = pt.idle_by_span(trs, pt.busy_on_host(c["work"], offsets))
    assert named == pytest.approx(100 * (1 - by["solve"] / sum(by.values())))
    assert 85 < named < 100
    err = capsys.readouterr().err
    assert "bracket" in err and "outside the solves" in err and "host.read" in err
    assert ("leaves idle time unnamed" in err) == (named < 90)


def test_idle_named_warns_under_its_coverage(capsys, monkeypatch):
    """A coverage gate: under ``COVERAGE_PCT`` the reading is still given,
    with a warning (97.5 % named here, so a 99 % gate warns)."""
    r = reader("device.idle_named_pct")
    monkeypatch.setattr(r, "COVERAGE_PCT", 99.0)
    assert r.read(ctx()) == pytest.approx(100 * (1 - 20 / 785))
    assert "under 99.0 %: the trace leaves idle time unnamed" in capsys.readouterr().err


def test_a_drifting_trace_clock_is_placed_by_the_local_offsets():
    """A trace clock 3 % fast: no one offset fits (the bracket is empty),
    and the local offsets, off by the reads' return latency (10 µs here) and
    the drift between two copies, still give each span its idle time to
    within 25 µs over two solves, where one offset misplaces more."""
    trs = [solve_trace(k) for k in range(2)]
    work = ops(rate=1.03)
    prs = pt.pairs(trs, work)
    offset, width = pt.align(prs)
    assert width < 0
    truth = pt.idle_by_span(trs, true_busy())
    local = pt.idle_by_span(trs, pt.busy_on_host(work, pt.local_offsets(prs)))
    one = pt.idle_by_span(trs, pt.busy_on_host(work, [(-math.inf, offset)]))
    err = lambda by: max(abs(by.get(k, 0.0) - v) for k, v in truth.items())
    assert err(local) < 25 < err(one)


def test_a_count_mismatch_leaves_the_aligned_readers_unread():
    work = [e for e in ops() if e["ts"] != OFFSET + 620]     # one copy lost
    c = ctx(work=work)
    assert pt.pairs([solve_trace(k) for k in range(2)], work) is None
    assert reader("host.syncs_per_iter").read(c) is None
    assert reader("device.idle_named_pct").read(c) is None
    assert reader("ecg.host_ms_per_iter").read(c) == pytest.approx(0.19)


def test_a_program_without_spans_gives_no_reading():
    c = ctx(infos=[{"iters": 2}, {"iters": 3}])
    for name in ("host.syncs_per_iter", "ecg.host_ms_per_iter", "refine.host_check_ms",
                 "device.idle_named_pct"):
        assert reader(name).read(c) is None
