"""``device.idle_named_pct``: the share of the card's idle time inside the
program's ``solve`` spans that falls inside a program span below the root:
at each idle instant the innermost span open (program spans,
``info["trace"]``, placed on the device trace's clock by
``program_trace.local_offsets``). Logs to standard error the one-offset
bracket of the window and how far the local offsets move (the trace
clock's drift against the host's), the idle ms a solve by innermost span
(the ten largest; ``solve`` where no span below the root is open) and the
idle ms a solve outside every solve (the client's own time between
requests).

It gates the instrumentation's coverage and does not rank speed: read it
against 90 %. A change that removes idle time under a named span (a CUDA
graph of ``ecg.step``, say) lowers it while ``tts_s`` improves; below 90 %
the reader warns that the trace leaves idle time unnamed."""

import sys

from benchmark import program_trace as pt

COVERAGE_PCT = 90.0


def read(ctx):
    trs = pt.traces(ctx["infos"])
    if trs is None:
        return None
    prs = pt.pairs(trs, ctx["work"])
    if prs is None:
        print(f"program spans: {pt.syncs(trs)} counted reads, "
              f"{len(pt.copies(ctx['work']))} device-to-host copies: not aligned",
              file=sys.stderr, flush=True)
        return None
    offset, width = pt.align(prs)
    offsets = pt.local_offsets(prs)
    drift = max(o for _, o in offsets) - min(o for _, o in offsets)
    by_span = pt.idle_by_span(trs, pt.busy_on_host(ctx["work"], offsets))
    inside = sum(by_span.values())
    n = len(trs)
    outside_ms = (ctx["window_s"] - ctx["busy_s"]) * 1e3 - inside / 1e3
    top = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    print(f"program spans: {len(prs)} reads = device-to-host copies; one offset "
          f"{offset:.3f} us, bracket {width:.3f} us; local offsets move {drift:.3f} us; "
          f"idle a solve {inside / 1e3 / n:.3f} ms inside, {outside_ms / n:.3f} ms "
          f"outside the solves; by innermost span (ms a solve): "
          + ", ".join(f"{k} {v / 1e3 / n:.3f}" for k, v in top),
          file=sys.stderr, flush=True)
    if not inside:
        return None
    named = 100.0 * (inside - by_span.get(pt.ROOT, 0.0)) / inside
    if named < COVERAGE_PCT:
        print(f"program spans: {named:.2f} % of the idle time inside the solves is named, "
              f"under {COVERAGE_PCT} %: the trace leaves idle time unnamed",
              file=sys.stderr, flush=True)
    return named
