"""Cross-check of the trace's kernel times against CUDA events: the
operator product of a cell at its panel width, timed both ways on the card.

    python3 benchmark/tools/crosscheck.py --workload <cell> [--t 12] [--reps 50]

(a) CUDA events around ``reps`` back-to-back products enqueued behind a
spin kernel that outlasts their enqueueing (the arithmetic of the
program's ``timing.py::device_ms``, copied here), so the events time the
device alone; (b) the same products under torch.profiler inside the
benchmark's ``spmm`` spans, read as the traced runs read them. Prints one
JSON line: the device ms of a product both ways, the stencil kernel's ms a
launch in the trace, its bound and the two roofline shares.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness, roofline, trace  # noqa: E402


def device_ms(fn, reps: int, batches: int = 3) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * min(1.0, 2.0 * host_s + 1e-3))
    times = []
    for _ in range(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--t", type=int, default=12)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = harness.Run(harness.resolve(args.workload), 1, device="cuda")
    run.setup()
    entry, op = run.entry, run.operator
    x = torch.randn(args.t, op["br"], op["nrb"], device="cuda",
                    dtype=torch.float32 if op["panel_bytes"] == 4 else torch.float64)
    events_ms = device_ms(lambda: entry.product(x), args.reps)
    spans = trace.Spans()
    entry.instrument(spans)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            entry.product(x)
        torch.cuda.synchronize()
    work, instances = trace.attribute(trace.export_events(prof), spans.marks)
    inside = [e for e in work if e["span"] == "spmm"]
    kernel = [e["dur"] for e in inside if "stencil" in e["name"].lower()]
    bound_ms = 1e3 * roofline.stencil_bound_s(op, args.t)
    per_call_ms = 1e-3 * sum(e["dur"] for e in inside) / args.reps
    kernel_ms = 1e-3 * statistics.median(kernel) if kernel else None
    print(json.dumps({
        "workload": args.workload, "card": harness.card_line(), "t": args.t,
        "operator": op, "matched": instances is not None,
        "events_ms_per_product": events_ms, "trace_ms_per_product": per_call_ms,
        "trace_stencil_kernel_ms": kernel_ms, "stencil_launches": len(kernel),
        "bound_ms": bound_ms,
        "roofline_pct_trace": 100 * bound_ms / kernel_ms if kernel_ms else None,
        "roofline_pct_events_whole_product": 100 * bound_ms / events_ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
