"""Readings for the limits of ``correct``: one build of a cell on the card,
then a window and the reference's check for each of many seeds, in one
process (a build takes tens of seconds).

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 30 [--control]

Prints one JSON line per seed: its readings (every number the reference
computes, the largest over the window's answers), the solves, iterations
and rounds. ``--control`` builds the configuration's control in the
program's place. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA card")
    cell = harness.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    run = harness.Run(cell, seeds[0], device="cuda", control=args.control)
    t0 = time.perf_counter()
    run.setup()
    harness.log(f"card: {harness.card_line()}; set-up {time.perf_counter() - t0:.1f} s")
    for seed in seeds:
        run.window(args.seconds, seed=seed)
        compared = run.check()
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "seed": seed, "readings": run.readings, "compared": compared,
                          "correct": run.correct, "solves": len(run.times),
                          "tts_s": run.window_s / max(1, len(run.xs)),
                          "iters": sorted({int(i["iters"]) for i in run.infos}),
                          "rounds": sorted({str(i.get("refine_rounds")) for i in run.infos})}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
