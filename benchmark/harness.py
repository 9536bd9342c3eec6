"""Run one cell of the benchmark once and print its result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. Everything particular to them lives in files found by name:

* the configuration's file (``configs``' ``file``): its ``entry``, the
  adapter ``entries/<entry>.py`` that builds the program's solver from the
  configuration's ``options``; its ``guarantee`` (the reference check
  ``references/<check>.py`` and the limit on its number); its ``control``,
  the options of the program's own lower-precision path;
* the traffic's file ``traffic/<traffic>.json``: the ``problem`` (a
  generator of ``problems/`` and its parameters) and its ``requests``, whose
  ``kind`` names the request generator ``requests/<kind>.py`` that reads
  the rest of them;
* each per-layer metric's reader ``layer_metrics/<name>.py``.

A run: set-up (imports, the kernel library, the inputs, ``build()`` and one
warm solve on a right-hand side of its own), then a closed loop with one
client over a fixed operator, each request the next right-hand side the
generator draws from the seed, until ``seconds`` have passed; then, with
the program's state freed, the reference checks every answer the window
produced. With ``trace`` the window is recorded by torch.profiler (the
device's activity only) and cut after the traffic's ``trace_solves``
solves, and the per-layer metrics are read from it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "prealps_tpu")
GIB = float(2 ** 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> dict:
    """The cell named ``workload``: its configuration, traffic and metrics."""
    manifest = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    cfg = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return {"name": workload, "chips": int(cell["chips"]),
            "config": _read(root / cfg["file"]),
            "traffic": _read(HERE / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": [m for m in manifest["end_to_end"] if _applies(m, workload)],
            "per_layer": [m for m in manifest["per_layer"] if _applies(m, workload)]}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """One run of one cell: ``setup``, ``window``, ``check``."""

    def __init__(self, cell: dict, seed: int, device: str = "cuda",
                 control: bool = False, cache_dir: Path | None = None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.control = control
        self.cache_dir = cache_dir
        self.entry = None
        self.lines: dict = {}

    def _sync(self):
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def setup(self) -> None:
        import torch

        from benchmark import problems

        cfg = self.cell["config"]
        t0 = time.perf_counter()
        kw = {} if self.cache_dir is None else {"cache_dir": self.cache_dir}
        self.a, self.meta = problems.load(self.cell["traffic"]["problem"], **kw)
        self.lines["inputs_s"] = time.perf_counter() - t0
        self.n = self.a.shape[0]
        options = dict(cfg["options"])
        if self.control:
            options.update(cfg["control"]["options"])
        adapter = load_module(HERE / "entries" / f"{cfg['entry']}.py",
                              f"bench_entry_{cfg['entry']}")
        if self.device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        self.entry = adapter.build(self.a.copy(), self.meta, options, self.device)
        self._sync()
        self.build_s = time.perf_counter() - t0
        self.operator = self.entry.operator()
        b = np.random.default_rng([self.seed, 0]).standard_normal(self.n)
        t0 = time.perf_counter()
        _, info = self.entry.solve(b)
        self._sync()
        self.lines["warm_solve_s"] = time.perf_counter() - t0
        self.lines["warm_iters"] = int(info["iters"])

    def requests(self, seed: int):
        """The window's right-hand sides, in order, as the traffic's
        request generator draws them from ``seed``."""
        spec = self.cell["traffic"]["requests"]
        gen = load_module(HERE / "requests" / f"{spec['kind']}.py",
                          f"bench_requests_{spec['kind']}")
        return gen.make(spec, self.n, seed)

    def window(self, seconds: float, trace: bool = False, seed: int | None = None,
               solves: int | None = None):
        """Back-to-back solves until ``seconds`` have passed or ``solves``
        are done (with ``trace``: the traffic's ``trace_solves`` solves,
        whatever the time).
        The window ends when the last solve's x is back on the host. Keeps
        every x for the check."""
        seed = self.seed if seed is None else int(seed)
        limit = int(self.cell["traffic"]["trace_solves"]) if trace else (solves or math.inf)
        reqs = self.requests(seed)
        if trace:
            reqs = iter([next(reqs) for _ in range(limit)])
        self.xs, self.infos, self.times, self.failed = [], [], [], 0
        self.spans = prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from benchmark.trace import Spans

            self.spans = Spans()
            self.entry.instrument(self.spans)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        self._sync()
        t0 = s1 = time.perf_counter()
        while len(self.xs) < limit:
            b = next(reqs)
            s0 = time.perf_counter()
            try:
                x, info = self.entry.solve(b)
            except Exception as exc:       # a failed request ends the window
                log(f"solve {len(self.xs)} raised {type(exc).__name__}: {exc}")
                self.failed += 1
                break
            self._sync()
            s1 = time.perf_counter()
            self.times.append(s1 - s0)
            self.xs.append(x)
            self.infos.append(info)
            if not trace and s1 - t0 >= seconds:
                break
        self.window_s = s1 - t0
        self.trace_ops = None
        if prof is not None:
            from benchmark.trace import export_events

            prof.__exit__(None, None, None)
            self.trace_ops = export_events(prof)
        self.window_seed = seed

    def release(self) -> None:
        """Read the device's peak, then free the program's state."""
        self.peak_bytes = 0
        self.entry = None
        if self.device != "cpu":
            import torch

            self.peak_bytes = int(torch.cuda.max_memory_allocated())
            gc.collect()
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The reference's verdict on every answer of the window: each
        number compared, with its limit."""
        g = self.cell["config"]["guarantee"]
        ref = load_module(HERE / "references" / f"{g['check']}.py",
                          f"bench_ref_{g['check']}")
        d = ref.equilibration(self.a)
        worst: dict = {}
        for x, b in zip(self.xs, self.requests(self.window_seed)):
            for k, v in ref.residuals(self.a, d, b, x).items():
                worst[k] = max(worst.get(k, 0.0), v)
        self.readings = worst
        value = worst.get(g["number"], math.inf)
        compared = {f"{g['number']}_max": {"value": value, "limit": g["limit"]}}
        self.correct = (bool(self.xs) and self.failed == 0
                        and all(c["value"] <= c["limit"] for c in compared.values()))
        return compared

    def end_to_end(self, setup_s: float) -> dict:
        values = {"tts_s": self.window_s / len(self.xs) if self.xs else math.inf,
                  "peak_mem_gib": self.peak_bytes / GIB,
                  "setup_s": setup_s}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.cell["end_to_end"]}

    def per_layer(self) -> tuple:
        """The per-layer metrics the readers find in the traced window,
        with the trace's device fields and breakdown."""
        from benchmark import roofline
        from benchmark.trace import attribute, breakdown, union_s

        ops = self.trace_ops or []
        work, instances = attribute(ops, self.spans.marks if self.spans else [])
        busy_s = union_s(work)
        ctx = {"build_s": self.build_s, "infos": self.infos, "work": work,
               "instances": instances, "operator": self.operator,
               "busy_s": busy_s, "window_s": self.window_s, "roofline": roofline}
        n_markers = len(ops) - len(work)
        log(f"trace: {len(ops)} device operations, {n_markers} span markers for "
            f"{len(self.spans.marks) if self.spans else 0} marks, busy {busy_s:.4f} s "
            f"of {self.window_s:.4f} s")
        if instances is None:
            log("the trace's markers do not match the spans: span metrics left out")
        metrics = {}
        for m in self.cell["per_layer"]:
            reader = load_module(HERE / "layer_metrics" / f"{m['name']}.py",
                                 f"bench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        return metrics, {"busy_s": busy_s, "window_s": self.window_s}, breakdown(work)


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        control: bool = False) -> int:
    """The benchmark's command: one run of one cell on the card."""
    import torch

    cell = resolve(workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{workload} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 3
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    r = Run(cell, seed, device="cuda", control=control)
    r.setup()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: inputs {r.lines['inputs_s']:.3f} s, build "
        f"{r.build_s:.3f} s (stages {json.dumps(r.entry.build_stages())}), warm solve "
        f"{r.lines['warm_solve_s']:.3f} s ({r.lines['warm_iters']} iterations)")
    r.window(seconds, trace=trace)
    r.release()
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 4
    t0 = time.perf_counter()
    compared = r.check()
    log(f"check of {len(r.xs)} answers {time.perf_counter() - t0:.3f} s")
    iters = [int(i["iters"]) for i in r.infos]
    rounds = [i.get("refine_rounds") for i in r.infos]
    log(f"window {r.window_s:.3f} s, {len(r.times)} solves: median "
        f"{statistics.median(r.times) if r.times else math.nan:.4f} s, slowest "
        f"{max(r.times, default=math.nan):.4f} s; iterations {sorted(set(iters))}, "
        f"rounds {sorted(set(map(str, rounds)))}; reference readings {r.readings}")
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": r.peak_bytes}
    result = {"correct": r.correct, "attempted": len(r.times) + r.failed,
              "failed": r.failed}
    if trace:
        metrics, dev, brk = r.per_layer()
        device.update(dev)
        result.update(metrics=metrics, device=device, breakdown=brk)
    else:
        result.update(metrics=r.end_to_end(setup_s), device=device)
    result["compared"] = compared
    for name, c in compared.items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
