"""The cell ``ela_lorasc.n346k`` (Table 4's LORASC deployment) on the CPU at
10³, where a test run holds it:

* the cell resolves to its configuration, traffic, entry and readers;
* a sound run of its configuration is correct, and the check refuses the
  faults a one-card solve can have: an ECG run that returns its state
  unchanged, the operator product leaving out half of its rows, an answer
  altered where it is produced; the control (float32 without refinement)
  reads over the limit at this size (1.10e-5 on a CPU with this seed);
* the port's preconditioner and solve against the plain float64 reference
  ``references/lorasc_plain.py`` on the same scaled matrix and partition;
* the four readers on a synthetic trace, and nothing where their spans or
  stages are missing;
* on a card (skipped without one), a traced run at 12³ reads all four.
"""

import math

import numpy as np
import pytest
import torch

from benchmark import harness, trace
from benchmark.references import lorasc_plain

CELL = "ela_lorasc.n346k"
NEL = 10
SEED = 2 ** 31 + 977
READERS = ("lorasc.pair_refine_s", "lorasc.banded_device_pct", "lorasc.ops_per_apply",
           "lorasc.b2a_roofline")


def small_cell(nel=NEL):
    cell = harness.resolve(CELL)
    cell["traffic"]["problem"].update(nx=nel, ny=nel, nz=nel)
    return cell


def run_once(run):
    run.window(math.inf, solves=2)
    return run.check()


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py",
                               f"reader_{name.replace('.', '_')}")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    torch.set_num_threads(1)
    run = harness.Run(small_cell(), SEED, device="cpu",
                      cache_dir=tmp_path_factory.mktemp("cache"))
    run.setup()
    return run


def test_cell_resolves_to_table_4():
    cell = harness.resolve(CELL)
    cfg, traffic = cell["config"], cell["traffic"]
    assert cell["chips"] == 1 and cfg["entry"] == "stencil_lorasc"
    assert cfg["options"]["nparts"] == 16 and cfg["options"]["max_deflation"] == 150
    assert cfg["options"]["ecg"]["t"] == 1 and cfg["guarantee"]["limit"] == 1e-5
    assert traffic["problem"]["nx"] == 48 and traffic["n"] == 3 * 49 * 49 * 48
    assert {m["name"] for m in cell["per_layer"]} == set(READERS)
    entry = harness.load_module(harness.HERE / "entries" / "stencil_lorasc.py", "entry")
    assert callable(entry.build)


def test_sound_run_is_correct(built):
    compared = run_once(built)
    assert built.correct, compared
    assert built.failed == 0 and len(built.xs) == 2
    stages = built.entry.build_stages()
    assert {"fmt_convert", "plan", "factor", "lanczos", "pair_refine"} <= set(stages)
    assert built.operator["stages"]["pair_refine"] == stages["pair_refine"]


def _halve(apply):
    def broken(x):
        y = apply(x).clone()
        y[..., y.shape[-1] // 2:] = 0      # the last half of the block rows
        return y
    return broken


def test_faults_come_out_not_correct(built, monkeypatch):
    import prealps_tpu_torch.parallel.lorasc_stencil as stl

    solver = built.entry.solver
    with monkeypatch.context() as m:        # a step that returns its state unchanged
        m.setattr(stl, "ecg_run", lambda a_apply, m_apply, state, normb, opts, **kw: state)
        run_once(built)
        assert not built.correct
    with monkeypatch.context() as m:        # half of the product's rows left out
        m.setattr(solver, "_a_apply", _halve(solver._a_apply))
        run_once(built)
        assert not built.correct
    with monkeypatch.context() as m:        # an answer altered where it is produced
        solve = built.entry.solve

        def altered(b):
            x, info = solve(b)
            x = x.copy()
            k = np.random.default_rng(SEED).integers(x.size)
            x[k] += 1e-2 * np.abs(x).max()
            return x, info
        m.setattr(built.entry, "solve", altered)
        run_once(built)
        assert not built.correct
    run_once(built)
    assert built.correct


def test_control_comes_out_not_correct(tmp_path):
    torch.set_num_threads(1)
    run = harness.Run(small_cell(), SEED, device="cpu", control=True, cache_dir=tmp_path)
    run.setup()
    compared = run_once(run)
    assert not run.correct, compared
    (reading,) = compared.values()
    assert reading["value"] > reading["limit"]


def test_port_matches_the_plain_reference(built):
    """The same scaled matrix and partition. The kept pairs: as many. M⁻¹ r
    within 1e-5 relative: the port's interior and separator factors, its
    panels and its σ operands are float32 (unit roundoff 6e-8; the banded
    recursion and the triangular inverses grow it, to ~2e-7 here), so
    1e-5 leaves 50× room and still catches a pair dropped or a σ off by
    1e-5. The float32 build floors λ at 0.1·ε inside σ, so the reference
    takes that floor too. The answers: relres ≤ 1e-5 on the original
    matrix, iterations within ±2 of the reference's f64 rounds of PCG,
    each round to the program's inner tolerance (1e-3)."""
    s = built.entry.solver
    pc = s.precond
    br, nrb = pc.plan.br, pc.plan.nrb
    dof_part = torch.from_numpy(np.repeat(pc.plan.part_arr, br).astype(np.int64))
    a_s = torch.from_numpy(s.a_scaled.toarray())
    eps = built.cell["config"]["options"]["deflation_tol"]
    ref = lorasc_plain.Lorasc(a_s, dof_part, eps, lam_floor=0.1 * eps)
    assert ref.lam.numel() == pc.deflated > 0
    rng = np.random.default_rng(SEED)
    r = rng.standard_normal((3, built.n))
    lane = torch.from_numpy(r.reshape(3, nrb, br).transpose(0, 2, 1).astype(np.float32).copy())
    z_port = s._m_apply(lane).double().permute(0, 2, 1).reshape(3, -1)
    z_ref = ref.apply(torch.from_numpy(r.T)).T
    assert float(torch.linalg.norm(z_port - z_ref) / torch.linalg.norm(z_ref)) < 1e-5
    for b in r[:2]:
        x, info = s.solve(b)
        assert np.linalg.norm(b - built.a @ x) <= 1e-5 * np.linalg.norm(b)
        _, iters, rounds = lorasc_plain.refined_pcg(a_s, torch.from_numpy(s.scale_d * b),
                                                    ref.apply, 1e-5, 1e-3)
        assert abs(info["iters"] - iters) <= 2 and info["refine_rounds"] == rounds


B2A = "void stencil_pipe<float, float, 3, 1, 2, true, false, true, false>(float const*)"
B2B = "void stencil_pipe<float, float, 3, 1, 2, true, false, false, false>(float const*)"
OPERATOR = {"format": "stencil", "s": 27, "br": 3, "nrb": 1000, "block_bytes": 4,
            "panel_bytes": 4, "t": 1, "stages": {"plan": 0.5, "pair_refine": 1.25}}


def synthetic_ctx(mark_count_off=False):
    """One iteration: the product (B2a), the apply (a B2a sweep, a banded
    solve of two operations, a B2a sweep), and outside the spans the
    finish's B2b and B2a."""
    m = trace.MARKER
    names = [m, B2A, m, m, B2A, m, "gemm", "copy", m, B2A, m, B2B, B2A]
    durs = [1, 10, 1, 1, 10, 1, 30, 6, 1, 10, 1, 12, 10]
    ops, ts = [], 0.0
    for name, dur in zip(names, durs):
        ops.append({"name": name, "ts": ts, "dur": float(dur)})
        ts += dur + 1
    marks = [("b", "spmm", {"t": 1}), ("e", "spmm", None), ("b", "precond", {"t": 1}),
             ("b", "precond.banded", None), ("e", "precond.banded", None),
             ("e", "precond", None)]
    if mark_count_off:
        marks = marks[:-1]
    work, instances = trace.attribute(ops, marks)
    return {"work": work, "instances": instances, "operator": dict(OPERATOR),
            "infos": [{"iters": 1}], "busy_s": 0.0, "window_s": 1.0, "build_s": 1.0,
            "roofline": harness.load_module(harness.HERE / "roofline.py", "roofline")}


def test_readers_on_a_synthetic_trace():
    c = synthetic_ctx()
    assert reader("lorasc.pair_refine_s").read(c) == 1.25
    total = 10 + 10 + 30 + 6 + 10 + 12 + 10
    assert reader("lorasc.banded_device_pct").read(c) == pytest.approx(100 * 36 / total)
    assert reader("lorasc.ops_per_apply").read(c) == pytest.approx(4.0)
    bound = c["roofline"].stencil_bound_s(OPERATOR, 1)
    share = reader("lorasc.b2a_roofline").read(c)
    assert share == pytest.approx(100 * 4 * bound / 40e-6)
    r = reader("lorasc.b2a_roofline")
    assert r.is_b2a(B2A) and not r.is_b2a(B2B) and not r.is_b2a("void gemm<float>(int)")
    assert r.is_b2a(B2A.replace("true", "(bool)1").replace("false", "(bool)0"))


def test_readers_read_nothing_without_their_spans():
    c = synthetic_ctx(mark_count_off=True)
    assert c["instances"] is None
    for name in READERS[1:]:
        assert reader(name).read(c) is None
    c = synthetic_ctx()
    c["operator"]["stages"] = {"plan": 0.5, "host_refine": 190.0}
    assert reader("lorasc.pair_refine_s").read(c) is None
    del c["operator"]["stages"]
    assert reader("lorasc.pair_refine_s").read(c) is None
    c["work"] = [e for e in c["work"] if e["span"] != "precond.banded"]
    assert reader("lorasc.banded_device_pct").read(c) is None
    c["work"] = [e for e in c["work"] if "stencil_pipe" not in e["name"]]
    assert reader("lorasc.b2a_roofline").read(c) is None


@pytest.mark.cuda
def test_traced_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = small_cell(12)
    cell["traffic"].update(trace_solves=2)
    run = harness.Run(cell, 2 ** 31 + 5, device="cuda", cache_dir=tmp_path)
    run.setup()
    run.window(0.0, trace=True)
    run.release()
    run.check()
    assert run.correct and len(run.xs) == 2
    metrics, device, brk = run.per_layer()
    assert set(metrics) == set(READERS)
    assert 0 < metrics["lorasc.b2a_roofline"]["value"] <= 105
    assert 0 < metrics["lorasc.banded_device_pct"]["value"] < 100
    assert metrics["lorasc.ops_per_apply"]["value"] > 4
    assert 0 < device["busy_s"] <= device["window_s"]
