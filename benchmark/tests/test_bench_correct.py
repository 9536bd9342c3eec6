"""The check that decides ``correct``, driven through the harness on the
CPU at sizes a test run holds (the harness's look for a card skipped).

* A sound run of each cell's configuration comes out correct.
* The control, the program's own float32 path without refinement, comes
  out not correct.
* With the timed path broken underneath, each fault that a one-card solve
  can have comes out not correct: an ECG run that returns its state
  unchanged; the operator product leaving out half of its rows; an answer
  altered where it is produced. (A one-card cell has no exchange between
  cards to leave out.)
"""

import math

import numpy as np
import pytest

from benchmark import harness

CELLS = {"ela_ecg12_bj.n811k": 10}
# the control needs a size at which float32 alone misses 1e-5: float32
# ECG stops on its recurrence residual, and the true residual's drift above
# it grows with the operator (9.4e-6 at 16^3, 1.2e-5 at 20^3 on a CPU with
# this seed)
CONTROL_NEL = {"ela_ecg12_bj.n811k": 20}
SEED = 2 ** 31 + 977


def small_cell(name, nel):
    cell = harness.resolve(name)
    cell["traffic"]["problem"].update(nx=nel, ny=nel, nz=nel)
    return cell


def run_once(run):
    run.window(math.inf, solves=2)
    return run.check()


@pytest.fixture(scope="module", params=list(CELLS))
def built(request, tmp_path_factory):
    cache = tmp_path_factory.mktemp("cache")
    run = harness.Run(small_cell(request.param, CELLS[request.param]), SEED,
                      device="cpu", cache_dir=cache)
    run.setup()
    return run


def test_sound_run_is_correct(built):
    compared = run_once(built)
    assert built.correct, compared
    assert built.failed == 0 and len(built.xs) == 2


def _halve(apply):
    def broken(x):
        y = apply(x).clone()
        y[..., y.shape[-1] // 2:] = 0      # the last half of the block rows
        return y
    return broken


def test_faults_come_out_not_correct(built, monkeypatch):
    import prealps_tpu_torch.solvers.ecg as ecg

    ops = built.entry.solver.operands
    with monkeypatch.context() as m:        # a step that returns its state unchanged
        m.setattr(ecg, "ecg_run", lambda a_apply, m_apply, state, normb, opts, **kw: state)
        run_once(built)
        assert not built.correct
    with monkeypatch.context() as m:        # half of the product's rows left out
        m.setattr(ops, "a_apply", _halve(ops.a_apply))
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


@pytest.mark.parametrize("name", list(CELLS))
def test_control_comes_out_not_correct(name, tmp_path):
    run = harness.Run(small_cell(name, CONTROL_NEL[name]), SEED, device="cpu",
                      control=True, cache_dir=tmp_path)
    run.setup()
    compared = run_once(run)
    assert not run.correct, compared
    (reading,) = compared.values()
    assert reading["value"] > reading["limit"]


def test_requests_are_fresh_right_hand_sides_drawn_from_the_seed():
    cell = small_cell("ela_ecg12_bj.n811k", 2)
    run = harness.Run(cell, 11, device="cpu")
    run.n = 5
    take = lambda seed, k: [b.copy() for b, _ in zip(run.requests(seed), range(k))]
    a = take(11, 4)
    assert all(np.array_equal(x, y) for x, y in zip(a, take(11, 4)))
    assert len({x.tobytes() for x in a + take(12, 4)}) == 8
    big = take(2 ** 31 + 2 ** 30, 1)[0]
    assert big.shape == (5,) and np.isfinite(big).all()
