"""The port's utilities (prealps_tpu_torch/utils) beside the JAX package's:
the phase timers (tests/test_kernels.py::TestTimers, and the same summary
as the JAX ``Timers``), ``timed(None, ...)``, ``profile_trace`` writing a
torch.profiler trace on the CPU (and nothing for ``None``), ``scope`` as a
named range in it, and ``print_sharded``'s gate on ``config.DEBUG``;
a ``Timers`` given a device and the tournament's step timers."""

import glob
import json

import numpy as np
import pytest
import torch

from prealps_tpu.utils import timing as jt
from prealps_tpu_torch import config
from prealps_tpu_torch.utils import Timers, profile_trace, scope, timed
from prealps_tpu_torch.utils.debug import print_sharded

torch.set_num_threads(1)


class TestTimers:
    def test_timers_accumulate(self):
        t = Timers()
        with t.time("phase_a"):
            pass
        with t.time("phase_a"):
            pass
        assert t.count["phase_a"] == 2
        assert "phase_a" in t.summary()
        assert set(t.as_dict()) == {"phase_a"}

    def test_summary_is_the_jax_format(self):
        ours, theirs = Timers(), jt.Timers()
        for timers in (ours, theirs):
            timers.acc["solve"] = 1.25
            timers.count["solve"] = 3
            timers.acc["build"] = 0.5
            timers.count["build"] = 1
        assert ours.summary() == theirs.summary()

    def test_timer_records_on_exception(self):
        t = Timers()
        with pytest.raises(RuntimeError):
            with t.time("fails"):
                raise RuntimeError("boom")
        assert t.count["fails"] == 1

    def test_timers_on_a_device(self):
        """A device synchronised at each end (off the card a no-op); the
        tournament's steps timed through ``timers=``, the results those
        of the untimed call."""
        from prealps_tpu_torch.ops.tournament import tp_cur, tp_qr

        t = Timers(device="cpu")
        with t.time("x"):
            pass
        assert t.count["x"] == 1
        a = torch.from_numpy(np.random.default_rng(3).standard_normal((60, 24)))
        steps = Timers(device="cpu")
        q, r, cols = tp_qr(a, 4, timers=steps)
        # 24 columns at k 4: 6 leaves, then 3 + 1 + 1 pairings
        assert dict(steps.count) == {"pivoted_cholesky": 11, "tournament_select": 1,
                                     "tsqr": 1}
        q0, r0, cols0 = tp_qr(a, 4)
        assert torch.equal(cols, cols0) and torch.equal(q, q0) and torch.equal(r, r0)
        steps = Timers()
        out = tp_cur(a, 4, timers=steps)
        assert steps.count["tournament_select"] == 2 and steps.count["_pinv"] == 2
        assert all(torch.equal(x, y) for x, y in zip(out, tp_cur(a, 4)))


def test_timed_none_is_a_no_op():
    with timed(None, "x"):
        pass
    t = Timers()
    with timed(t, "x"):
        pass
    assert t.count["x"] == 1


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        with scope("lx_phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "lx_phase" in names


def test_profile_trace_none_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profile_trace(None):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


def test_scope_decorates():
    @scope("decorated")
    def f(x):
        return x + 1

    assert int(f(torch.zeros((), dtype=torch.int64))) == 1


def test_print_sharded_gate(capsys, monkeypatch):
    monkeypatch.setattr(config, "DEBUG", False)
    print_sharded("r", torch.tensor([[-2.0, 0.5]]))
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(config, "DEBUG", True)
    print_sharded("r", torch.tensor([[-2.0, 0.5]]))
    assert capsys.readouterr().out == (
        "[shard 0] r: shape=(1, 2) |min|=5.000e-01 |max|=2.000e+00\n")


def test_debug_reads_the_environment(monkeypatch):
    """``config.DEBUG`` is PREALPS_TPU_DEBUG read at import, as in the JAX
    package's config."""
    import importlib

    monkeypatch.setenv("PREALPS_TPU_DEBUG", "1")
    try:
        assert importlib.reload(config).DEBUG is True
        monkeypatch.setenv("PREALPS_TPU_DEBUG", "0")
        assert importlib.reload(config).DEBUG is False
    finally:
        monkeypatch.delenv("PREALPS_TPU_DEBUG")
        importlib.reload(config)
