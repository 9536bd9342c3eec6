"""The port's ECG variants against the f64 numpy oracle (tests/ecg_oracle.py).

The cases of tests/test_parity.py (the reference's deterministic configs:
LFAT5 with e = 2, elasticity3d with e = 4), run through the port's
``ecg_solve`` on row-major ("nt") panels with the same contiguous split and
an exact f64 block-Jacobi apply (the port's ``BlockJacobi`` in Cholesky mode
on the oracle's ``nsplit`` blocks, without reordering). Held to the same
bar: iteration counts within ±1 (odir_fused exactly one more than odir,
since it records the entering residual), residual histories to 1e-6
relative over the first half (1e-3 over three quarters), and the adaptive
(ADAPT_BS) schedule. LFAT5 cases skip where the matrix file is absent.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from prealps_tpu_torch.core.partition import nsplit
from prealps_tpu_torch.precond.block_jacobi import build_block_jacobi
from prealps_tpu_torch.solvers.ecg import ECGOptions, ecg_solve
from tests.ecg_oracle import block_jacobi_oracle, ecg_oracle

torch.set_num_threads(1)


def _port_ecg(a, b, t, tol, variant, nblocks=None, maxiter=2000, adaptive=False):
    a = sp.csr_matrix(a).astype(np.float64)
    a_d = torch.from_numpy(a.toarray())
    m_apply = None
    if nblocks is not None:
        m_apply = build_block_jacobi(a, nblocks=nblocks, rcm=False,
                                     dtype=np.float64).apply
    opts = ECGOptions(t=t, tol=tol, maxiter=maxiter, variant=variant,
                      adaptive=adaptive, layout="nt")
    return ecg_solve(lambda p: a_d @ p, m_apply, torch.from_numpy(b), opts)


def _history(res):
    h = res.history.numpy()
    return h[h >= 0]


def _assert_history_tracks(h_port, h_ref):
    """Rounding-tight early, loose only in the rounding-amplified tail."""
    k = min(len(h_port), len(h_ref))
    rel = np.abs(h_port[:k] - h_ref[:k]) / h_ref[:k]
    assert np.all(rel[: k // 2] <= 1e-6), float(rel[: k // 2].max())
    assert np.all(rel[: 3 * k // 4] <= 1e-3), float(rel[: 3 * k // 4].max())


CONFIGS = [("odir", 2, "odir"), ("omin", 2, "omin")]


class TestLFAT5Parity:
    """LFAT5 (14×14 SPD, the reference's bundled smoke matrix), e = 2."""

    @pytest.mark.parametrize("name,t,variant", CONFIGS)
    def test_iteration_count_exact(self, lfat5, name, t, variant):
        b = np.random.default_rng(0).standard_normal(lfat5.shape[0])
        m_or = block_jacobi_oracle(lfat5, nsplit(lfat5.shape[0], 2))
        oracle = ecg_oracle(lfat5, b, t=t, tol=1e-5, variant=variant, m_apply=m_or)
        res = _port_ecg(lfat5, b, t, 1e-5, variant, nblocks=2)
        assert oracle["res"] <= 1e-5 * oracle["normb"]
        assert not res.breakdown
        assert abs(res.iters - oracle["iters"]) <= 1, (res.iters, oracle["iters"])
        _assert_history_tracks(_history(res), oracle["history"])

    def test_fused_history_is_one_shifted_odir(self, lfat5):
        b = np.random.default_rng(0).standard_normal(lfat5.shape[0])
        m_or = block_jacobi_oracle(lfat5, nsplit(lfat5.shape[0], 2))
        oracle = ecg_oracle(lfat5, b, t=2, tol=1e-5, variant="odir", m_apply=m_or)
        res = _port_ecg(lfat5, b, 2, 1e-5, "odir_fused", nblocks=2)
        assert res.iters - oracle["iters"] in (0, 1)
        _assert_history_tracks(_history(res)[1:], oracle["history"])

    def test_adaptive_matches_oracle(self, lfat5):
        b = np.random.default_rng(0).standard_normal(lfat5.shape[0])
        m_or = block_jacobi_oracle(lfat5, nsplit(lfat5.shape[0], 2))
        oracle = ecg_oracle(lfat5, b, t=2, tol=1e-5, variant="odir",
                            m_apply=m_or, adaptive=True)
        res = _port_ecg(lfat5, b, 2, 1e-5, "odir", nblocks=2, adaptive=True)
        assert float(res.res) <= 1e-5 * oracle["normb"]
        assert abs(res.iters - oracle["iters"]) <= 1
        assert res.bs == int(oracle["bs_history"][-1])
        _assert_history_tracks(_history(res), oracle["history"])

    def test_solution_matches_direct(self, lfat5):
        b = np.random.default_rng(0).standard_normal(lfat5.shape[0])
        res = _port_ecg(lfat5, b, 2, 1e-9, "odir", nblocks=2, maxiter=200)
        x_ref = spla.spsolve(sp.csc_matrix(lfat5), b)
        assert np.linalg.norm(res.x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-6


class TestElasticityParity:
    """elasticity3d(6,5,5), e = 4 over 8 block-Jacobi blocks."""

    @pytest.mark.parametrize("variant", ["odir", "omin"])
    def test_iteration_count_exact_e4(self, ela_small, variant):
        b = np.random.default_rng(11).standard_normal(ela_small.shape[0])
        m_or = block_jacobi_oracle(ela_small, nsplit(ela_small.shape[0], 8))
        oracle = ecg_oracle(ela_small, b, t=4, tol=1e-5, variant=variant,
                            m_apply=m_or, maxiter=2000)
        res = _port_ecg(ela_small, b, 4, 1e-5, variant, nblocks=8)
        assert oracle["res"] <= 1e-5 * oracle["normb"]
        assert not res.breakdown
        assert abs(res.iters - oracle["iters"]) <= 1, (res.iters, oracle["iters"])
        _assert_history_tracks(_history(res), oracle["history"])

    def test_fused_one_shifted_odir_e4(self, ela_small):
        b = np.random.default_rng(11).standard_normal(ela_small.shape[0])
        m_or = block_jacobi_oracle(ela_small, nsplit(ela_small.shape[0], 8))
        oracle = ecg_oracle(ela_small, b, t=4, tol=1e-5, variant="odir",
                            m_apply=m_or, maxiter=2000)
        res = _port_ecg(ela_small, b, 4, 1e-5, "odir_fused", nblocks=8)
        assert res.iters - oracle["iters"] in (0, 1)
        _assert_history_tracks(_history(res)[1:], oracle["history"])

    def test_adaptive_schedule_matches_oracle_e4(self, ela_small):
        """The reference's SVD test mis-triggers here and the block collapses
        (~iteration 50); parity means the same capped trajectory and final
        block size."""
        b = np.random.default_rng(11).standard_normal(ela_small.shape[0])
        m_or = block_jacobi_oracle(ela_small, nsplit(ela_small.shape[0], 8))
        cap = 120
        oracle = ecg_oracle(ela_small, b, t=4, tol=1e-5, variant="odir",
                            m_apply=m_or, maxiter=cap, adaptive=True)
        res = _port_ecg(ela_small, b, 4, 1e-5, "odir", nblocks=8, maxiter=cap,
                        adaptive=True)
        assert res.iters == oracle["iters"] == cap
        assert res.bs == int(oracle["bs_history"][-1])
        _assert_history_tracks(_history(res)[:40], oracle["history"][:40])

    def test_enlarging_cuts_iterations(self, ela_small):
        b = np.random.default_rng(11).standard_normal(ela_small.shape[0])
        k1 = _port_ecg(ela_small, b, 1, 1e-5, "odir", nblocks=8).iters
        k4 = _port_ecg(ela_small, b, 4, 1e-5, "odir", nblocks=8).iters
        assert k4 < k1
