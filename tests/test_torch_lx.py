"""The port's communication-avoiding kernel tier (ops/tsqr.py,
ops/tournament.py, ops/spmsv.py, ops/cholqr.py) against the JAX package's,
on the JAX tests' own inputs (tests/test_kernels.py: TestTSQR,
TestTournament, TestSpMSV, TestCholQR, TestSpMSVPacked; seed 42,
``poisson_small``, ``ela_small``), in f64:

* values within 1e-10 of JAX's (and the JAX tests' own bars);
* tournament selections equal to JAX's as index sets (each selection is
  also checked as an ordered list: a differing order would have to be a
  near-tie, and none occurs on these inputs);
* support structures and the dense switch bitwise, the numpy helpers
  bitwise JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prealps_tpu.core.partition import nsplit
from prealps_tpu.ops import cholqr as jc
from prealps_tpu.ops import spmsv as js
from prealps_tpu.ops import tournament as jt
from prealps_tpu.ops import tsqr as jq
from prealps_tpu.ops.formats import csr_to_block_ell as j_block_ell
from prealps_tpu.ops.formats import csr_to_ell as j_ell
from prealps_tpu.ops.spmm import ell_spmm as j_ell_spmm
from prealps_tpu_torch.ops import blockops as tb
from prealps_tpu_torch.ops import cholqr as tc
from prealps_tpu_torch.ops import spmsv as ts
from prealps_tpu_torch.ops import tournament as tt
from prealps_tpu_torch.ops import tsqr as tq
from prealps_tpu_torch.ops.formats import csr_to_block_ell as t_block_ell
from prealps_tpu_torch.ops.formats import csr_to_ell as t_ell
from prealps_tpu_torch.ops.spmm import ell_spmm as t_ell_spmm

torch.set_num_threads(1)

TOL = 1e-10


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))


def _close(port, ref, tol=TOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def _same_selection(port, ref):
    """Equal index sets, and in the same order."""
    port, ref = np.asarray(port).tolist(), np.asarray(ref).tolist()
    assert set(port) == set(ref), (port, ref)
    assert port == ref, (port, ref)


class TestTSQR:
    def test_r_matches_numpy_and_jax(self, rng):
        x = rng.standard_normal((500, 8))
        r = tq.tsqr_r(_t(x)).numpy()
        r_np = np.linalg.qr(x, mode="r")
        np.testing.assert_allclose(r, r_np * np.sign(np.diag(r_np))[:, None],
                                   rtol=1e-8, atol=1e-10)
        _close(r, jq.tsqr_r(jnp.asarray(x)))

    @pytest.mark.parametrize("m,t,nblocks", [(97, 5, 8), (30, 4, 3)])
    def test_r_tree_shapes(self, rng, m, t, nblocks):
        """Padded row blocks and an odd count at some tree level."""
        x = rng.standard_normal((m, t))
        _close(tq.tsqr_r(_t(x), nblocks), jq.tsqr_r(jnp.asarray(x), nblocks))

    def test_sign_of_zero_diagonal_is_one(self):
        """A zero column leaves R's diagonal 0 there: sign(0) → 1 keeps the
        row as it is, as in the JAX package."""
        x = np.zeros((40, 3))
        x[:, 0] = 1.0
        x[:, 2] = np.arange(40.0)
        _close(tq.tsqr_r(_t(x), 4), jq.tsqr_r(jnp.asarray(x), 4))

    def test_q_orthonormal(self, rng):
        x = rng.standard_normal((500, 8))
        q, r = tq.tsqr(_t(x))
        q = q.numpy()
        np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-10)
        np.testing.assert_allclose(q @ r.numpy(), x, rtol=1e-8, atol=1e-10)
        qj, rj = jq.tsqr(jnp.asarray(x))
        _close(q, qj)
        _close(r, rj)


class TestCholQR:
    def test_a_cholqr(self, rng, ela_small):
        a = ela_small.toarray()
        p = rng.standard_normal((a.shape[0], 6))
        ap = a @ p
        pt, apt, u = tc.a_cholqr(_t(p), _t(ap))
        np.testing.assert_allclose(pt.numpy().T @ a @ pt.numpy(), np.eye(6), atol=1e-8)
        np.testing.assert_allclose(a @ pt.numpy(), apt.numpy(), rtol=1e-9, atol=1e-9)
        for port, ref in zip((pt, apt, u), jc.a_cholqr(jnp.asarray(p), jnp.asarray(ap))):
            _close(port, ref)

    def test_a_cholqr_tbn(self, rng, ela_small):
        """Lane-major panels: the transposes of the nt result."""
        a = ela_small.toarray()
        p = rng.standard_normal((a.shape[0], 6))
        ap = a @ p
        pt, apt, u = tc.a_cholqr(_t(p.T), _t(ap.T), layout="tbn")
        pj, apj, uj = jc.a_cholqr(jnp.asarray(p.T), jnp.asarray(ap.T), layout="tbn")
        _close(pt, pj)
        _close(apt, apj)
        _close(u, uj)
        _close(pt.T, tc.a_cholqr(_t(p), _t(ap))[0])

    def test_cholqr2_orthonormal(self, rng):
        p = rng.standard_normal((400, 8))
        q, r = tc.cholqr2(_t(p))
        np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(8), atol=1e-12)
        np.testing.assert_allclose(q.numpy() @ r.numpy(), p, rtol=1e-10, atol=1e-10)
        qj, rj = jc.cholqr2(jnp.asarray(p))
        _close(q, qj)
        _close(r, rj)

    def test_a_normalize(self, rng, ela_small):
        a = ela_small.toarray()
        p = rng.standard_normal((a.shape[0], 4))
        pn, apn = tc.a_normalize(_t(p), _t(a @ p))
        np.testing.assert_allclose(np.diag(pn.numpy().T @ a @ pn.numpy()), 1.0,
                                   rtol=1e-10)
        pj, apj = jc.a_normalize(jnp.asarray(p), jnp.asarray(a @ p))
        _close(pn, pj)
        _close(apn, apj)


class TestTournament:
    def test_select_recovers_important_columns(self, rng):
        m, n, k = 200, 40, 5
        basis = rng.standard_normal((m, k))
        a = rng.standard_normal((m, n)) * 0.01
        strong = rng.choice(n, size=k, replace=False)
        a[:, strong] += basis * 10
        sel = tt.tournament_select(_t(a), k).numpy()
        assert set(sel.tolist()) == set(strong.tolist())
        _same_selection(sel, jt.tournament_select(jnp.asarray(a), k))

    def test_tp_qr_approximation(self, rng):
        m, n, k = 300, 60, 10
        a = (rng.standard_normal((m, k)) @ rng.standard_normal((k, n))
             + 1e-6 * rng.standard_normal((m, n)))
        q, r, cols = tt.tp_qr(_t(a), k)
        err = np.linalg.norm(q.numpy() @ r.numpy() - a) / np.linalg.norm(a)
        assert err < 1e-4
        qj, rj, cj = jt.tp_qr(jnp.asarray(a), k)
        _same_selection(cols, cj)
        _close(q, qj)
        _close(r, rj)

    def test_tp_cur_approximation(self, rng):
        m, n, k = 200, 80, 8
        a = rng.standard_normal((m, k)) @ rng.standard_normal((k, n))
        c, u, r, cols, rows = tt.tp_cur(_t(a), k)
        recon = c.numpy() @ u.numpy() @ r.numpy()
        assert np.linalg.norm(recon - a) / np.linalg.norm(a) < 1e-6
        cj, uj, rj, colsj, rowsj = jt.tp_cur(jnp.asarray(a), k)
        _same_selection(cols, colsj)
        _same_selection(rows, rowsj)
        _close(c, cj)
        _close(r, rj)
        # U through two pseudo-inverses of exact-rank-k blocks: its entries
        # reach ~1e2, so relative 1e-10 of its largest
        uj = np.asarray(uj)
        np.testing.assert_allclose(u.numpy(), uj, rtol=0,
                                   atol=TOL * np.abs(uj).max())

    def test_singular_value_approximation_random(self, rng):
        m, n, k = 400, 100, 12
        a = rng.standard_normal((m, n))
        sel = tt.tournament_select(_t(a), k).numpy()
        sv_true = np.linalg.svd(a, compute_uv=False)[:k]
        sv_sel = np.linalg.svd(a[:, sel], compute_uv=False)
        assert np.all(sv_sel <= sv_true * (1 + 1e-8))
        assert np.all(sv_sel >= 0.3 * sv_true), (sv_sel / sv_true)
        _same_selection(sel, jt.tournament_select(jnp.asarray(a), k))

    def test_singular_value_approximation_graded(self, rng):
        m, n, k = 300, 64, 8
        u, _ = np.linalg.qr(rng.standard_normal((m, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        sv = 2.0 ** -np.arange(n)
        a = (u * sv) @ v.T
        sel = tt.tournament_select(_t(a), k).numpy()
        ratio = np.linalg.svd(a[:, sel], compute_uv=False) / sv[:k]
        assert np.all(ratio > 0.25), ratio
        assert np.all(ratio <= 1 + 1e-8)
        _same_selection(sel, jt.tournament_select(jnp.asarray(a), k))

    def test_gram_f64_survives_illconditioned_panel(self, rng):
        m, n, k = 256, 32, 4
        u, _ = np.linalg.qr(rng.standard_normal((m, n)))
        a = u * np.logspace(0, -6, n)
        sel = tt.tournament_select(_t(a), k, nblocks=1).numpy()
        assert set(sel.tolist()) == set(range(k)), sel
        _same_selection(sel, jt.tournament_select(jnp.asarray(a), k, nblocks=1))

    def test_f32_panel_pivots_in_f64(self, rng):
        """An f32 panel: the port's Gram and pivoting run in f64 whatever
        the panel's type (JAX only with x64 on), so the f32 panel picks the
        f64 panel's columns on this cond-1e6 input."""
        m, n, k = 256, 32, 4
        u, _ = np.linalg.qr(rng.standard_normal((m, n)))
        a = u * np.logspace(0, -6, n)
        sel32 = tt.tournament_select(torch.from_numpy(a.astype(np.float32)), k,
                                     nblocks=1)
        assert set(sel32.tolist()) == set(range(k))

    def test_qrcp_select_truncated_pivots(self, rng):
        """qrcp_select stops the pivoted Cholesky after k steps: the first k
        pivots of the full loop (the port's and JAX's)."""
        from prealps_tpu.ops.blockops import pivoted_cholesky as j_pc

        b = rng.standard_normal((60, 40))
        g = b.T @ b
        _, piv_full, _ = tb.pivoted_cholesky(_t(g), -1.0)
        _, piv_j, _ = j_pc(jnp.asarray(g), jnp.asarray(-1.0))
        for k in (1, 7, 40):
            _, piv_k, _ = tb.pivoted_cholesky(_t(g), -1.0, steps=k)
            assert piv_k[:k].tolist() == piv_full[:k].tolist()
        assert piv_full.tolist() == np.asarray(piv_j).tolist()
        _same_selection(tt.qrcp_select(_t(b), 7), jt.qrcp_select(jnp.asarray(b), 7))


class TestSpMSV:
    def test_support_propagation(self, poisson_small):
        offsets = nsplit(poisson_small.shape[0], 16)
        g = ts.block_support_graph(poisson_small, offsets)
        gj = js.block_support_graph(poisson_small, offsets)
        assert g.dtype == gj.dtype and (g != gj).nnz == 0
        np.testing.assert_array_equal(g.toarray(), gj.toarray())
        s0 = np.zeros(16, dtype=bool)
        s0[3] = True
        for steps in (1, 4):
            s = ts.propagate_support(g, s0, steps=steps)
            sj = js.propagate_support(gj, s0, steps=steps)
            assert s.dtype == sj.dtype
            np.testing.assert_array_equal(s, sj)
        s1 = ts.propagate_support(g, s0)
        assert s1[3] and s1.sum() > 1
        assert ts.propagate_support(g, s0, steps=4).sum() >= s1.sum()
        ids = np.array([3, 9, -1, -1])
        np.testing.assert_array_equal(ts.predict_c_support(g, ids, 16),
                                      js.predict_c_support(gj, ids, 16))

    def test_masked_product_matches(self, poisson_small, rng):
        a = poisson_small
        offsets = nsplit(a.shape[0], 16)
        g = ts.block_support_graph(a, offsets)
        b = rng.standard_normal((a.shape[0], 3))
        mask = np.zeros(16, dtype=bool)
        mask[5] = True
        ae = t_ell(a)
        c, c_struct, is_dense = ts.spmsv(lambda x: t_ell_spmm(ae, x), _t(b), mask,
                                         g, offsets)
        b_masked = b.copy()
        for i in range(16):
            if not mask[i]:
                b_masked[offsets[i]: offsets[i + 1]] = 0
        np.testing.assert_allclose(c.numpy(), a @ b_masked, rtol=1e-10, atol=1e-12)
        aj = j_ell(a)
        cj, c_struct_j, is_dense_j = js.spmsv(
            lambda x: j_ell_spmm(aj, x), jnp.asarray(b), mask,
            js.block_support_graph(a, offsets), offsets)
        _close(c, cj)
        assert c_struct.dtype == c_struct_j.dtype
        np.testing.assert_array_equal(c_struct, c_struct_j)
        assert is_dense is is_dense_j is False

    def test_2d_struct_and_dense_switch(self, poisson_small, rng):
        a = poisson_small
        n = a.shape[0]
        offsets = nsplit(n, 16)
        col_off = nsplit(4, 2)
        g = ts.block_support_graph(a, offsets)
        b = rng.standard_normal((n, 4))
        struct = np.zeros((16, 2), dtype=bool)
        struct[2, 0] = True
        struct[9, 1] = True
        ae, aj = t_ell(a), j_ell(a)
        t_apply = lambda x: t_ell_spmm(ae, x)
        j_apply = lambda x: j_ell_spmm(aj, x)
        c, c_struct, _ = ts.spmsv(t_apply, _t(b), struct, g, offsets,
                                  col_offsets=col_off)
        cj, c_struct_j, _ = js.spmsv(j_apply, jnp.asarray(b), struct, g, offsets,
                                     col_offsets=col_off)
        _close(c, cj)
        np.testing.assert_array_equal(c_struct, c_struct_j)
        assert c_struct.shape == (16, 2) and c_struct[2, 0] and c_struct[9, 1]

        panels, structs = ts.spmsv_chain(t_apply, _t(b), struct, g, offsets, steps=8,
                                         col_offsets=col_off, dense_switch=0.5)
        panels_j, structs_j = js.spmsv_chain(j_apply, jnp.asarray(b), struct, g,
                                             offsets, steps=8, col_offsets=col_off,
                                             dense_switch=0.5)
        assert len(panels) == len(panels_j) == 9
        assert np.mean(structs[-1]) > np.mean(structs[0])
        for p, pj in zip(panels, panels_j):
            _close(p, pj, tol=1e-10 * max(1.0, float(np.abs(np.asarray(pj)).max())))
        for s, sj in zip(structs, structs_j):
            assert s.dtype == sj.dtype
            np.testing.assert_array_equal(s, sj)

    def test_dense_switch_flag(self, poisson_small, rng):
        """The chain's switch to the dense regime at the same step as JAX's
        (1-D support from one block row)."""
        a = poisson_small
        n = a.shape[0]
        offsets = nsplit(n, 16)
        g = ts.block_support_graph(a, offsets)
        b = rng.standard_normal((n, 2))
        struct = np.zeros(16, dtype=bool)
        struct[0] = True
        ae, aj = t_ell(a), j_ell(a)
        flags_t, flags_j = [], []
        cur_t, cur_j, st_t, st_j = _t(b), jnp.asarray(b), struct, struct
        for _ in range(6):
            cur_t, st_t, d_t = ts.spmsv(lambda x: t_ell_spmm(ae, x), cur_t, st_t, g,
                                        offsets, dense_switch=0.5)
            cur_j, st_j, d_j = js.spmsv(lambda x: j_ell_spmm(aj, x), cur_j, st_j, g,
                                        offsets, dense_switch=0.5)
            flags_t.append(d_t)
            flags_j.append(d_j)
            np.testing.assert_array_equal(st_t, st_j)
        assert flags_t == flags_j and any(flags_t) and not flags_t[0]


class TestSpMSVPacked:
    def _packed(self, poisson_small, rng, lib):
        a = poisson_small
        n = a.shape[0]
        bs = 32
        nb = -(-n // bs)
        offsets = (np.arange(nb + 1) * bs).clip(max=n)
        g = (ts if lib == "torch" else js).block_support_graph(a, offsets)
        b = np.zeros((nb * bs, 3))
        active = [2, 7, 11]
        for i in active:
            b[i * bs:(i + 1) * bs] = rng.standard_normal((bs, 3))
        if lib == "torch":
            ab = t_block_ell(a, bm=bs, bk=bs, dtype=np.float64)
            b_ids, b_vals = ts.pack_multivector(_t(b), bs, np.array(active), cap=8)
            c_ids_host = ts.predict_c_support(g, b_ids.numpy(), nb)
            c_ids, c_vals = ts.spmsv_packed(ab, b_ids, b_vals, c_ids_host,
                                            cap_c=min(len(c_ids_host) + 4, nb))
            return b, nb, (b_ids, b_vals, c_ids, c_vals,
                           ts.unpack_multivector(c_ids, c_vals, nb))
        ab = j_block_ell(a, bm=bs, bk=bs, dtype=np.float64)
        b_ids, b_vals = js.pack_multivector(jnp.asarray(b), bs, np.array(active), cap=8)
        c_ids_host = js.predict_c_support(g, np.asarray(b_ids), nb)
        c_ids, c_vals = js.spmsv_packed(ab, b_ids, b_vals, c_ids_host,
                                        cap_c=min(len(c_ids_host) + 4, nb))
        return b, nb, (b_ids, b_vals, c_ids, c_vals,
                       js.unpack_multivector(c_ids, c_vals, nb))

    def test_packed_matches_dense_product(self, poisson_small, rng):
        a = poisson_small
        n = a.shape[0]
        b, nb, (b_ids, b_vals, c_ids, c_vals, c) = self._packed(
            poisson_small, np.random.default_rng(42), "torch")
        ref = np.zeros((nb * 32, 3))
        ref[:n] = a @ b[:n]
        np.testing.assert_allclose(c.numpy(), ref, rtol=1e-10, atol=1e-12)
        _, _, jax_out = self._packed(poisson_small, np.random.default_rng(42), "jax")
        np.testing.assert_array_equal(b_ids.numpy(), np.asarray(jax_out[0]))
        np.testing.assert_array_equal(c_ids.numpy(), np.asarray(jax_out[2]))
        assert b_ids.dtype == torch.int32 and c_ids.dtype == torch.int32
        for port, ref_j in zip((b_vals, c_vals, c), (jax_out[1], jax_out[3], jax_out[4])):
            _close(port, ref_j)

    def test_packed_cost_scales_with_active_fraction(self, poisson_small):
        a = poisson_small
        n = a.shape[0]
        bs = 64
        nb = -(-n // bs)
        ab = t_block_ell(a, bm=bs, bk=bs, dtype=np.float64)
        b = np.zeros((nb * bs, 2))
        b[:bs] = 1.0
        b_ids, b_vals = ts.pack_multivector(_t(b), bs, np.array([0]), cap=2)
        c_ids, c_vals = ts.spmsv_packed(ab, b_ids, b_vals, np.array([0, 1]), cap_c=3)
        assert tuple(c_vals.shape) == (3, bs, 2)
        assert tuple(b_vals.shape) == (2, bs, 2)
        abj = j_block_ell(a, bm=bs, bk=bs, dtype=np.float64)
        bj_ids, bj_vals = js.pack_multivector(jnp.asarray(b), bs, np.array([0]), cap=2)
        cj_ids, cj_vals = js.spmsv_packed(abj, bj_ids, bj_vals, np.array([0, 1]),
                                          cap_c=3)
        np.testing.assert_array_equal(c_ids.numpy(), np.asarray(cj_ids))
        _close(c_vals, cj_vals)

    def test_unpack_sums_duplicates_and_drops_dead(self, rng):
        """``index_add_`` (JAX's ``.at[].add``): a block listed twice sums,
        dead slots vanish."""
        vals = rng.standard_normal((4, 3, 2))
        ids = np.array([1, -1, 1, 0], dtype=np.int32)
        got = ts.unpack_multivector(torch.from_numpy(ids), _t(vals), 3)
        want = js.unpack_multivector(jnp.asarray(ids), jnp.asarray(vals), 3)
        _close(got, want)

    def test_square_blocks_required(self, poisson_small):
        ab = t_block_ell(poisson_small, bm=8, bk=16, dtype=np.float64)
        ids, vals = ts.pack_multivector(torch.zeros((512, 1), dtype=torch.float64), 8,
                                        np.array([0]), cap=1)
        with pytest.raises(ValueError, match="square"):
            ts.spmsv_packed(ab, ids, vals, np.array([0]), cap_c=1)
