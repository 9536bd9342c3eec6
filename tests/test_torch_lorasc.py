"""The port's single-device LORASC (precond/lorasc_scale.py,
parallel/lorasc_stencil.py) against the JAX package's, in f64.

Heterogeneous elasticity3d(6³) (contrast 1e3, the LORASC record's operator
family), 8 box parts on the (7, 7, 6) node grid, max_deflation 64, ECG
t = 12 omin on lane-major panels, tol 1e-5.

* Host planning — ``factor3``, ``grid_box_partition``, ``collapse_to_nodes``,
  ``plan_arrow_bands`` and ``_stencil_lo_blocks`` — bitwise equal.
* ``assemble_band_from_stencil`` and ``lorasc_apply`` (σ and balancing
  "deflate" corrections) on the JAX build's own operands, carried over by
  ``interop.lorasc_from_reference``: 1e-10 relative. The port's
  ``_attach_deflation_lift`` on the JAX σ operands gives the JAX lift to
  1e-10.
* The port's own build: the same deflated count as the JAX build, and the
  deflated Ritz values λ = tol/(1 + σ) to 1e-8 relative.
* ``StencilLorascECG`` solves, on the JAX operands and on the port's own
  build: iterations within ±1 of the JAX solve (14 in the σ form, 12
  deflated), x within 1e-8 relative on the JAX operands.
The f32 solve with double-float refinement is in
tests/test_torch_lorasc_refine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prealps_tpu.core import gridpart as jgp
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.parallel import lorasc_stencil as jstl
from prealps_tpu.precond import lorasc_scale as jls
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.core import gridpart as tgp
from prealps_tpu_torch.interop import lorasc_from_reference
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm
from prealps_tpu_torch.parallel import lorasc_stencil as tstl
from prealps_tpu_torch.precond import lorasc_scale as tls
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

NEL = 6
GRID = (NEL + 1, NEL + 1, NEL)
DEFL_TOL = 1e-2
BUILD = dict(nparts=8, br=3, grid=GRID, max_deflation=64, pencil="agg",
             inner_tol=1e-3, dtype=np.float64)


def _opts(cls):
    return cls(t=12, tol=1e-5, maxiter=500, variant="omin", layout="tbn")


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _to_numpy_ops(ops):
    out = {}
    for name, v in ops.items():
        if name == "a_stencil":
            out["blocks_t"] = np.asarray(v.blocks_t)
        else:
            out[name] = np.asarray(v)
    return out


def _port_precond(plan, ops_np, offsets, n, deflated):
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    return lorasc_from_reference(fields, ops_np, dict(offsets=offsets, shape=(n, n),
                                                      deflated=deflated), device="cpu")


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(NEL, NEL, NEL, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    a_s, _ = sym_rac_scaling(a)
    return a, b, a_s


@pytest.fixture(scope="module")
def ref(problem):
    """The JAX σ build and solve; its operands in numpy, and the balancing
    ("deflate") operands the JAX lift derives from them."""
    a, b, _ = problem
    s = jstl.StencilLorascECG.build(a, opts=_opts(JaxOptions), correction="sigma",
                                    **BUILD)
    x, info = s.solve(b)
    pc = s.precond
    ops_sigma = _to_numpy_ops(pc.operands)
    dev = dict(pc.operands)
    jls._attach_deflation_lift(pc.plan, dev, np.float64, lam_floor=DEFL_TOL * 1e-4)
    ops_defl = _to_numpy_ops(dev)
    return dict(solver=s, x=x, info=info, plan=pc.plan, deflated=pc.deflated,
                offsets=tuple(pc.operands["a_stencil"].offsets),
                ops={"sigma": ops_sigma, "deflate": ops_defl})


@pytest.mark.parametrize("k", [1, 2, 6, 8, 12, 16, 27, 30, 64])
def test_factor3_matches_jax(k):
    assert tgp.factor3(k) == jgp.factor3(k)


@pytest.mark.parametrize("grid,k", [((7, 7, 6), 8), ((37, 37, 36), 8), ((9, 5, 4), 6),
                                    ((5, 5, 5), 1), ((10, 3, 7), 4)])
def test_grid_box_partition_matches_jax(grid, k):
    pt, st = tgp.grid_box_partition(*grid, k)
    pj, sj = jgp.grid_box_partition(*grid, k)
    assert pt.dtype == pj.dtype and st.dtype == sj.dtype
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(st, sj)


def test_collapse_to_nodes_matches_jax(problem):
    _, _, a_s = problem
    gt, gj = tgp.collapse_to_nodes(a_s, 3), jgp.collapse_to_nodes(a_s, 3)
    assert (gt != gj).nnz == 0 and gt.dtype == gj.dtype


@pytest.mark.parametrize("order", ["auto", "natural", "rcm"])
def test_plan_arrow_bands_matches_jax(problem, order):
    _, _, a_s = problem
    graph = jgp.collapse_to_nodes(a_s, 3)
    part, sep = jgp.grid_box_partition(*GRID, 8)
    pt = tls.plan_arrow_bands(graph, part, sep, 8, 3, interior_order=order)
    pj = jls.plan_arrow_bands(graph, part, sep, 8, 3, interior_order=order)
    for f in dataclasses.fields(pj):
        vt, vj = getattr(pt, f.name), getattr(pj, f.name)
        if isinstance(vj, np.ndarray):
            assert vt.shape == vj.shape, f.name
            np.testing.assert_array_equal(vt, vj, err_msg=f.name)
        else:
            assert vt == vj, f.name


def test_stencil_lo_blocks_matches_jax(problem):
    _, _, a_s = problem
    a_t = tfmt.csr_to_stencil_bsr_t(a_s, br=3, dtype=np.float32)
    lo_t = tstl._stencil_lo_blocks(a_s, a_t, 3).numpy()
    lo_j = np.asarray(jstl._stencil_lo_blocks(a_s, a_t, 3))
    assert lo_t.dtype == lo_j.dtype == np.float32
    np.testing.assert_array_equal(lo_t, lo_j)
    assert np.abs(lo_t).max() > 0


@pytest.mark.parametrize("separator", [False, True])
def test_assemble_band_matches_jax(ref, separator):
    plan, ops = ref["plan"], ref["ops"]["sigma"]
    blocks, offs = ops["blocks_t"], ref["offsets"]
    if separator:
        args = (1, plan.nblk_g, plan.bs_g, np.array([plan.ng]))
    else:
        args = (plan.nparts, plan.nblk_i, plan.bs_i, plan.ni_dof)
    dt, et = tls.assemble_band_from_stencil(
        torch.from_numpy(blocks.copy()), offs, torch.from_numpy(plan.part_arr),
        torch.from_numpy(plan.pos_arr), *args[:3], torch.from_numpy(args[3]),
        separator=separator)
    dj, ej = jax.jit(lambda bl, pa, po, c: jls.assemble_band_from_stencil(
        bl, offs, pa, po, *args[:3], c, separator=separator))(
        jnp.asarray(blocks), jnp.asarray(plan.part_arr), jnp.asarray(plan.pos_arr),
        jnp.asarray(args[3]))
    assert _rel(dt.numpy(), np.asarray(dj)) < 1e-14
    assert _rel(et.numpy(), np.asarray(ej)) < 1e-14


@pytest.mark.parametrize("mode", ["sigma", "deflate"])
@pytest.mark.parametrize("t", [1, 12])
def test_lorasc_apply_on_reference_operands_matches_jax(ref, mode, t):
    plan, ops_np = ref["plan"], ref["ops"][mode]
    pc = _port_precond(plan, ops_np, ref["offsets"], 3 * plan.nrb, ref["deflated"])
    assert ("w_lift" in pc.operands) == (mode == "deflate")
    r = np.random.default_rng(t).standard_normal((t, plan.br, plan.nrb))
    before = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
    z_t = pc.apply(torch.from_numpy(r)).numpy()
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches == before   # plain route
    ops_j = dict(ref["solver"].precond.operands)
    ops_j.update({k: jnp.asarray(v) for k, v in ops_np.items() if k != "blocks_t"})
    z_j = np.asarray(jax.jit(lambda o, v: jls.lorasc_apply(plan, o, v))(
        ops_j, jnp.asarray(r)))
    assert z_t.shape == r.shape
    assert _rel(z_t, z_j) < 1e-10


def test_deflation_lift_on_reference_operands_matches_jax(ref):
    plan = ref["plan"]
    pc = _port_precond(plan, ref["ops"]["sigma"], ref["offsets"], 3 * plan.nrb,
                       ref["deflated"])
    tls._attach_deflation_lift(plan, pc.operands, np.float64,
                               lam_floor=DEFL_TOL * 1e-4)
    want = ref["ops"]["deflate"]
    for name in ("w_lift", "aw_sep"):
        assert _rel(pc.operands[name].numpy(), want[name]) < 1e-10, name
    # the coarse factor is L⁻¹ up to an orthogonal factor: compare L⁻ᵀL⁻¹
    lt = pc.operands["coarse_linv"].numpy()
    lj = want["coarse_linv"]
    assert _rel(lt.T @ lt, lj.T @ lj) < 1e-10
    assert pc.operands["e_mat"].shape[1] == 0 and pc.operands["sigma"].numel() == 0


def test_port_build_deflates_like_jax(problem, ref):
    """The port's own f64 build: the same deflated count, and the same
    deflated Ritz values λ = tol/(1 + σ)."""
    a, _, a_s = problem
    pc = tls.build_scalable_lorasc(a_s, nparts=8, br=3, grid=GRID, max_deflation=64,
                                   correction="sigma", dtype=np.float64, device="cpu")
    assert pc.deflated == ref["deflated"] > 0
    assert set(pc.timings) == {"plan", "factor", "lanczos"}
    sig_t = pc.operands["sigma"].numpy()
    sig_j = ref["ops"]["sigma"]["sigma"]
    lam_t = np.sort(DEFL_TOL / (1.0 + sig_t[sig_t > 0]))
    lam_j = np.sort(DEFL_TOL / (1.0 + sig_j[sig_j > 0]))
    np.testing.assert_allclose(lam_t, lam_j, rtol=1e-8)


def test_host_refine_pairs_matches_jax(problem, ref):
    """The f32 σ build's f64 Rayleigh–Ritz of the candidate pairs, on the
    JAX build's deflation vectors (perturbed to f32 precision): the port's
    device path (f64 stencil products and banded factors, one part at a
    time; here on the CPU) against the JAX package's host SciPy one. The
    same kept count, λ to 1e-10 relative (6.8e-13 here), and the same span:
    the largest principal angle under 1e-10 (9e-16 here). Vector by vector
    they may differ: the cube's symmetry gives λ near-degenerate clusters,
    inside which the two factorisations' rounding picks other bases."""
    _, _, a_s = problem
    plan = ref["plan"]
    e = ref["ops"]["sigma"]["e_mat"][:, ref["ops"]["sigma"]["sigma"] > 0]
    cand = e.astype(np.float32).astype(np.float64)
    th_t, e_t = tls._refine_pairs(a_s, plan, cand, DEFL_TOL, device="cpu")
    th_j, e_j = jls._host_refine_pairs(a_s, plan, cand, DEFL_TOL)
    assert th_t.size == th_j.size > 0 and e_t.shape == e_j.shape == (plan.ng, th_t.size)
    np.testing.assert_allclose(th_t, th_j, rtol=1e-10)
    q_t, q_j = np.linalg.qr(e_t)[0], np.linalg.qr(e_j)[0]
    sin_max = np.linalg.norm(q_t - q_j @ (q_j.T @ q_t), 2)
    assert sin_max < 1e-10


def test_solve_on_reference_operands_matches_jax(problem, ref):
    a, b, _ = problem
    plan = ref["plan"]
    pc = _port_precond(plan, ref["ops"]["sigma"], ref["offsets"], a.shape[0],
                       ref["deflated"])
    s = tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), correction="sigma",
                                    device="cpu", precond=pc, **BUILD)
    x, info = s.solve(b)
    assert abs(info["iters"] - ref["info"]["iters"]) <= 1
    assert info["deflated"] == ref["deflated"] and not info["breakdown"]
    assert np.linalg.norm(x - ref["x"]) <= 1e-8 * np.linalg.norm(ref["x"])


@pytest.mark.parametrize("correction", ["sigma", "deflate"])
def test_port_solve_matches_jax_iterations(problem, ref, correction):
    """The port's own build + solve; the JAX deflated solve reuses the
    reference σ build's preconditioner with the JAX lift attached."""
    a, b, _ = problem
    s = tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), correction=correction,
                                    device="cpu", **BUILD)
    x, info = s.solve(b)
    if correction == "sigma":
        want = ref["info"]["iters"]
    else:
        sj = ref["solver"]
        ops_j = dict(sj.precond.operands)
        ops_j.update({k: jnp.asarray(v) for k, v in ref["ops"]["deflate"].items()
                      if k != "blocks_t"})
        sj._m_ops = ops_j
        try:
            want = sj.solve(b)[1]["iters"]
        finally:
            sj._m_ops = sj.precond.operands
    assert abs(info["iters"] - want) <= 1, (info["iters"], want)
    assert info["deflated"] == ref["deflated"] and not info["breakdown"]
    assert np.linalg.norm(b - a @ x) < 1e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("kw", [dict(pencil="sloc"), dict(pencil="saloc"),
                                dict(factor_store="bf16"), dict(grid=None),
                                dict(a_store="bf16"), dict(a_store="bf16_all")])
def test_unported_options_raise(problem, kw, monkeypatch):
    """The cases of the former refusal test. Each builds and solves as the
    JAX driver does, with the balancing correction: the PRESC pencils and
    grid=None (the generic block-arrow partition, the JAX package's Python
    algorithm) in f64 (the same deflated count, iterations within ±1), the
    bf16 stores in f32 with refinement
    (relres < 1e-5 and iterations within 10 % of the JAX driver's, since
    the two f32 solves round in another order; bf16_all reproduces the JAX
    package's pinned failure in both packages). The f32
    solves run at t = 4, as the JAX package's bf16 tests do: at t = 12 the
    f32 omin solve of this 882-dof operator breaks down in both packages
    whatever the stores."""
    a, b, _ = problem
    monkeypatch.setenv("PREALPS_TPU_NO_NATIVE", "1")
    build = dict(BUILD, correction="deflate", **kw)
    t = 12
    if "pencil" not in kw and "grid" not in kw:
        build["dtype"], t = np.float32, 4
    sj = jstl.StencilLorascECG.build(a, opts=dataclasses.replace(_opts(JaxOptions), t=t),
                                     **build)
    s = tstl.StencilLorascECG.build(a, opts=dataclasses.replace(_opts(ECGOptions), t=t),
                                    device="cpu", **build)
    x_j, info_j = sj.solve(b)
    x, info = s.solve(b)
    rel = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    if kw.get("a_store") == "bf16_all":
        assert s.precond.operands["a_stencil"].blocks_t.dtype == torch.bfloat16
        rel_j = np.linalg.norm(b - a @ x_j) / np.linalg.norm(b)
        assert info["breakdown"] or rel > 1e-3, (info, rel)
        assert info_j["breakdown"] or rel_j > 1e-3, (info_j, rel_j)
        return
    assert s.precond.deflated == sj.precond.deflated > 0
    assert not info["breakdown"] and rel < 1e-5
    band = 1 if ("pencil" in kw or "grid" in kw) else 0.1 * info_j["iters"]
    assert abs(info["iters"] - info_j["iters"]) <= band, (info["iters"], info_j["iters"])


def test_generic_partition_matches_jax(monkeypatch):
    """grid=None on het 8³ with 4 parts: the node partition of the generic
    block-arrow structure bitwise the JAX Python version's, the same
    deflated pairs, and the f64 solve's iterations within ±1."""
    from prealps_tpu.core.partition import block_arrow_structure as j_arrow
    from prealps_tpu_torch.core.gridpart import collapse_to_nodes
    from prealps_tpu_torch.core.partition import block_arrow_structure as t_arrow

    monkeypatch.setenv("PREALPS_TPU_NO_NATIVE", "1")
    a = elasticity3d(8, 8, 8, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    graph = collapse_to_nodes(sym_rac_scaling(a)[0], 3)
    np.testing.assert_array_equal(t_arrow(graph, 4).part, j_arrow(graph, 4).part)
    build = dict(BUILD, nparts=4, grid=None, correction="deflate")
    sj = jstl.StencilLorascECG.build(a, opts=_opts(JaxOptions), **build)
    s = tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), device="cpu", **build)
    np.testing.assert_array_equal(s.precond.plan.part_arr, sj.precond.plan.part_arr)
    assert s.precond.deflated == sj.precond.deflated > 0
    _, info_j = sj.solve(b)
    x, info = s.solve(b)
    assert abs(info["iters"] - info_j["iters"]) <= 1, (info["iters"], info_j["iters"])
    assert not info["breakdown"]
    assert np.linalg.norm(b - a @ x) < 1e-5 * np.linalg.norm(b)


def test_build_refuses_an_absent_card(problem, monkeypatch):
    a, _, _ = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), **BUILD)
