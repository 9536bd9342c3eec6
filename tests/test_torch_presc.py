"""The port's PRESC pencils (precond/lorasc_scale.py, ``pencil="sloc"`` SSLOC
and ``pencil="saloc"`` SALOC) against the JAX package's, in f64.

Heterogeneous elasticity3d(8³) (contrast 1e3), 4 box parts on the (9, 9, 8)
node grid, ECG t = 4 odir_fused on lane-major panels, tol 1e-6, the
configurations of tests/test_presc.py (max_deflation 48 for SSLOC, 24 for
SALOC):

* ``_sep_node_owners`` and the owned-dof map ``own_dof`` bitwise equal;
  ``sloc`` and ``sloc_inv`` of the port's own build within 1e-10 relative
  of the JAX build's.
* Solves: on the JAX build's operands (``interop.lorasc_from_reference``)
  iterations within ±1 and x within 1e-8 relative of the JAX solve; the
  port's own build deflates the same number of pairs and solves within ±1
  iteration.
* The SALOC contract of tests/test_presc.py at deflation_tol 0.3: at least
  one pair, at most 60 iterations.
* An operand that is not SPD raises FloatingPointError in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from prealps_tpu.core import gridpart as jgp
from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.parallel import lorasc_stencil as jstl
from prealps_tpu.precond import lorasc_scale as jls
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.interop import lorasc_from_reference
from prealps_tpu_torch.parallel import lorasc_stencil as tstl
from prealps_tpu_torch.precond import lorasc_scale as tls
from prealps_tpu_torch.solvers.ecg import ECGOptions

torch.set_num_threads(1)

GRID = (9, 9, 8)
MAX_DEFL = {"sloc": 48, "saloc": 24}
BUILD = dict(nparts=4, br=3, grid=GRID, dtype=np.float64)


def _opts(cls):
    return cls(t=4, tol=1e-6, maxiter=3000, variant="odir_fused", layout="tbn")


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(8, 8, 8, heterogeneous=True)
    b = np.random.default_rng(42).standard_normal(a.shape[0])
    return a, b, sym_rac_scaling(a)[0]


@pytest.fixture(scope="module")
def ref(problem):
    """The JAX build and solve of each pencil, its operands in numpy."""
    a, b, _ = problem
    out = {}
    for pencil, md in MAX_DEFL.items():
        s = jstl.StencilLorascECG.build(a, opts=_opts(JaxOptions), pencil=pencil,
                                        max_deflation=md, **BUILD)
        x, info = s.solve(b)
        ops = {("blocks_t" if k == "a_stencil" else k):
               np.asarray(v.blocks_t if k == "a_stencil" else v)
               for k, v in s.precond.operands.items()}
        out[pencil] = dict(solver=s, x=x, info=info, ops=ops, plan=s.precond.plan,
                           deflated=s.precond.deflated)
    return out


@pytest.fixture(scope="module")
def port(problem):
    """The port's own build of each pencil."""
    a, _, _ = problem
    return {pencil: tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), pencil=pencil,
                                                max_deflation=md, device="cpu", **BUILD)
            for pencil, md in MAX_DEFL.items()}


def test_sep_node_owners_match_jax(problem):
    _, _, a_s = problem
    graph = jgp.collapse_to_nodes(a_s, 3)
    part, sep = jgp.grid_box_partition(*GRID, 4)
    plan = jls.plan_arrow_bands(graph, part, sep, 4, 3)
    ot = tls._sep_node_owners(graph, plan, plan.part_arr)
    oj = jls._sep_node_owners(graph, plan, plan.part_arr)
    assert ot.dtype == oj.dtype
    np.testing.assert_array_equal(ot, oj)
    assert np.bincount(ot).size == 4          # every part owns a share


@pytest.mark.parametrize("pencil", ["sloc", "saloc"])
def test_pencil_operands_match_jax(ref, port, pencil):
    ops_j = ref[pencil]["ops"]
    ops_t = port[pencil].precond.operands
    assert port[pencil].precond.timings.keys() >= {"plan", "factor", pencil, "lanczos"}
    np.testing.assert_array_equal(ops_t["own_dof"].numpy(), ops_j["own_dof"])
    np.testing.assert_array_equal(ops_t["own_dof_mask"].numpy(), ops_j["own_dof_mask"])
    for name in ("sloc", "sloc_inv"):
        assert ops_t[name].dtype == torch.float64
        assert ops_t[name].shape == ops_j[name].shape, name
        assert _rel(ops_t[name].numpy(), ops_j[name]) < 1e-10, name


@pytest.mark.parametrize("pencil", ["sloc", "saloc"])
def test_pencil_solves_match_jax(problem, ref, port, pencil):
    a, b, _ = problem
    r = ref[pencil]
    plan = r["plan"]
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    pc = lorasc_from_reference(fields, r["ops"], dict(
        offsets=r["solver"].precond.operands["a_stencil"].offsets,
        shape=a.shape, deflated=r["deflated"]), device="cpu")
    s = tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), pencil=pencil,
                                    device="cpu", precond=pc, **BUILD)
    x, info = s.solve(b)
    assert abs(info["iters"] - r["info"]["iters"]) <= 1
    assert np.linalg.norm(x - r["x"]) <= 1e-8 * np.linalg.norm(r["x"])
    x_own, info_own = port[pencil].solve(b)
    assert port[pencil].precond.deflated == r["deflated"]
    assert abs(info_own["iters"] - r["info"]["iters"]) <= 1, (
        info_own["iters"], r["info"]["iters"])
    assert not info_own["breakdown"]
    assert np.linalg.norm(b - a @ x_own) < 1e-5 * np.linalg.norm(b)
    if pencil == "sloc":
        assert r["deflated"] > 0


def test_saloc_behaviour_contract(problem):
    """SALOC is a weak pencil by construction; at deflation_tol 0.3 it must
    still yield a pair and converge within 60 iterations (the JAX test's
    contract)."""
    a, b, _ = problem
    s = tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), pencil="saloc",
                                    max_deflation=24, deflation_tol=0.3, device="cpu",
                                    **BUILD)
    assert s.precond.deflated >= 1
    x, info = s.solve(b)
    assert np.linalg.norm(b - a @ x) < 1e-5 * np.linalg.norm(b)
    assert info["iters"] <= 60, info["iters"]


@pytest.mark.parametrize("max_deflation", [24, 48])
def test_sloc_f32_pairs_match_jax(problem, max_deflation):
    """The f32 SSLOC build of the card test's 4-part configuration deflates
    the JAX build's pairs: none at nev 24 (the configuration whose f32
    solve breaks down or not with the rounding, ROADMAP.md queue C), some
    at nev 48 (tests/test_presc.py's)."""
    _, _, a_s = problem
    kw = dict(nparts=4, br=3, grid=GRID, dtype=np.float32, pencil="sloc",
              max_deflation=max_deflation, correction="deflate")
    got = tls.build_scalable_lorasc(a_s, device="cpu", **kw).deflated
    want = jls.build_scalable_lorasc(a_s, **kw).deflated
    assert got == want
    assert (want == 0) == (max_deflation == 24), want


def test_not_spd_operand_raises(problem):
    """−A: the SALOC operand −Agg_pp has no Cholesky factor."""
    _, _, a_s = problem
    kw = dict(nparts=4, br=3, grid=GRID, dtype=np.float64, pencil="saloc",
              max_deflation=4)
    with pytest.raises(FloatingPointError, match="not SPD"):
        tls.build_scalable_lorasc(-a_s, device="cpu", **kw)
    with pytest.raises(FloatingPointError, match="not SPD"):
        jls.build_scalable_lorasc(-a_s, **kw)
