"""The port's bf16 stores of the single-device LORASC driver against the JAX
package's: ``factor_store="bf16"`` (bf16 banded factors, f32 vectors),
``a_store="bf16"`` (a bf16 copy of the operator for the preconditioner's
sweeps) and ``a_store="bf16_all"`` (the iteration operator too), and the
plain lane-major product on bf16 blocks.

Heterogeneous elasticity3d(8³), 4 box parts on the (9, 9, 8) node grid,
max_deflation 24, the balancing ("deflate") correction, f32, ECG t = 4
omin to 1e-5 with device double-float refinement (tests/test_lorasc_scale.py's
TestFactorStore / TestAStore configuration, on a grid partition):

* bf16 factors: the four factor tensors are bf16 and the apply returns
  f32; on the JAX build's own bf16 operands the port's apply agrees with
  JAX's to 1e-5 relative (f32 sums in another order); against the f32
  factors within 5e-2 (JAX's bound); ⟨r1, M r2⟩ and ⟨r2, M r1⟩ within 1e-4.
* ``a_store="bf16"``: ``a_stencil_m`` is bf16 and the iteration operator
  f32; iterations within ±1 of JAX's at the same configuration and within
  JAX's rule 1.2 × (the f32 store's count) + 2.
* ``a_store="bf16_all"``: the pinned failure (breakdown, or relres > 1e-3).
* ``_stencil_lo_blocks`` with a bf16 store: bitwise equal to JAX's (whose
  rounding is ml_dtypes'; the port rounds with torch).
* The plain lane-major product on bf16 blocks against JAX's B2a in
  interpret mode on the same blocks: within 1e-6 · max(|B|·|x|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from prealps_tpu.core.generators import elasticity3d
from prealps_tpu.core.scaling import sym_rac_scaling
from prealps_tpu.ops import spmm as jspmm
from prealps_tpu.ops.formats import StencilBsrTMatrix as JStencilBsrTMatrix
from prealps_tpu.parallel import lorasc_stencil as jstl
from prealps_tpu.precond import lorasc_scale as jls
from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
from prealps_tpu_torch.interop import lorasc_from_reference
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm
from prealps_tpu_torch.parallel import lorasc_stencil as tstl
from prealps_tpu_torch.precond import lorasc_scale as tls
from prealps_tpu_torch.solvers.ecg import ECGOptions
from tests.lane_cases import lane_operator

torch.set_num_threads(1)

GRID = (9, 9, 8)
BUILD = dict(nparts=4, br=3, grid=GRID, dtype=np.float32, max_deflation=24,
             correction="deflate")
FACTORS = ("aii_linv", "aii_moff", "agg_linv", "agg_moff")


def _opts(cls):
    return cls(t=4, tol=1e-5, maxiter=3000, variant="omin", layout="tbn")


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16_numpy(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


@pytest.fixture(scope="module")
def problem():
    a = elasticity3d(8, 8, 8, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    return a, b, sym_rac_scaling(a)[0]


@pytest.fixture(scope="module")
def precs(problem):
    """The port's f32 and bf16-factor preconditioners of one operator."""
    _, _, a_s = problem
    kw = dict(BUILD, device="cpu")
    return {fs: tls.build_scalable_lorasc(a_s, factor_store=fs, **kw)
            for fs in ("f32", "bf16")}


@pytest.fixture(scope="module")
def ref(problem):
    """The JAX build and solve with a_store="bf16" and bf16 factors."""
    a, b, _ = problem
    s = jstl.StencilLorascECG.build(a, opts=_opts(JaxOptions), a_store="bf16",
                                    factor_store="bf16", **BUILD)
    x, info = s.solve(b)
    return dict(solver=s, info=info, relres=np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def _solve(problem, **kw):
    a, b, _ = problem
    s = tstl.StencilLorascECG.build(a, opts=_opts(ECGOptions), device="cpu",
                                    **dict(BUILD, **kw))
    x, info = s.solve(b)
    return s, info, float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def test_bf16_factors_stored_and_apply_in_f32(precs):
    pc32, pcbf = precs["f32"], precs["bf16"]
    for name in FACTORS:
        assert pcbf.operands[name].dtype == torch.bfloat16, name
        assert pc32.operands[name].dtype == torch.float32, name
        # the cast comes after every build consumer: the f32 values round
        assert torch.equal(pcbf.operands[name], pc32.operands[name].to(torch.bfloat16))
    assert pcbf.deflated == pc32.deflated > 0
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, pcbf.plan.nrb)).astype(np.float32))
    w = pcbf.apply(r)
    assert w.dtype == torch.float32 and w.shape == r.shape


def test_bf16_apply_matches_jax_on_its_operands(ref):
    """The JAX build's own operands (bf16 factors, the bf16 sweep copy)
    carried over by lorasc_from_reference."""
    pc_j = ref["solver"].precond
    ops_np = {}
    for name, v in pc_j.operands.items():
        if name in ("a_stencil", "a_stencil_m"):
            ops_np["blocks_t" if name == "a_stencil" else "blocks_t_m"] = np.asarray(v.blocks_t)
        else:
            ops_np[name] = np.asarray(v)
    assert ops_np["aii_linv"].dtype == ml_dtypes.bfloat16
    assert ops_np["blocks_t_m"].dtype == ml_dtypes.bfloat16
    plan = pc_j.plan
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    pc = lorasc_from_reference(fields, ops_np, dict(
        offsets=pc_j.operands["a_stencil"].offsets, shape=pc_j.operands["a_stencil"].shape,
        deflated=pc_j.deflated), device="cpu")
    assert pc.operands["agg_moff"].dtype == torch.bfloat16
    assert pc.operands["a_stencil_m"].blocks_t.dtype == torch.bfloat16
    r = np.random.default_rng(2).standard_normal((4, 3, plan.nrb)).astype(np.float32)
    z_t = pc.apply(torch.from_numpy(r))
    z_j = np.asarray(jax.jit(lambda o, v: jls.lorasc_apply(plan, o, v))(
        pc_j.operands, jnp.asarray(r)))
    assert z_t.dtype == torch.float32 and z_j.dtype == np.float32
    assert _rel(z_t.numpy(), z_j) < 1e-5


def test_bf16_apply_close_to_f32_and_symmetric(precs):
    pc32, pcbf = precs["f32"], precs["bf16"]
    rng = np.random.default_rng(3)
    nrb = pc32.plan.nrb
    r = torch.from_numpy(rng.standard_normal((2, 3, nrb)).astype(np.float32))
    assert _rel(pcbf.apply(r).numpy(), pc32.apply(r).numpy()) < 5e-2
    r1, r2 = (torch.from_numpy(rng.standard_normal((1, 3, nrb)).astype(np.float32))
              for _ in range(2))
    s12 = float(torch.sum(r1 * pcbf.apply(r2)))
    s21 = float(torch.sum(r2 * pcbf.apply(r1)))
    assert abs(s12 - s21) / max(abs(s12), abs(s21)) < 1e-4, (s12, s21)


def test_a_store_bf16_solve_matches_jax(problem, ref):
    s32, info32, rel32 = _solve(problem)
    sbf, infobf, relbf = _solve(problem, a_store="bf16", factor_store="bf16")
    ops = sbf.precond.operands
    assert ops["a_stencil_m"].blocks_t.dtype == torch.bfloat16
    assert ops["a_stencil"].blocks_t.dtype == torch.float32
    assert "a_stencil_m" not in s32.precond.operands
    assert torch.equal(ops["a_stencil_m"].blocks_t,
                       ops["a_stencil"].blocks_t.to(torch.bfloat16))
    assert relbf < 1e-5 and rel32 < 1e-5 and ref["relres"] < 1e-5
    assert abs(infobf["iters"] - ref["info"]["iters"]) <= 1, (
        infobf["iters"], ref["info"]["iters"])
    assert infobf["iters"] <= 1.2 * info32["iters"] + 2, (infobf["iters"], info32["iters"])


def test_a_store_bf16_all_breaks_down_documented(problem):
    """bf16(A) of this operator is indefinite: the rejected configuration,
    kept for measurement, fails as it does in the JAX package."""
    s, info, relres = _solve(problem, a_store="bf16_all")
    assert s.precond.operands["a_stencil"].blocks_t.dtype == torch.bfloat16
    assert bool(info["breakdown"]) or relres > 1e-3, (info, relres)


def test_stencil_lo_blocks_bf16_store_matches_jax(problem):
    _, _, a_s = problem
    a_t = tfmt.csr_to_stencil_bsr_t(a_s, br=3, dtype=np.float32)
    lo_t = tstl._stencil_lo_blocks(a_s, a_t, 3, store_dtype=torch.bfloat16).numpy()
    lo_j = np.asarray(jstl._stencil_lo_blocks(a_s, a_t, 3,
                                              store_dtype=ml_dtypes.bfloat16))
    assert lo_t.dtype == lo_j.dtype == np.float32
    np.testing.assert_array_equal(lo_t, lo_j)
    # the bf16 rounding leaves a far larger remainder than the f32 one
    lo_32 = tstl._stencil_lo_blocks(a_s, a_t, 3).numpy()
    assert np.abs(lo_t).max() > 100 * np.abs(lo_32).max() > 0


def test_torch_bf16_rounding_matches_ml_dtypes():
    """torch's f64 -> bf16 conversion (round to nearest even) against
    ml_dtypes' on values that probe ties and both halves of the range."""
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.standard_normal(20000) * 10.0 ** rng.integers(-20, 20, 20000),
                        1.0 + np.arange(1, 512) * 2.0 ** -9, [0.0, -0.0, 1e-40]])
    got = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy()
    want = v.astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,t", [("random", 1), ("random", 12), ("elasticity", 12)])
def test_plain_product_bf16_blocks_matches_jax_b2a(kind, t):
    st32, _ = lane_operator(kind, np.float32)
    blocks = st32.blocks_t.to(torch.bfloat16)
    st = tfmt.StencilBsrTMatrix(blocks, st32.offsets, st32.shape)
    nrb = blocks.shape[3]
    x = np.random.default_rng(t).standard_normal((t, st.br, nrb)).astype(np.float32)
    before = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
    y = tspmm.stencil_bsr_spmm_t_pallas_bs(st, torch.from_numpy(x))
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches == before   # plain route
    assert y.dtype == torch.float32
    ja = JStencilBsrTMatrix(blocks_t=jnp.asarray(_bf16_numpy(blocks)),
                            offsets=st.offsets, shape=st.shape)
    ref = np.asarray(jspmm.stencil_bsr_spmm_t_pallas_bs(ja, jnp.asarray(x), interpret=True))
    assert ref.dtype == np.float32
    halo = max(abs(o) for o in st.offsets)
    scale = tspmm.stencil_scan_accumulate(
        blocks.float().abs(), st.offsets, tspmm.extend_wrap(torch.from_numpy(np.abs(x)), halo),
        halo).numpy()
    assert np.all(np.abs(y.numpy() - ref) <= 1e-6 * scale.max())
