"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

Imports neither JAX nor the JAX package, so it runs on the GPU machine,
which has no JAX; tests/conftest.py imports JAX, so run it there without
the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs:
max |y_kernel − y_plain| ≤ 1e-5·(|B|·|x|) elementwise (KERNEL_TOL). The
stencil kernels (flat B1, lane-major B2a / B2b / B3, planar B4: one source,
csrc/stencil.cu) sum the same products in the same order, with FMAs, so B1
is also held bitwise to an fmaf reference in that order (each step
computed in float64 and rounded to float32: the product of two floats is
exact in float64). The block-ELL kernel walks the packed nonzero entries
(``formats.pack_block_ell_entries``) of each row in slot order with fmaf
(at t 1 four strided part sums and a fixed tree), so two launches agree
bitwise, and the block-Jacobi kernel sums over k in one thread; those
agree with their plain versions to f32 rounding of the dot-product length.
The edge shapes are those of the stencil kernel's tiling (node tiles of
128, whole-width instances at t 1, 4, 8, 12 and 16, chunks of 8 columns
for other widths, the wrap map's modular columns, and br 2, which takes
the generic kernel) and of the block-Jacobi
kernel's (row tiles of 128, 32-column stages, up to 12 panel columns a
CTA, 16-byte or 4-byte z copies).
"""

import numpy as np
import pytest
import torch

from prealps_tpu_torch.core.generators import elasticity3d, poisson3d
from prealps_tpu_torch.core.layout import contiguous_row_layout, permute_and_pad_matrix
from prealps_tpu_torch.direct import device_bj as tbj
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

pytestmark = pytest.mark.cuda
KERNEL_TOL = 1e-5


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda", 0)


def _operands(a, br, t, seed, device):
    st = tfmt.csr_to_stencil_bsr_t(a, br=br, dtype=np.float32, device=device)
    halo = max(abs(o) for o in st.offsets)
    x = np.random.default_rng(seed).standard_normal((br * t, a.shape[0] // br))
    xf = torch.from_numpy(x.astype(np.float32)).to(device)
    x_ext = tspmm.extend_wrap(xf, halo).contiguous()
    return tfmt.stencil_blocks_flat(st.blocks_t).contiguous(), st.offsets, x_ext, halo


@pytest.mark.parametrize("br,t", [(3, 12), (3, 1), (3, 5), (1, 12), (1, 1), (1, 3)])
def test_kernel_matches_plain(cuda_device, br, t):
    a = elasticity3d(7, 6, 5) if br == 3 else poisson3d(12, 11, 10)
    bf, offs, x_ext, halo = _operands(a, br, t, seed=t, device=cuda_device)
    before = tspmm.stencil_flat_ext.launches
    y = tspmm.stencil_flat_ext(bf, offs, x_ext, halo, br)
    torch.cuda.synchronize()
    assert tspmm.stencil_flat_ext.launches == before + 1
    ref = tspmm.stencil_flat_ext_ref(bf, offs, x_ext, halo, br)
    scale = tspmm.stencil_flat_ext_ref(bf.abs(), offs, x_ext.abs(), halo, br)
    assert y.shape == ref.shape and y.device == ref.device
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    bf, offs, x_ext, halo = _operands(elasticity3d(5, 5, 4), 3, 2, seed=0,
                                      device=cuda_device)
    with pytest.raises(TypeError):
        tspmm.stencil_flat_ext(bf.double(), offs, x_ext.double(), halo, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tspmm.stencil_flat_ext(bf, offs, x_ext.t().contiguous().t(), halo, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.stencil_flat_ext(bf, offs, x_ext.cpu(), halo, 3)


def test_small_solve_on_the_card_matches_cpu(cuda_device):
    """The same f32 + refinement solve on the card and on the CPU (where
    the plain SpMM runs): both reach tol; iteration totals within 25 %."""
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    kw = dict(fmt="stencil", br=3, precond="bj2l", block_size=24,
              grid=(7, 7, 6), dtype=np.float32,
              opts=ECGOptions(t=4, tol=1e-7, maxiter=2000, layout="tbn"))
    before = tspmm.stencil_flat_ext.launches
    x_g, info_g = DistributedECG.build(a, device=cuda_device, **kw).solve(b)
    assert tspmm.stencil_flat_ext.launches - before >= info_g["iters"]
    x_c, info_c = DistributedECG.build(a, device="cpu", **kw).solve(b)
    for x in (x_g, x_c):
        assert np.linalg.norm(b - a @ x) < 1e-7 * np.linalg.norm(b)
    assert abs(info_g["iters"] - info_c["iters"]) <= 0.25 * info_c["iters"]


def _block_ell(a, bk, t, seed, device):
    m = tfmt.csr_to_block_ell(a, bm=8, bk=bk, dtype=np.float32, device=device)
    m.entries = tfmt.pack_block_ell_entries(m)
    x = np.random.default_rng(seed).standard_normal((m.shape[1], t))
    return m, torch.from_numpy(x.astype(np.float32)).to(device)


@pytest.mark.parametrize("bk,t", [(128, 12), (128, 1), (128, 5), (8, 12),
                                  (8, 1), (64, 3), (128, 4), (128, 16), (8, 4),
                                  (8, 16), (64, 1), (64, 4), (64, 12), (64, 16)])
def test_block_ell_kernel_matches_plain(cuda_device, bk, t):
    m, x = _block_ell(elasticity3d(7, 6, 5), bk, t, seed=bk + t,
                      device=cuda_device)
    before = tspmm.block_ell_spmm_pallas.launches
    y = tspmm.block_ell_spmm_pallas(m, x)
    torch.cuda.synchronize()
    assert tspmm.block_ell_spmm_pallas.launches == before + 1
    ref = tspmm.block_ell_spmm(m, x)
    scale = tspmm.block_ell_spmm(tfmt.BlockEllMatrix(m.blocks.abs(), m.blkcols,
                                                     m.shape), x.abs())
    assert y.shape == ref.shape
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_block_ell_kernel_refuses_what_it_does_not_take(cuda_device):
    m, x = _block_ell(elasticity3d(5, 5, 4), 128, 4, seed=0, device=cuda_device)
    m64 = tfmt.BlockEllMatrix(m.blocks.double(), m.blkcols, m.shape)
    with pytest.raises(TypeError):
        tspmm.block_ell_spmm_pallas(m64, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tspmm.block_ell_spmm_pallas(m, x.t().contiguous().t())
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.block_ell_spmm_pallas(m, x.cpu())


def test_block_ell_kernel_needs_packed_entries(cuda_device):
    """A CUDA matrix without its packed entries raises, naming the pack;
    the wrapper neither packs per call nor falls back."""
    m, x = _block_ell(elasticity3d(5, 5, 4), 128, 12, seed=0, device=cuda_device)
    bare = tfmt.BlockEllMatrix(m.blocks, m.blkcols, m.shape)
    before = tspmm.block_ell_spmm_pallas.launches
    with pytest.raises(ValueError, match="pack_block_ell_entries"):
        tspmm.block_ell_spmm_pallas(bare, x)
    assert tspmm.block_ell_spmm_pallas.launches == before and bare.entries is None


@pytest.mark.parametrize("t", [1, 5, 12])
def test_block_ell_kernel_is_deterministic(cuda_device, t):
    """Two launches on the same input give the same bits (each row summed
    in slot order; at t 1 a fixed tree of four part sums)."""
    m, x = _block_ell(elasticity3d(9, 8, 7), 128, t, seed=t, device=cuda_device)
    y1 = tspmm.block_ell_spmm_pallas(m, x)
    y2 = tspmm.block_ell_spmm_pallas(m, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def _bj_operands(t, seed, device):
    a = elasticity3d(6, 5, 5)
    mbn, br = 24, 3
    lay = contiguous_row_layout(a.shape[0], 1, row_multiple=mbn * br)
    st = tfmt.csr_to_stencil_bsr_t(permute_and_pad_matrix(a, lay), br=br,
                                   dtype=np.float32, device=device)
    inv_f = tbj.build_device_block_jacobi_flat(st.blocks_t, st.offsets, mbn=mbn)
    nrb = st.blocks_t.shape[-1]
    z = np.random.default_rng(seed).standard_normal((t, br, nrb))
    return inv_f, torch.from_numpy(z.astype(np.float32)).to(device), br


@pytest.mark.parametrize("t", [12, 5, 1])
def test_bj_apply_kernel_matches_plain(cuda_device, t):
    inv_f, z, br = _bj_operands(t, seed=t, device=cuda_device)
    b2 = tbj.pack_bj_dense(inv_f)
    assert b2.shape[1] % 128 == 0
    before = tbj.bj_apply_pallas.launches
    w = tbj.bj_apply_pallas(b2, z, br)
    torch.cuda.synchronize()
    assert tbj.bj_apply_pallas.launches == before + 1
    ref = tbj.bj_apply_pallas_ref(b2, z, br)
    scale = tbj.bj_apply_pallas_ref(b2.abs(), z.abs(), br)
    assert bool(((w - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())
    # and the driver's GEMM on the unpadded inverses
    assert bool(((w - tbj.bj_apply_flat(inv_f, z)).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_bj_apply_kernel_refuses_what_it_does_not_take(cuda_device):
    inv_f, z, br = _bj_operands(4, seed=0, device=cuda_device)
    b2 = tbj.pack_bj_dense(inv_f)
    with pytest.raises(TypeError):
        tbj.bj_apply_pallas(b2.double(), z.double(), br)
    with pytest.raises(ValueError, match="contiguous"):
        tbj.bj_apply_pallas(b2.transpose(1, 2), z, br)
    with pytest.raises(ValueError, match="CUDA"):
        tbj.bj_apply_pallas(b2, z.cpu(), br)


def _lane_operands(br, t, seed, device):
    a = elasticity3d(7, 6, 5) if br == 3 else poisson3d(12, 11, 10)
    st = tfmt.csr_to_stencil_bsr_t(a, br=br, dtype=np.float32, device=device)
    halo = max(abs(o) for o in st.offsets)
    x = np.random.default_rng(seed).standard_normal((t, br, a.shape[0] // br))
    xf = torch.from_numpy(x.astype(np.float32)).to(device)
    return st, xf, tspmm.extend_wrap(xf, halo).contiguous(), halo


@pytest.mark.parametrize("br,t", [(3, 1), (3, 8), (3, 12), (3, 40), (3, 5),
                                  (1, 12), (1, 1)])
def test_lane_kernel_matches_plain(cuda_device, br, t):
    """B2a (wrap halos inside) at the LORASC path's widths and the tiled
    kernel's (t = 40, 5, br = 1)."""
    st, x, x_ext, halo = _lane_operands(br, t, seed=t, device=cuda_device)
    before = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
    y = tspmm.stencil_bsr_spmm_t(st, x)
    torch.cuda.synchronize()
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches == before + 1
    ref = tspmm.stencil_scan_accumulate(st.blocks_t, st.offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(st.blocks_t.abs(), st.offsets,
                                          x_ext.abs(), halo)
    assert y.shape == ref.shape == x.shape
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


@pytest.mark.parametrize("t", [1, 12, 20])
def test_lane_ext_kernel_matches_plain(cuda_device, t):
    """B2b on the pre-extended panel."""
    st, _, x_ext, halo = _lane_operands(3, t, seed=50 + t, device=cuda_device)
    before = tspmm.stencil_pallas_bs_ext.launches
    y = tspmm.stencil_pallas_bs_ext(st.blocks_t, st.offsets, x_ext, halo)
    torch.cuda.synchronize()
    assert tspmm.stencil_pallas_bs_ext.launches == before + 1
    ref = tspmm.stencil_scan_accumulate(st.blocks_t, st.offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(st.blocks_t.abs(), st.offsets,
                                          x_ext.abs(), halo)
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_lane_kernels_refuse_what_they_do_not_take(cuda_device):
    """B2a and B2b take f32 or bf16 blocks with an f32 panel, or f64 blocks
    with an f64 panel (``test_b2a_f64_matches_plain``); a mix of f64 and
    f32 raises, as do non-contiguous and CPU panels."""
    st, x, x_ext, halo = _lane_operands(3, 4, seed=0, device=cuda_device)
    st64 = tfmt.StencilBsrTMatrix(st.blocks_t.double(), st.offsets, st.shape)
    with pytest.raises(TypeError):
        tspmm.stencil_bsr_spmm_t_pallas_bs(st64, x)
    with pytest.raises(TypeError):
        tspmm.stencil_bsr_spmm_t_pallas_bs(st, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        tspmm.stencil_bsr_spmm_t_pallas_bs(st, x.transpose(0, 1).contiguous()
                                           .transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.stencil_bsr_spmm_t_pallas_bs(st, x.cpu())
    with pytest.raises(TypeError):
        tspmm.stencil_pallas_bs_ext(st.blocks_t.double(), st.offsets, x_ext, halo)
    with pytest.raises(TypeError):
        tspmm.stencil_pallas_bs_ext(st.blocks_t.to(torch.bfloat16), st.offsets,
                                    x_ext.double(), halo)


def test_small_lorasc_solve_on_the_card_matches_cpu(cuda_device):
    """StencilLorascECG het 8³, f32 with refinement, balancing correction:
    on the card (B2a, B2b) and on the CPU (their plain versions) both reach
    tol; iteration totals within 25 %; B2a launched at least 3× per
    iteration (operator + two sweeps per apply), B2b by the finish."""
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG

    a = elasticity3d(8, 8, 8, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    kw = dict(nparts=8, br=3, grid=(9, 9, 8), max_deflation=64, correction="deflate",
              dtype=np.float32,
              opts=ECGOptions(t=12, tol=1e-5, maxiter=1000, variant="omin", layout="tbn"))
    s_g = StencilLorascECG.build(a, device=cuda_device, **kw)
    la = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
    lb = tspmm.stencil_pallas_bs_ext.launches
    x_g, info_g = s_g.solve(b)
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches - la >= 3 * info_g["iters"]
    assert tspmm.stencil_pallas_bs_ext.launches - lb >= 1
    x_c, info_c = StencilLorascECG.build(a, device="cpu", **kw).solve(b)
    for x in (x_g, x_c):
        assert np.linalg.norm(b - a @ x) < 1e-5 * np.linalg.norm(b)
    assert abs(info_g["iters"] - info_c["iters"]) <= 0.25 * info_c["iters"]


def test_general_solve_on_the_card_matches_cpu(cuda_device):
    """fmt="block_ell" f32 + host-f64 refinement on the card (the kernel)
    and on the CPU (the plain version): both reach tol; iteration totals
    within 25 %."""
    a = elasticity3d(6, 6, 6, heterogeneous=False)
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    kw = dict(fmt="block_ell", precond="bj", block_size=96, dtype=np.float32,
              opts=ECGOptions(t=4, tol=1e-7, maxiter=2000, layout="nt"))
    before = tspmm.block_ell_spmm_pallas.launches
    x_g, info_g = DistributedECG.build(a, device=cuda_device, **kw).solve(b)
    assert tspmm.block_ell_spmm_pallas.launches - before >= info_g["iters"]
    x_c, info_c = DistributedECG.build(a, device="cpu", **kw).solve(b)
    for x in (x_g, x_c):
        assert np.linalg.norm(b - a @ x) < 1e-7 * np.linalg.norm(b)
    assert abs(info_g["iters"] - info_c["iters"]) <= 0.25 * info_c["iters"]


@pytest.mark.parametrize("t", [12, 8, 1, 5])
def test_b3_kernel_matches_plain(cuda_device, t):
    """B3 (the sweep's stencil_t_pallas): B2a's wrap map, its own count."""
    st, x, x_ext, halo = _lane_operands(3, t, seed=70 + t, device=cuda_device)
    before = tspmm.stencil_bsr_spmm_t_pallas.launches
    y = tspmm.stencil_bsr_spmm_t_pallas(st, x)
    torch.cuda.synchronize()
    assert tspmm.stencil_bsr_spmm_t_pallas.launches == before + 1
    ref = tspmm.stencil_scan_accumulate(st.blocks_t, st.offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(st.blocks_t.abs(), st.offsets,
                                          x_ext.abs(), halo)
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


@pytest.mark.parametrize("t", [12, 1, 5])
def test_b4_planar_kernel_matches_plain(cuda_device, t):
    """B4 on a non-symmetric block table (random blocks), so a swapped
    plane/component index shows."""
    offsets, nrb, br = (-9, -1, 0, 1, 9), 300, 3
    rng = np.random.default_rng(80 + t)
    blocks_t = torch.from_numpy(rng.standard_normal(
        (len(offsets), br, br, nrb)).astype(np.float32)).to(cuda_device)
    b3 = tspmm.stencil_blocks_planar(blocks_t).contiguous()
    x2 = torch.from_numpy(rng.standard_normal((t, br * nrb)).astype(
        np.float32)).to(cuda_device)
    before = tspmm.stencil_spmm_planar.launches
    y = tspmm.stencil_spmm_planar(b3, x2, offsets=offsets, br=br, nrb=nrb)
    torch.cuda.synchronize()
    assert tspmm.stencil_spmm_planar.launches == before + 1
    ref = tspmm.stencil_spmm_planar_ref(b3, x2, offsets=offsets, br=br, nrb=nrb)
    scale = tspmm.stencil_spmm_planar_ref(b3.abs(), x2.abs(), offsets=offsets,
                                          br=br, nrb=nrb)
    assert y.shape == ref.shape == x2.shape
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def _dia_table(device):
    """The DIA form of elasticity3d(8³): br = 1, D = 99 diagonals, more
    than the 64 offsets the earlier kernels took."""
    offsets, diags, rem = tfmt.dia_ell_host(elasticity3d(8, 8, 8), min_fill=0.05,
                                            dtype=np.float32)
    assert len(offsets) == 99 and rem is None
    return torch.from_numpy(diags).to(device), offsets, max(abs(o) for o in offsets)


@pytest.mark.parametrize("t", [12, 1])
def test_b1_dia_99_offsets_matches_plain(cuda_device, t):
    diags, offsets, halo = _dia_table(cuda_device)
    x = np.random.default_rng(90 + t).standard_normal((t, diags.shape[1]))
    x_ext = tspmm.extend_wrap(torch.from_numpy(x.astype(np.float32)).to(
        cuda_device), halo).contiguous()
    before = tspmm.stencil_flat_ext.launches
    y = tspmm.stencil_flat_ext(diags, offsets, x_ext, halo, 1)
    torch.cuda.synchronize()
    assert tspmm.stencil_flat_ext.launches == before + 1
    ref = tspmm.stencil_flat_ext_ref(diags, offsets, x_ext, halo, 1)
    scale = tspmm.stencil_flat_ext_ref(diags.abs(), offsets, x_ext.abs(), halo, 1)
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_b2b_dia_99_offsets_matches_plain(cuda_device):
    diags, offsets, halo = _dia_table(cuda_device)
    d_t = diags[:, None, None, :].contiguous()
    x = np.random.default_rng(95).standard_normal((12, 1, diags.shape[1]))
    x_ext = tspmm.extend_wrap(torch.from_numpy(x.astype(np.float32)).to(
        cuda_device), halo).contiguous()
    before = tspmm.stencil_pallas_bs_ext.launches
    y = tspmm.stencil_pallas_bs_ext(d_t, offsets, x_ext, halo)
    torch.cuda.synchronize()
    assert tspmm.stencil_pallas_bs_ext.launches == before + 1
    ref = tspmm.stencil_scan_accumulate(d_t, offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(d_t.abs(), offsets, x_ext.abs(), halo)
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_dia_tbn_solve_on_the_card_matches_cpu(cuda_device):
    """fmt="dia" on lane-major panels, f32 + host-f64 refinement: B1 at
    br = 1 on the card, its plain version on the CPU; both reach tol,
    iteration totals within 25 %."""
    a = elasticity3d(6, 6, 6, heterogeneous=True)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    kw = dict(fmt="dia", precond="bj", block_size=128, dtype=np.float32,
              opts=ECGOptions(t=4, tol=1e-7, maxiter=2000, layout="tbn"))
    before = tspmm.stencil_flat_ext.launches
    s_g = DistributedECG.build(a, device=cuda_device, **kw)
    assert len(s_g.operands.offsets) == 99
    x_g, info_g = s_g.solve(b)
    assert tspmm.stencil_flat_ext.launches - before >= info_g["iters"]
    x_c, info_c = DistributedECG.build(a, device="cpu", **kw).solve(b)
    for x in (x_g, x_c):
        assert np.linalg.norm(b - a @ x) < 1e-7 * np.linalg.norm(b)
    assert abs(info_g["iters"] - info_c["iters"]) <= 0.25 * info_c["iters"]


def test_stencil_kernel_refuses_too_many_offsets(cuda_device):
    """Up to 512 offsets (csr_to_dia_ell's max_diags); 513 raise."""
    nrb = 2048
    offsets = tuple(range(-256, 257))
    blocks = torch.zeros((len(offsets), nrb), device=cuda_device)
    x_ext = torch.zeros((1, nrb + 512), device=cuda_device)
    with pytest.raises(ValueError, match="512"):
        tspmm.stencil_flat_ext(blocks, offsets, x_ext, 256, 1)
    y = tspmm.stencil_flat_ext(blocks[:512], offsets[:512], x_ext, 256, 1)
    torch.cuda.synchronize()
    assert bool((y == 0).all())


def _close(y, ref, scale):
    assert y.shape == ref.shape
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def _fma_flat_ref(blocks_flat, offsets, x_ext, halo, br):
    """B1's sums in its order (offset s, then k), each step fmaf(b, x, acc)
    computed in float64 and rounded to float32."""
    nrb = blocks_flat.shape[1]
    t = x_ext.shape[0] // br
    bd = blocks_flat.double()
    xd = x_ext.double()
    acc = torch.zeros((br, t, nrb), dtype=torch.float32, device=x_ext.device)
    for s, off in enumerate(offsets):
        xs = xd[:, halo + off:halo + off + nrb].reshape(br, t, nrb)
        for k in range(br):
            for m in range(br):
                b = bd[(s * br + m) * br + k][None, :]
                acc[m] = (b * xs[k] + acc[m].double()).float()
    return acc.reshape(br * t, nrb)


@pytest.mark.parametrize("br,t,nel", [(3, 12, (7, 6, 5)), (3, 1, (7, 6, 5)),
                                      (3, 4, (6, 6, 7)), (1, 12, (12, 11, 10)),
                                      (1, 1, (12, 11, 10))])
def test_b1_bitwise_equals_fma_order(cuda_device, br, t, nel):
    a = elasticity3d(*nel) if br == 3 else poisson3d(*nel)
    bf, offs, x_ext, halo = _operands(a, br, t, seed=100 + t, device=cuda_device)
    y = tspmm.stencil_flat_ext(bf, offs, x_ext, halo, br)
    torch.cuda.synchronize()
    assert torch.equal(y, _fma_flat_ref(bf, offs, x_ext, halo, br))


def _random_lane(nrb, offsets, br, t, seed, device):
    rng = np.random.default_rng(seed)
    blocks_t = torch.from_numpy(rng.standard_normal(
        (len(offsets), br, br, nrb)).astype(np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((t, br, nrb)).astype(np.float32)).to(device)
    return tfmt.StencilBsrTMatrix(blocks_t, tuple(offsets), (br * nrb, br * nrb)), x


@pytest.mark.parametrize("nrb", [301, 300, 200, 4099])
@pytest.mark.parametrize("br,t", [(3, 12), (1, 12), (3, 1), (1, 1), (3, 16)])
def test_lane_wrap_edges_match_plain(cuda_device, nrb, br, t):
    """B2a on random blocks: nrb not a multiple of the node tile of 128
    (and odd), offsets at 0, ±1 and ±nrb, ±(nrb-1) in the wrap map (the wrap
    falls inside a tile)."""
    offsets = (-nrb, -(nrb - 1), -1, 0, 1, nrb - 1, nrb)
    st, x = _random_lane(nrb, offsets, br, t, seed=nrb + t, device=cuda_device)
    y = tspmm.stencil_bsr_spmm_t_pallas_bs(st, x)
    torch.cuda.synchronize()
    x_ext = tspmm.extend_wrap(x, nrb)
    ref = tspmm.stencil_scan_accumulate(st.blocks_t, offsets, x_ext, nrb)
    scale = tspmm.stencil_scan_accumulate(st.blocks_t.abs(), offsets, x_ext.abs(), nrb)
    _close(y, ref, scale)


@pytest.mark.parametrize("n_off", [1, 512])
@pytest.mark.parametrize("t", [12, 1])
def test_ext_offset_counts_match_plain(cuda_device, n_off, t):
    """B2b (pre-extended, offsets at ±lead) and B1 with 1 and 512 offsets."""
    nrb, br = 1030, 1
    offsets = (0,) if n_off == 1 else tuple(range(-256, 256))
    lead = max(1, max(abs(o) for o in offsets))
    st, x = _random_lane(nrb, offsets, br, t, seed=n_off + t, device=cuda_device)
    x_ext = tspmm.extend_wrap(x, lead).contiguous()
    y = tspmm.stencil_pallas_bs_ext(st.blocks_t, offsets, x_ext, lead)
    torch.cuda.synchronize()
    ref = tspmm.stencil_scan_accumulate(st.blocks_t, offsets, x_ext, lead)
    scale = tspmm.stencil_scan_accumulate(st.blocks_t.abs(), offsets, x_ext.abs(), lead)
    _close(y, ref, scale)
    bf = st.blocks_t.reshape(n_off, nrb).contiguous()
    xf = x_ext.reshape(t, -1).contiguous()
    y1 = tspmm.stencil_flat_ext(bf, offsets, xf, lead, 1)
    torch.cuda.synchronize()
    assert torch.equal(y1, _fma_flat_ref(bf, offsets, xf, lead, 1))


@pytest.mark.parametrize("t", [4, 16, 256])
def test_wide_panels_match_plain(cuda_device, t):
    """B2a and B3 at t 4 and 16 (whole-width instances with three and one
    offsets prefetched) and 256 (32 chunks of 8 columns in consecutive
    CTAs)."""
    st, x, x_ext, halo = _lane_operands(3, t, seed=200 + t, device=cuda_device)
    ref = tspmm.stencil_scan_accumulate(st.blocks_t, st.offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(st.blocks_t.abs(), st.offsets,
                                          x_ext.abs(), halo)
    for fn in (tspmm.stencil_bsr_spmm_t_pallas_bs, tspmm.stencil_bsr_spmm_t_pallas):
        y = fn(st, x)
        torch.cuda.synchronize()
        _close(y, ref, scale)


def _any_br_product(layout, st, x, offsets, halo):
    """The stencil product of ``st`` on the lane-major panel x (t, br, nrb)
    through one wrapper, returned lane-major; B1 is also held bitwise to
    the fmaf order."""
    t, br, nrb = x.shape
    if layout == "flat":
        bf = tfmt.stencil_blocks_flat(st.blocks_t).contiguous()
        xf = tspmm.extend_wrap(x.transpose(0, 1).reshape(br * t, nrb), halo).contiguous()
        y = tspmm.stencil_flat_ext(bf, offsets, xf, halo, br)
        if y.is_cuda:
            torch.cuda.synchronize()
            assert torch.equal(y, _fma_flat_ref(bf, offsets, xf, halo, br))
        return y.reshape(br, t, nrb).transpose(0, 1)
    if layout == "lane_wrap":
        return tspmm.stencil_bsr_spmm_t_pallas_bs(st, x)
    if layout == "lane_ext":
        return tspmm.stencil_pallas_bs_ext(st.blocks_t, offsets,
                                           tspmm.extend_wrap(x, halo).contiguous(), halo)
    b3 = tspmm.stencil_blocks_planar(st.blocks_t).contiguous()
    y = tspmm.stencil_spmm_planar(b3, x.reshape(t, br * nrb), offsets=offsets,
                                  br=br, nrb=nrb)
    return y.reshape(t, br, nrb)


@pytest.mark.parametrize("t", [12, 5])
@pytest.mark.parametrize("layout", ["flat", "lane_wrap", "lane_ext", "planar"])
def test_any_br_kernel_matches_plain(cuda_device, layout, t):
    """br = 2, which no path builds, takes the generic kernel
    (stencil_any_br) in each of its four maps: B1 (k-major, extended), B2a
    (lane-major, wrap), B2b (lane-major, extended) and B4 (planar); random
    blocks, nrb 301 (not a multiple of the node tile), t 12 (two column
    tiles on grid.y) and 5."""
    offsets, nrb, br, halo = (-9, -1, 0, 1, 9), 301, 2, 9
    st, x = _random_lane(nrb, offsets, br, t, seed=300 + t, device=cuda_device)
    y = _any_br_product(layout, st, x, offsets, halo)
    torch.cuda.synchronize()
    x_ext = tspmm.extend_wrap(x, halo)
    ref = tspmm.stencil_scan_accumulate(st.blocks_t, offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(st.blocks_t.abs(), offsets, x_ext.abs(), halo)
    _close(y, ref, scale)


@pytest.mark.parametrize("t", [12, 5, 1])
@pytest.mark.parametrize("mb,br", [(240, 3), (1000, 1), (1024, 1), (21, 3)])
def test_bj_apply_block_sizes_match_plain(cuda_device, mb, br, t):
    """B6 on random inverses at mb 240 (the bj path's), 1000 (not a
    multiple of 128), 1024 (the DIA path's) and 21 (not a multiple of 4),
    with nonzero z; against the plain version and the GEMM."""
    nb = 5
    rng = np.random.default_rng(mb + t)
    inv = torch.from_numpy(rng.standard_normal((nb, mb, mb)).astype(np.float32)).to(
        cuda_device)
    z = torch.from_numpy(rng.standard_normal((t, br, nb * mb // br)).astype(
        np.float32)).to(cuda_device)
    b2 = tbj.pack_bj_dense(inv)
    before = tbj.bj_apply_pallas.launches
    w = tbj.bj_apply_pallas(b2, z, br)
    torch.cuda.synchronize()
    assert tbj.bj_apply_pallas.launches == before + 1
    assert bool((z != 0).any()) and w.shape == z.shape
    scale = tbj.bj_apply_pallas_ref(b2.abs(), z.abs(), br)
    _close(w, tbj.bj_apply_pallas_ref(b2, z, br), scale)
    _close(w, tbj.bj_apply_flat(inv, z), scale)


def test_bj_apply_wide_panel_matches_plain(cuda_device):
    """t 13: two column chunks of the kernel (12 + 1)."""
    inv_f, z, br = _bj_operands(13, seed=13, device=cuda_device)
    b2 = tbj.pack_bj_dense(inv_f)
    w = tbj.bj_apply_pallas(b2, z, br)
    torch.cuda.synchronize()
    scale = tbj.bj_apply_pallas_ref(b2.abs(), z.abs(), br)
    _close(w, tbj.bj_apply_pallas_ref(b2, z, br), scale)


# --- the plain applies of the rest of the one-GPU driver, on the card -------

def _bj_shape_inverses(device, mbn=80, nb=617, seed=31):
    """Random SPD-like (nb, br, mbn, br, mbn) inverses at the [bj] shape
    (mb 240 rows)."""
    rng = np.random.default_rng(seed)
    mb = 3 * mbn
    g = rng.standard_normal((nb, mb, mb)).astype(np.float32) / np.sqrt(mb)
    inv = (g @ g.transpose(0, 2, 1) + np.eye(mb)).astype(np.float32)
    return torch.from_numpy(inv.reshape(nb, 3, mbn, 3, mbn)).to(device)


@pytest.mark.parametrize("t", [12, 1])
def test_bf16_lane_apply_on_card(cuda_device, t):
    """bj_apply_lane_major with bf16 inverses (one bf16 GEMM with an f32
    result on the card) against its plain version, the f32-upcast GEMM on
    the CPU, at the [bj] shape (nb 617, mb 240): w in f32 on both."""
    inv5 = _bj_shape_inverses(cuda_device).to(torch.bfloat16)
    nrb = 617 * 80
    z = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (t, 3, nrb)).astype(np.float32))
    w = tbj.bj_apply_lane_major(inv5, z.to(cuda_device))
    w_cpu = tbj.bj_apply_lane_major(inv5.cpu(), z)
    assert w.dtype == w_cpu.dtype == torch.float32
    scale = tbj.bj_apply_lane_major(inv5.float().abs().cpu(), z.abs()).max()
    err = float((w.cpu() - w_cpu).abs().max())
    assert err <= KERNEL_TOL * float(scale)


@pytest.mark.parametrize("t", [12, 1])
def test_grouped_apply_on_card(cuda_device, t):
    """bj_apply_grouped on the card against bj_apply_flat on the same
    blocks (every block of a group shares its inverse)."""
    ng, nb = 5, 617
    inv_u = _bj_shape_inverses(cuda_device, nb=ng)
    rng = np.random.default_rng(40 + t)
    gid = rng.integers(0, ng, nb)
    gid[:ng] = np.arange(ng)
    groups = tuple(tuple(int(b) for b in np.flatnonzero(gid == g)) for g in range(ng))
    bg = tbj.block_groups(groups, cuda_device)
    assert bg.order.device.type == "cuda"
    z = torch.from_numpy(rng.standard_normal((t, 3, nb * 80)).astype(
        np.float32)).to(cuda_device)
    w = tbj.bj_apply_grouped(inv_u, bg, z)
    flat = inv_u.reshape(ng, 240, 240)[torch.from_numpy(gid).to(cuda_device)]
    w_f = tbj.bj_apply_flat(flat, z)
    scale = tbj.bj_apply_flat(flat.abs(), z.abs()).max()
    assert float((w - w_f).abs().max()) <= KERNEL_TOL * float(scale)


def test_chebyshev_apply_on_card(cuda_device):
    """The driver's Chebyshev apply (degree 8 over B1) on the card against
    the same build's apply on the CPU."""
    a = elasticity3d(10, 10, 10, heterogeneous=False)
    opts = ECGOptions(t=12, tol=1e-5, layout="tbn")
    kw = dict(fmt="stencil", br=3, precond="chebyshev", dtype=np.float32)
    s_gpu = DistributedECG.build(a, opts=opts, device=cuda_device, **kw)
    s_cpu = DistributedECG.build(a, opts=opts, device="cpu", **kw)
    assert s_gpu.operands.precond_kind == "chebyshev"
    assert s_gpu.operands.cheb.lam_max == s_cpu.operands.cheb.lam_max
    nrb = s_cpu.operands.nrb
    r = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (12, 3, nrb)).astype(np.float32))
    tspmm.stencil_flat_ext.launches = 0
    w = s_gpu.operands.m_apply(r.to(cuda_device)).cpu()
    assert tspmm.stencil_flat_ext.launches == 7
    w_cpu = s_cpu.operands.m_apply(r)
    assert float((w - w_cpu).abs().max()) <= 1e-4 * float(w_cpu.abs().max())


# --- the bf16-block instance of the stencil kernel (B2a, B2b) ---------------


def _bf16_case(st, x, halo):
    """One product on bf16 blocks: the bf16 instance, the f32 instance on the
    widened blocks (bitwise the same sums), the plain version and its
    scale."""
    st16 = tfmt.StencilBsrTMatrix(st.blocks_t.to(torch.bfloat16), st.offsets, st.shape)
    st32 = tfmt.StencilBsrTMatrix(st16.blocks_t.float(), st.offsets, st.shape)
    before = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
    y16 = tspmm.stencil_bsr_spmm_t_pallas_bs(st16, x)
    y32 = tspmm.stencil_bsr_spmm_t_pallas_bs(st32, x)
    torch.cuda.synchronize()
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches == before + 2
    x_ext = tspmm.extend_wrap(x, halo)
    ref = tspmm.stencil_scan_accumulate(st16.blocks_t, st.offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(st32.blocks_t.abs(), st.offsets,
                                          x_ext.abs(), halo)
    assert y16.dtype == torch.float32
    assert torch.equal(y16, y32)
    _close(y16, ref, scale)


@pytest.mark.parametrize("t", [1, 5, 8, 12, 97, 256])
def test_b2a_bf16_blocks_bitwise_f32_instance(cuda_device, t):
    """B2a on bf16 blocks (the LORASC sweeps under a_store="bf16") at the
    whole-width instances (1, 8, 12), the chunked ones (5, 97, 256):
    bitwise equal to the f32 instance on the widened blocks, within
    KERNEL_TOL of the plain version."""
    st, x, _, halo = _lane_operands(3, t, seed=300 + t, device=cuda_device)
    _bf16_case(st, x, halo)


@pytest.mark.parametrize("nrb", [301, 4099])
@pytest.mark.parametrize("t", [12, 1])
def test_b2a_bf16_wrap_edges(cuda_device, nrb, t):
    """bf16 blocks at odd nrb with offsets at 0, ±1, ±(nrb-1) and ±nrb."""
    offsets = (-nrb, -(nrb - 1), -1, 0, 1, nrb - 1, nrb)
    st, x = _random_lane(nrb, offsets, 3, t, seed=nrb + 7 * t, device=cuda_device)
    _bf16_case(st, x, nrb)


@pytest.mark.parametrize("n_off", [1, 512])
@pytest.mark.parametrize("t", [12, 1])
def test_b2b_bf16_offset_counts(cuda_device, n_off, t):
    """B2b (pre-extended) on bf16 blocks with 1 and 512 offsets: bitwise the
    f32 instance on the widened blocks, within KERNEL_TOL of the plain
    version."""
    nrb = 1031
    offsets = (0,) if n_off == 1 else tuple(range(-256, 256))
    lead = max(1, max(abs(o) for o in offsets))
    st, x = _random_lane(nrb, offsets, 1, t, seed=n_off + 3 * t, device=cuda_device)
    b16 = st.blocks_t.to(torch.bfloat16)
    x_ext = tspmm.extend_wrap(x, lead).contiguous()
    before = tspmm.stencil_pallas_bs_ext.launches
    y16 = tspmm.stencil_pallas_bs_ext(b16, offsets, x_ext, lead)
    y32 = tspmm.stencil_pallas_bs_ext(b16.float(), offsets, x_ext, lead)
    torch.cuda.synchronize()
    assert tspmm.stencil_pallas_bs_ext.launches == before + 2
    assert torch.equal(y16, y32)
    ref = tspmm.stencil_scan_accumulate(b16, offsets, x_ext, lead)
    scale = tspmm.stencil_scan_accumulate(b16.float().abs(), offsets, x_ext.abs(), lead)
    _close(y16, ref, scale)


def test_b2b_bf16_lorasc_finish_shape(cuda_device):
    """B2b at t 1 on the elasticity stencil's bf16 table."""
    st, _, x_ext, halo = _lane_operands(3, 1, seed=77, device=cuda_device)
    b16 = st.blocks_t.to(torch.bfloat16)
    y16 = tspmm.stencil_pallas_bs_ext(b16, st.offsets, x_ext, halo)
    y32 = tspmm.stencil_pallas_bs_ext(b16.float(), st.offsets, x_ext, halo)
    torch.cuda.synchronize()
    assert torch.equal(y16, y32)
    ref = tspmm.stencil_scan_accumulate(b16, st.offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(b16.float().abs(), st.offsets, x_ext.abs(), halo)
    _close(y16, ref, scale)


# --- the f64 instance of the stencil kernel (B2a, B2b) ---------------------

F64_TOL = 1e-13     # max |y_kernel − y_plain| ≤ F64_TOL · max(|B|·|x|)


def _lane_operands_f64(t, seed, device):
    a = elasticity3d(7, 6, 5)
    st = tfmt.csr_to_stencil_bsr_t(a, br=3, dtype=np.float64, device=device)
    halo = max(abs(o) for o in st.offsets)
    x = np.random.default_rng(seed).standard_normal((t, 3, a.shape[0] // 3))
    xd = torch.from_numpy(x).to(device)
    return st, xd, tspmm.extend_wrap(xd, halo).contiguous(), halo


def _close_f64(y, st_blocks, offsets, x_ext, halo):
    ref = tspmm.stencil_scan_accumulate(st_blocks, offsets, x_ext, halo)
    scale = tspmm.stencil_scan_accumulate(st_blocks.abs(), offsets, x_ext.abs(), halo)
    assert y.dtype == torch.float64 and y.shape == ref.shape
    assert float((y - ref).abs().max()) <= F64_TOL * float(scale.max())


@pytest.mark.parametrize("t", [1, 4, 12, 16, 97, 256])
def test_b2a_f64_matches_plain(cuda_device, t):
    """B2a's f64 instance (f64 blocks, panel, sums and output) at the
    whole-width instances (1, 4, 12, 16) and the chunked one (the f64
    LORASC build's lift width 97 and Lanczos panel 256) against the plain
    f64 version: within 1e-13 of max(|B|·|x|)."""
    st, x, x_ext, halo = _lane_operands_f64(t, seed=900 + t, device=cuda_device)
    before = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
    before64 = tspmm.stencil_bsr_spmm_t_pallas_bs.f64_launches
    y = tspmm.stencil_bsr_spmm_t(st, x)
    torch.cuda.synchronize()
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches == before + 1
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.f64_launches == before64 + 1
    _close_f64(y, st.blocks_t, st.offsets, x_ext, halo)


@pytest.mark.parametrize("t", [1, 12])
def test_b2b_f64_matches_plain(cuda_device, t):
    """B2b's f64 instance on the pre-extended panel (t 1, the LORASC finish's
    width; t 12, the halo-overlap shard product's)."""
    st, _, x_ext, halo = _lane_operands_f64(t, seed=950 + t, device=cuda_device)
    before64 = tspmm.stencil_pallas_bs_ext.f64_launches
    y = tspmm.stencil_pallas_bs_ext(st.blocks_t, st.offsets, x_ext, halo)
    torch.cuda.synchronize()
    assert tspmm.stencil_pallas_bs_ext.f64_launches == before64 + 1
    _close_f64(y, st.blocks_t, st.offsets, x_ext, halo)


@pytest.mark.parametrize("nrb", [301, 4099])
@pytest.mark.parametrize("br,t", [(3, 12), (1, 12), (3, 1), (2, 5)])
def test_b2a_f64_wrap_edges(cuda_device, nrb, br, t):
    """The f64 instance at odd nrb with offsets at 0, ±1, ±(nrb-1) and ±nrb,
    br 1 and br 2 (the generic kernel) among them."""
    offsets = (-nrb, -(nrb - 1), -1, 0, 1, nrb - 1, nrb)
    st, x = _random_lane(nrb, offsets, br, t, seed=nrb + 11 * t, device=cuda_device)
    st = tfmt.StencilBsrTMatrix(st.blocks_t.double(), offsets, st.shape)
    x = x.double()
    y = tspmm.stencil_bsr_spmm_t_pallas_bs(st, x)
    torch.cuda.synchronize()
    _close_f64(y, st.blocks_t, offsets, tspmm.extend_wrap(x, nrb), nrb)


def _fma_lane_ref(blocks_t, offsets, x_ext, halo):
    """The lane-major kernel's f32 sums in its order (offset s, then k),
    each step fmaf(b, x, acc) computed in float64 and rounded to float32."""
    _, br, _, nrb = blocks_t.shape
    bd, xd = blocks_t.double(), x_ext.double()
    acc = torch.zeros((x_ext.shape[0], br, nrb), dtype=torch.float32,
                      device=x_ext.device)
    for s, off in enumerate(offsets):
        xs = xd[:, :, halo + off:halo + off + nrb]
        for k in range(br):
            for m in range(br):
                acc[:, m] = (bd[s, m, k][None, :] * xs[:, k] + acc[:, m].double()).float()
    return acc


@pytest.mark.parametrize("t", [1, 4, 8, 12, 16, 97])
def test_b2a_f32_bitwise_equals_fma_order(cuda_device, t):
    """The f32 instance of the lane-major maps (B2a wrap, B2b pre-extended)
    sums in fmaf order s, then k, bitwise, beside the f64 instance in the
    same body: with the bf16 instance bitwise the f32 one on the widened
    blocks (``test_b2a_bf16_blocks_bitwise_f32_instance``), the f32 and
    bf16 results are those of the body before the f64 instance."""
    st, x, x_ext, halo = _lane_operands(3, t, seed=700 + t, device=cuda_device)
    ref = _fma_lane_ref(st.blocks_t, st.offsets, x_ext, halo)
    y_a = tspmm.stencil_bsr_spmm_t_pallas_bs(st, x)
    y_b = tspmm.stencil_pallas_bs_ext(st.blocks_t, st.offsets, x_ext, halo)
    torch.cuda.synchronize()
    assert torch.equal(y_a, ref) and torch.equal(y_b, ref)


def test_flat_and_planar_refuse_f64(cuda_device):
    """B1 and B4 stay f32: no port path sends them f64 tables (ROADMAP.md
    queue B)."""
    bf, offs, x_ext, halo = _operands(elasticity3d(5, 5, 4), 3, 2, seed=0,
                                      device=cuda_device)
    with pytest.raises(TypeError):
        tspmm.stencil_flat_ext(bf.double(), offs, x_ext.double(), halo, 3)
    st, x, _, _ = _lane_operands(3, 4, seed=1, device=cuda_device)
    b3 = tspmm.stencil_blocks_planar(st.blocks_t).contiguous()
    nrb = st.blocks_t.shape[3]
    with pytest.raises(TypeError):
        tspmm.stencil_spmm_planar(b3.double(), x.reshape(4, -1).double(),
                                  offsets=st.offsets, br=3, nrb=nrb)


def test_flat_and_planar_refuse_bf16_blocks(cuda_device):
    """No port path builds flat or planar bf16 tables, or sends bf16 blocks
    through B3 (ROADMAP.md queue B)."""
    bf, offs, x_ext, halo = _operands(elasticity3d(5, 5, 4), 3, 2, seed=0,
                                      device=cuda_device)
    with pytest.raises(TypeError, match="queue B"):
        tspmm.stencil_flat_ext(bf.to(torch.bfloat16), offs, x_ext, halo, 3)
    st, x, _, _ = _lane_operands(3, 2, seed=0, device=cuda_device)
    b3 = tspmm.stencil_blocks_planar(st.blocks_t).contiguous().to(torch.bfloat16)
    nrb = st.blocks_t.shape[3]
    with pytest.raises(TypeError, match="queue B"):
        tspmm.stencil_spmm_planar(b3, x.reshape(2, -1), offsets=st.offsets, br=3,
                                  nrb=nrb)
    st16 = tfmt.StencilBsrTMatrix(st.blocks_t.to(torch.bfloat16), st.offsets, st.shape)
    launches = tspmm.stencil_bsr_spmm_t_pallas.launches
    with pytest.raises(TypeError, match="queue B"):
        tspmm.stencil_bsr_spmm_t_pallas(st16, x)
    assert tspmm.stencil_bsr_spmm_t_pallas.launches == launches


def test_bf16_factor_banded_solve_on_card(cuda_device):
    """The banded solve with bf16 factors and f32 vectors on the card
    against the same solve on the CPU: f32 sums (cuBLAS GEMMs against the
    CPU's), within 1e-5 relative."""
    from prealps_tpu_torch.direct.banded import (
        BlockBandedCholesky,
        block_banded_cholesky,
        block_banded_solve_t,
    )

    rng = np.random.default_rng(12)
    P, nblk, bs, t = 3, 5, 48, 12
    d = rng.standard_normal((P, nblk, bs, bs)) * 0.1
    d = d @ np.swapaxes(d, -1, -2) + 4 * np.eye(bs)
    e = rng.standard_normal((P, nblk, bs, bs)) * 0.1
    fac = block_banded_cholesky(torch.from_numpy(d).float(), torch.from_numpy(e).float())
    fac16 = BlockBandedCholesky(fac.l_inv.to(torch.bfloat16),
                                fac.m_off.to(torch.bfloat16), fac.failed)
    v = torch.from_numpy(rng.standard_normal((nblk, P, t, bs)).astype(np.float32))
    w_cpu = block_banded_solve_t(fac16, v)
    fac_g = BlockBandedCholesky(fac16.l_inv.to(cuda_device), fac16.m_off.to(cuda_device),
                                fac16.failed.to(cuda_device))
    w_gpu = block_banded_solve_t(fac_g, v.to(cuda_device))
    assert w_gpu.dtype == torch.float32 and fac_g.l_inv.dtype == torch.bfloat16
    err = float((w_gpu.cpu() - w_cpu).abs().max())
    assert err <= 1e-5 * float(w_cpu.abs().max())


@pytest.mark.parametrize("pencil", ["sloc", "saloc"])
def test_sloc_assembly_on_card_matches_cpu(cuda_device, pencil):
    """The PRESC operands of het elasticity3d 8³ (4 parts, f32) built on the
    card and on the CPU: Sloc / Aloc within 1e-5 relative, the owned-dof
    map equal."""
    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.precond.lorasc_scale import build_scalable_lorasc

    a_s = sym_rac_scaling(elasticity3d(8, 8, 8, heterogeneous=True))[0]
    kw = dict(nparts=4, br=3, grid=(9, 9, 8), dtype=np.float32, pencil=pencil,
              max_deflation=24, correction="deflate")
    ops_g = build_scalable_lorasc(a_s, device=cuda_device, **kw).operands
    ops_c = build_scalable_lorasc(a_s, device="cpu", **kw).operands
    assert torch.equal(ops_g["own_dof"].cpu(), ops_c["own_dof"])
    s_g, s_c = ops_g["sloc"].cpu(), ops_c["sloc"]
    assert float((s_g - s_c).abs().max()) <= 1e-5 * float(s_c.abs().max())


# (nparts, t, max_deflation of the sloc solve, of the a_store="bf16" solve):
# tests/test_presc.py's SSLOC nev (48) and tests/test_lorasc_scale.py's
# a_store nev (24) at 4 parts, t 4; the configuration of
# test_small_lorasc_solve_on_the_card_matches_cpu at 8 parts, t 12. At
# 4 parts SSLOC with nev 24 deflates no pair, in the JAX package too, and
# its f32 solve breaks down or not with the rounding, JAX's on the CPU
# included (ROADMAP.md queue C; prealps_tpu_torch/examples/presc_history.py).
PRESC_CARD_CASES = {"4parts_t4": (4, 4, 48, 24), "8parts_t12": (8, 12, 64, 64)}


@pytest.mark.parametrize("case", sorted(PRESC_CARD_CASES))
def test_presc_and_bf16_store_solves_on_card(cuda_device, case):
    """StencilLorascECG het 8³ on the card with pencil="sloc" and bf16
    factors, and with a_store="bf16" and bf16 factors: no breakdown, host
    relres below 1e-5 on the card and on the CPU, the same deflated pairs,
    iteration totals within max(2, 10 %) (chip_smoke's band); B2a launched
    at least 3× an iteration, its bf16 instance (a_store="bf16") at least
    twice."""
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG

    nparts, t, md_sloc, md_store = PRESC_CARD_CASES[case]
    a = elasticity3d(8, 8, 8, heterogeneous=True)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    kw = dict(nparts=nparts, br=3, grid=(9, 9, 8), correction="deflate",
              dtype=np.float32, factor_store="bf16",
              opts=ECGOptions(t=t, tol=1e-5, maxiter=1000, variant="omin", layout="tbn"))
    for extra in (dict(pencil="sloc", max_deflation=md_sloc),
                  dict(a_store="bf16", max_deflation=md_store)):
        s = StencilLorascECG.build(a, device=cuda_device, **kw, **extra)
        assert s.precond.operands["aii_linv"].dtype == torch.bfloat16
        la = tspmm.stencil_bsr_spmm_t_pallas_bs.launches
        l16 = tspmm.stencil_bsr_spmm_t_pallas_bs.bf16_launches
        x_g, info_g = s.solve(b)
        assert tspmm.stencil_bsr_spmm_t_pallas_bs.launches - la >= 3 * info_g["iters"]
        if "a_store" in extra:
            assert (tspmm.stencil_bsr_spmm_t_pallas_bs.bf16_launches - l16
                    >= 2 * info_g["iters"])
        s_c = StencilLorascECG.build(a, device="cpu", **kw, **extra)
        x_c, info_c = s_c.solve(b)
        assert s.precond.deflated == s_c.precond.deflated > 0
        for x, info in ((x_g, info_g), (x_c, info_c)):
            assert not info["breakdown"]
            assert np.linalg.norm(b - a @ x) < 1e-5 * np.linalg.norm(b)
        assert abs(info_g["iters"] - info_c["iters"]) <= max(2, 0.1 * info_c["iters"]), (
            extra, info_g["iters"], info_c["iters"])


# --- the sharded driver on the card: ranks that share cuda:0 through gloo ---


def _spawn_on_card(fn, world, args, tmp_path):
    """``world`` ranks of ``fn`` (a ``torch_shard_workers`` function) in one
    gloo group, their rendezvous a FileStore under ``tmp_path``."""
    from prealps_tpu_torch.parallel import mesh

    tmp_path.mkdir(parents=True, exist_ok=True)
    return mesh.spawn(fn, world, args=args, init_method=f"file://{tmp_path}/store",
                      timeout=300, threads=2)


def test_extend_ring_on_card_matches_global_wrap(cuda_device, tmp_path):
    """2 gloo ranks on one card (both neighbours the same peer): the ring
    halo, and the all-gather branch of a shard thinner than its halo,
    bitwise the wrap of the global panel, and on the card."""
    import torch_shard_workers as w

    out = _spawn_on_card(w.card_ring, 2, (100, (1, 37, 100, 150)), tmp_path)
    for r in out:
        assert r == {h: ("cuda", True) for h in (1, 37, 100, 150)}


def test_b1_at_the_sharded_headline_shape_matches_plain(cuda_device):
    """B1 at a 4-rank headline shard's shape: 27 offsets of the 37 × 37
    node planes (halo 1,407), 12,400 nodes a shard, t 12 (the table of
    elasticity3d(36,36,9), zero-padded to the shard's nodes)."""
    st = tfmt.csr_to_stencil_bsr_t(elasticity3d(36, 36, 9), br=3,
                                   dtype=np.float32, device=cuda_device)
    halo = max(abs(o) for o in st.offsets)
    assert halo == 1407 and len(st.offsets) == 27
    bf = torch.nn.functional.pad(tfmt.stencil_blocks_flat(st.blocks_t),
                                 (0, 12400 - st.blocks_t.shape[-1])).contiguous()
    x = np.random.default_rng(8).standard_normal((36, 12400 + 2 * halo))
    x_ext = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    y = tspmm.stencil_flat_ext(bf, st.offsets, x_ext, halo, 3)
    ref = tspmm.stencil_flat_ext_ref(bf, st.offsets, x_ext, halo, 3)
    scale = tspmm.stencil_flat_ext_ref(bf.abs(), st.offsets, x_ext.abs(), halo, 3)
    assert y.shape == (36, 12400)
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_sharded_solve_on_card_matches_cpu(cuda_device, tmp_path):
    """The stencil bj2l path at 2 ranks sharing the card (f32, device
    double-float rounds to 1e-7) and the same 2-rank solve on the CPU
    (plain SpMM): both converge, every rank has the same x, B1 launched at
    least once an iteration on every rank of the card, and the iteration
    totals within 25 %, as the one-shard card test holds them."""
    import torch_shard_workers as w

    a = elasticity3d(6, 6, 6, heterogeneous=False)
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    case = dict(fmt="stencil", br=3, precond="bj2l", block_size=24,
                grid=(7, 7, 6), dtype=np.float32,
                opts=dict(t=4, tol=1e-7, maxiter=2000, layout="tbn"))
    card = _spawn_on_card(w.card_solve, 2, (a, b, case, "cuda:0"), tmp_path / "g")
    cpu = _spawn_on_card(w.card_solve, 2, (a, b, case, "cpu"), tmp_path / "c")
    for out in (card, cpu):
        np.testing.assert_array_equal(out[1][0], out[0][0])
        assert np.linalg.norm(b - a @ out[0][0]) < 1e-7 * np.linalg.norm(b)
    iters_g, iters_c = card[0][1]["iters"], cpu[0][1]["iters"]
    assert all(r[2] >= iters_g for r in card)
    assert abs(iters_g - iters_c) <= 0.25 * iters_c


def test_b5_on_a_shard_halo_block_space_matches_plain(cuda_device):
    """B5 on rank 1's rows of a 4-shard block-ELL build: block columns in
    [own blocks ∥ halo buffer] coordinates, the X panel 128-row blocks of
    its own rows and of the padded halo buffer (driver._block_ell_shard)."""
    from prealps_tpu_torch.core.layout import build_row_layout
    from prealps_tpu_torch.parallel.driver import _block_ell_shard

    a = elasticity3d(10, 10, 10)
    lay = build_row_layout(a, 4, row_multiple=128)
    mat, send_idx = _block_ell_shard(permute_and_pad_matrix(a, lay), lay, 1, 128,
                                     np.float32, cuda_device)
    mat.entries = tfmt.pack_block_ell_entries(mat)
    mpl = lay.rows_per_shard
    assert mat.shape == (mpl, mpl + send_idx.numel() * 128) and mat.bk == 128
    assert int(mat.blkcols.max()) >= mpl // 128     # halo blocks referenced
    assert int(mat.entries.cols.max()) >= mpl       # halo columns referenced
    for t in (12, 1, 5, 4, 16):
        x = torch.from_numpy(np.random.default_rng(t).standard_normal(
            (mat.shape[1], t)).astype(np.float32)).to(cuda_device)
        before = tspmm.block_ell_spmm_pallas.launches
        y = tspmm.block_ell_spmm_pallas(mat, x)
        torch.cuda.synchronize()
        assert tspmm.block_ell_spmm_pallas.launches == before + 1
        ref = tspmm.block_ell_spmm(mat, x)
        scale = tspmm.block_ell_spmm(tfmt.BlockEllMatrix(mat.blocks.abs(), mat.blkcols,
                                                         mat.shape), x.abs())
        assert y.shape == (mpl, t)
        assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


def test_sharded_block_ell_solve_on_card_matches_cpu(cuda_device, tmp_path):
    """fmt="block_ell" over 2 ranks sharing the card (B5 on each shard's
    [own ∥ halo] blocks, f32, host-f64 rounds to 1e-7) and the same 2-rank
    solve on the CPU (B5's plain version): both converge, every rank has
    the same x, B5 launched at least once an iteration on every rank of
    the card, and the iteration totals within 25 %."""
    import torch_shard_workers as w

    a = elasticity3d(8, 8, 8)
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    case = dict(fmt="block_ell", precond="bj", block_size=240, dtype=np.float32,
                opts=dict(t=4, tol=1e-7, maxiter=2000, layout="nt"))
    args = (a, b, case)
    card = _spawn_on_card(w.card_solve, 2, (*args, "cuda:0", "block_ell_spmm_pallas"),
                          tmp_path / "g")
    cpu = _spawn_on_card(w.card_solve, 2, (*args, "cpu", "block_ell_spmm_pallas"),
                         tmp_path / "c")
    for out in (card, cpu):
        np.testing.assert_array_equal(out[1][0], out[0][0])
        assert np.linalg.norm(b - a @ out[0][0]) < 1e-7 * np.linalg.norm(b)
    iters_g, iters_c = card[0][1]["iters"], cpu[0][1]["iters"]
    assert all(r[2] >= iters_g for r in card) and cpu[0][2] == 0
    assert abs(iters_g - iters_c) <= 0.25 * iters_c


def test_concurrent_kernel_builds(cuda_device, tmp_path):
    """Two processes that start from one empty build directory at once
    both load all three kernels; each source is compiled by one of them
    (the other waits on the lock and finds it built)."""
    import torch_shard_workers as w

    from prealps_tpu_torch.ops import _kernels

    out = _spawn_on_card(w.card_build, 2, (str(tmp_path / "build"),), tmp_path)
    for libs, _ in out:
        assert libs == sorted(_kernels.SOURCES)
    for src in _kernels.SOURCES:
        assert sum(src not in cached for _, cached in out) == 1


@pytest.mark.parametrize("t", [12, 1])
def test_b1_offsets_wider_than_the_shard(cuda_device, t):
    """A shard thinner than the stencil halo (8 ranks of elasticity3d(8³):
    88 nodes against offsets up to 91) on its extended panel: the kernel
    takes offsets wider than its node count (only |off| <= halo matters
    on an extended panel) and matches its plain version."""
    st = tfmt.csr_to_stencil_bsr_t(elasticity3d(8, 8, 8), br=3,
                                   dtype=np.float32, device=cuda_device)
    halo = max(abs(o) for o in st.offsets)
    nrb = 88
    assert halo == 91 > nrb
    bf = tfmt.stencil_blocks_flat(st.blocks_t)[:, 88:176].contiguous()
    x = np.random.default_rng(t).standard_normal((3 * t, nrb + 2 * halo))
    x_ext = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    y = tspmm.stencil_flat_ext(bf, st.offsets, x_ext, halo, 3)
    ref = tspmm.stencil_flat_ext_ref(bf, st.offsets, x_ext, halo, 3)
    scale = tspmm.stencil_flat_ext_ref(bf.abs(), st.offsets, x_ext.abs(), halo, 3)
    assert bool(((y - ref).abs() <= KERNEL_TOL * scale + 1e-30).all())


# --- the distributed LORASC on the card: ranks that share cuda:0 ---------


def test_two_level_banded_solve_on_card_matches_cpu(cuda_device, tmp_path):
    """The two-level banded solve (f64), each of 2 ranks on the card
    holding half the rows of every factor block, against the same 2-rank
    solve on the CPU: 1e-12 relative, the same bits on both ranks."""
    import torch_shard_workers as w

    rng = np.random.default_rng(0)
    e = 0.3 * rng.standard_normal((2, 5, 12, 12))
    e[:, 0] = 0.0
    g = rng.standard_normal((2, 5, 12, 12))
    d = np.einsum("pnij,pnkj->pnik", g, g) / 12 + 4.0 * np.eye(12)
    v = rng.standard_normal((2, 5, 12, 3))
    card = _spawn_on_card(w.banded_two_level, 2, (d, e, v, "cuda:0"), tmp_path / "g")
    cpu = _spawn_on_card(w.banded_two_level, 2, (d, e, v, "cpu"), tmp_path / "c")
    np.testing.assert_array_equal(card[1][0], card[0][0])
    want = cpu[0][0]
    assert np.abs(card[0][0] - want).max() <= 1e-12 * np.abs(want).max()


def test_distributed_lorasc_on_card_matches_cpu(cuda_device, tmp_path):
    """DistributedLorascECG over 4 ranks sharing the card (gloo), f64
    elasticity3d(6,5,5) with Lanczos deflation and the balancing lift,
    against the same 4-rank build and solve on the CPU: iterations ±1, the
    same deflated pairs, x within 1e-8 relative and bitwise the same on
    every rank."""
    import torch_shard_workers as w

    a = elasticity3d(6, 5, 5)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    case = dict(nshards=4, dtype=np.float64, exact_schur=False, correction="deflate",
                opts=dict(t=4, tol=1e-8, maxiter=600, variant="omin"))
    card = _spawn_on_card(w.card_lorasc_solve, 4, (a, b, case, "cuda:0"), tmp_path / "g")
    cpu = _spawn_on_card(w.card_lorasc_solve, 4, (a, b, case, "cpu"), tmp_path / "c")
    for out, kind in ((card, "cuda"), (cpu, "cpu")):
        for r in out:
            np.testing.assert_array_equal(r[0], out[0][0])
            assert r[2] == kind
    (x_g, info_g, _), (x_c, info_c, _) = card[0], cpu[0]
    assert info_g["deflated"] == info_c["deflated"] > 0
    assert not info_g["breakdown"]
    assert abs(info_g["iters"] - info_c["iters"]) <= 1
    assert np.linalg.norm(x_g - x_c) <= 1e-8 * np.linalg.norm(x_c)


# --- the general-matrix single-device API (api.ECGSolver) on the card ------

API_CASES = {"block_jacobi": ("block_jacobi", dict(nblocks=8)),
             "lorasc": ("lorasc", dict(nparts=4)), "presc": ("presc", dict(nparts=4)),
             "presc_banded": ("presc", dict(nparts=4, schur_method="banded"))}


@pytest.mark.parametrize("case", sorted(API_CASES))
def test_ecg_solver_on_card_matches_cpu(cuda_device, case):
    """f64 ECGSolver on the card against the CPU port: iterations ±1, x
    within 1e-8; every operand of the solve on the card."""
    from prealps_tpu_torch.api import ECGSolver

    a = elasticity3d(6, 5, 5)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    precond, kw = API_CASES[case]
    opts = ECGOptions(t=4, tol=1e-8, maxiter=3000)
    on_card = ECGSolver.build(a, opts=opts, precond=precond, device=cuda_device, **kw)
    ops = on_card.operands()
    assert ops and all(t.device.type == "cuda" for t in ops.values()), \
        [k for k, t in ops.items() if t.device.type != "cuda"]
    x, info = on_card.solve(b)
    x_c, info_c = ECGSolver.build(a, opts=opts, precond=precond, device="cpu",
                                  **kw).solve(b)
    assert abs(info["iters"] - info_c["iters"]) <= 1
    assert np.abs(x - x_c).max() <= 1e-8 * np.abs(x_c).max()


def test_ecg_solver_f32_on_card_refines(cuda_device):
    from prealps_tpu_torch.api import ECGSolver

    a = elasticity3d(6, 5, 5)
    b = np.random.default_rng(3).standard_normal(a.shape[0])
    s = ECGSolver.build(a, opts=ECGOptions(t=4, tol=1e-8, maxiter=3000),
                        precond="lorasc", nparts=4, dtype=np.float32, device=cuda_device)
    assert all(t.device.type == "cuda" for t in s.operands().values())
    assert s.precond.e_mat.dtype == torch.float32
    x, info = s.solve(b)
    assert info["refine_rounds"] >= 1 and not info["breakdown"]
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) < 1e-6


def test_ecg_solver_raises_without_a_card(cuda_device, monkeypatch):
    from prealps_tpu_torch.api import ECGSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ECGSolver.build(elasticity3d(3, 3, 3), device="cuda")


def test_native_library_on_the_card_machine(cuda_device):
    from prealps_tpu_torch import native
    from prealps_tpu_torch.core import partition

    assert native.available(), native.build_info
    part = partition.kway_partition(elasticity3d(6, 5, 5), 4)
    assert sorted(set(part.tolist())) == [0, 1, 2, 3]


# --- the communication-avoiding tier (ops/tsqr, cholqr, tournament, spmsv) ---

def _lx_panel(m, t, seed, device, dtype=torch.float64):
    x = np.random.default_rng(seed).standard_normal((m, t))
    return torch.from_numpy(x).to(device, dtype)


def test_tsqr_and_cholqr_on_card_match_cpu(cuda_device):
    """f64 on cuSOLVER against the CPU's LAPACK: R, Q and the CholQR
    factors within 1e-10; the f32 TSQR orthonormal to f32 rounding."""
    from prealps_tpu_torch.ops import cholqr as tc
    from prealps_tpu_torch.ops import tsqr as tq

    x = _lx_panel(3000, 12, 0, "cpu")
    xc = x.to(cuda_device)
    np.testing.assert_allclose(tq.tsqr_r(xc).cpu().numpy(), tq.tsqr_r(x).numpy(),
                               rtol=1e-10, atol=1e-10)
    for got, want in zip(tq.tsqr(xc), tq.tsqr(x)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10)
    for got, want in zip(tc.cholqr2(xc), tc.cholqr2(x)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-10)
    a = torch.from_numpy(elasticity3d(5, 4, 4).toarray())
    p = _lx_panel(a.shape[0], 6, 1, "cpu")
    got = tc.a_cholqr(p.to(cuda_device), (a @ p).to(cuda_device))
    for g, w in zip(got, tc.a_cholqr(p, a @ p)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-9, atol=1e-10)
    q, _ = tq.tsqr(xc.float())
    eye = torch.eye(12, device=cuda_device)
    assert float((q.T @ q - eye).abs().max()) < 1e-5


def test_tournament_on_card_matches_cpu(cuda_device):
    """The same selections on the card and the host (f64), and TP-QR /
    TP-CUR approximations as good; the f32 panel's pivoting runs in f64 on
    the card too."""
    from prealps_tpu_torch.ops import tournament as tt

    rng = np.random.default_rng(42)
    a = rng.standard_normal((300, 10)) @ rng.standard_normal((10, 60))
    a += 1e-6 * rng.standard_normal(a.shape)
    ah = torch.from_numpy(a)
    ac = ah.to(cuda_device)
    assert tt.tournament_select(ac, 10).tolist() == tt.tournament_select(ah, 10).tolist()
    q, r, cols = tt.tp_qr(ac, 10)
    assert cols.tolist() == tt.tp_qr(ah, 10)[2].tolist()
    assert float(torch.linalg.norm(q @ r - ac) / torch.linalg.norm(ac)) < 1e-4
    c, u, rr, cols, rows = tt.tp_cur(ac, 10)
    ch = tt.tp_cur(ah, 10)
    assert cols.tolist() == ch[3].tolist() and rows.tolist() == ch[4].tolist()
    assert float(torch.linalg.norm(c @ u @ rr - ac) / torch.linalg.norm(ac)) < 1e-4
    sel32 = tt.tournament_select(ac.float(), 10)
    assert len(set(sel32.tolist())) == 10


def test_spmsv_packed_on_card_matches_cpu_without_a_sync(cuda_device):
    """spmsv_packed in f32 on the card against the CPU, and its device part
    issues no synchronising operation (chip_smoke times it by device
    time)."""
    from prealps_tpu_torch.ops import spmsv as ts

    a = elasticity3d(6, 6, 6, heterogeneous=False)
    bs = 32
    ab_h = tfmt.csr_to_block_ell(a, bm=bs, bk=bs, dtype=np.float32)
    ab_c = tfmt.csr_to_block_ell(a, bm=bs, bk=bs, dtype=np.float32, device=cuda_device)
    nb = ab_h.blocks.shape[0]
    g = ts.block_support_graph(a, np.minimum(np.arange(nb + 1) * bs, a.shape[0]))
    active = np.array([1, 4, 9])
    b = _lx_panel(nb * bs, 12, 3, "cpu", torch.float32)
    out = {}
    for name, ab, dev in (("cpu", ab_h, "cpu"), ("cuda", ab_c, cuda_device)):
        ids, vals = ts.pack_multivector(b.to(dev), bs, active, cap=5)
        c_ids = ts.predict_c_support(g, active, nb)
        c_ids_d, c_vals = ts.spmsv_packed(ab, ids, vals, c_ids, len(c_ids) + 2)
        out[name] = ts.unpack_multivector(c_ids_d, c_vals, nb).cpu()
        if name == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode(2)
            try:
                ts.spmsv_packed_device(ab, ids, vals, c_ids_d)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= KERNEL_TOL * scale


def test_spmsv_chain_through_b5_matches_plain(cuda_device):
    """The dense-carrier s-step chain with B5 as A's product against the
    same chain through block_ell_spmm: one launch a step, the supports
    equal, every panel within KERNEL_TOL of |A|·|x|."""
    from prealps_tpu_torch.ops import spmsv as ts

    a = elasticity3d(8, 8, 8, heterogeneous=False)
    n = a.shape[0]
    mat = tfmt.csr_to_block_ell(a, bm=8, bk=128, dtype=np.float32, device=cuda_device)
    mat.entries = tfmt.pack_block_ell_entries(mat)
    absmat = tfmt.BlockEllMatrix(mat.blocks.abs(), mat.blkcols, mat.shape)
    pad = mat.shape[1] - n

    def product(fn, m):
        return lambda x: fn(m, torch.cat([x, x.new_zeros((pad, x.shape[1]))]))[:n]

    offsets = np.linspace(0, n, 17).astype(np.int64)
    g = ts.block_support_graph(a, offsets)
    s0 = np.zeros(16, dtype=bool)
    s0[:2] = True
    b = _lx_panel(n, 12, 4, cuda_device, torch.float32)
    before = tspmm.block_ell_spmm_pallas.launches
    pk, sk = ts.spmsv_chain(product(tspmm.block_ell_spmm_pallas, mat), b, s0, g,
                            offsets, 5)
    assert tspmm.block_ell_spmm_pallas.launches == before + 5
    pp, sp_ = ts.spmsv_chain(product(tspmm.block_ell_spmm, mat), b, s0, g, offsets, 5)
    prev = b.clone()
    prev[offsets[2]:] = 0
    for j in range(1, 6):
        assert np.array_equal(sk[j], sp_[j])
        scale = product(tspmm.block_ell_spmm, absmat)(prev.abs())
        assert bool(((pk[j] - pp[j]).abs() <= KERNEL_TOL * scale + 1e-30).all())
        prev = pp[j]


def test_dryrun_multichip_on_card(cuda_device):
    """``dryrun.py::dryrun_multichip`` over 8 ranks sharing the card (gloo,
    f32): the six paths converge by their true residual, every rank the
    same x, LORASC the fewest iterations, the deflation path deflating."""
    from prealps_tpu_torch.dryrun import NAMES, dryrun_multichip

    out = dryrun_multichip(8, device="cuda:0", backend="gloo")
    assert set(out) == set(NAMES)
    assert all(rec["relres"] < 1e-4 and rec["finite"] for rec in out.values())
    assert out["dry_lorasc_deflation"]["deflated"] >= 1


# --- the f64 LORASC path and the measurement scripts on the card -----------


def test_f64_lorasc_on_card_matches_cpu(cuda_device):
    """``StencilLorascECG.build(a, dtype=np.float64)`` at het 8³ (the f64
    deflation study's configuration: 8 box parts, t 12 odir_fused to 1e-5,
    no refinement) on the card, every product B2a's f64 instance, against
    the same build on the CPU: iterations ±1, the same pairs, x within 1e-8
    relative."""
    from prealps_tpu_torch.examples import deflation_study_f64 as study
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG

    a, b = study.problem(8)
    kw = dict(opts=ECGOptions(**study.OPTS), **study.build_kwargs(8, 64))
    s_g = StencilLorascECG.build(a, device=cuda_device, **kw)
    assert s_g.precond.operands["a_stencil"].blocks_t.dtype == torch.float64
    assert s_g.a_scaled is None
    before = tspmm.stencil_bsr_spmm_t_pallas_bs.f64_launches
    x_g, info_g = s_g.solve(b)
    assert tspmm.stencil_bsr_spmm_t_pallas_bs.f64_launches - before >= 3 * info_g["iters"]
    x_c, info_c = StencilLorascECG.build(a, device="cpu", **kw).solve(b)
    assert info_g["deflated"] == info_c["deflated"] and not info_g["breakdown"]
    assert abs(info_g["iters"] - info_c["iters"]) <= 1
    assert np.linalg.norm(x_g - x_c) <= 1e-8 * np.linalg.norm(x_c)


def _script_records(out):
    import json

    return [json.loads(v) for v in out.splitlines() if v.startswith("{")]


def test_deflation_study_on_card(cuda_device, capsys):
    from prealps_tpu_torch.examples import deflation_study_f64 as study

    assert study.main(["--nel", "6", "--deflations", "8,16"]) == 0
    head, *rows, _ = _script_records(capsys.readouterr().out)
    assert head["card"] != "cpu"
    assert [r["defl_requested"] for r in rows] == [8, 16]
    assert all(r["relres"] < 1e-4 and r["device_ms"] > 0 for r in rows)


def test_fmt_auto_on_card(cuda_device, capsys):
    """f32 on the card: every format's product within 1e-4 of scipy's (the
    script raises otherwise); the pass line is a measurement, not held."""
    from prealps_tpu_torch.examples import bench_fmt_auto

    rc = bench_fmt_auto.main(["--scale", "0.05", "--reps", "3"])
    _, *recs, last = _script_records(capsys.readouterr().out)
    assert rc == (0 if last["pass"] else 1) and len(recs) == 4
    assert all(r["dtype"] == "float32" and r["platform"] == "gpu" for r in recs)


def test_spmm_general_on_card(cuda_device, capsys):
    from prealps_tpu_torch.examples import bench_spmm_general

    before = tspmm.block_ell_spmm_pallas.launches
    assert bench_spmm_general.main(["--npts", "3000", "--stencil-nel", "6",
                                    "--reps", "3"]) == 0
    assert tspmm.block_ell_spmm_pallas.launches > before
    _, dia, bell, stencil, _ = _script_records(capsys.readouterr().out)
    assert all(r["relerr"] < 1e-4 and r["ms"] > 0 for r in (dia, bell, stencil))


def test_halo_overlap_on_card(cuda_device, capsys):
    """Two ranks sharing the card: the full step's product (B2b's f64
    instance) equal to the one-rank product (B2a's), the shared card
    named."""
    from prealps_tpu_torch.examples import measure_halo_overlap

    assert measure_halo_overlap.main(["--ranks", "2", "--nel", "6", "--steps", "3",
                                      "--device", "cuda:0"]) == 0
    (rec,) = _script_records(capsys.readouterr().out)
    assert rec["full_vs_single_relerr"] <= 1e-12
    assert rec["shared_card"] and rec["b2b_f64_launches"] > 0
