"""The port's CUDA kernel on the card (marked ``cuda``; skipped without one).

Imports neither JAX nor the JAX package, so it runs on the GPU machine,
which has no JAX; tests/conftest.py imports JAX, so run it there without
the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernel is held against its plain PyTorch version on the same inputs:
max |y_kernel − y_plain| ≤ 1e-5·(|B|·|x|) elementwise — the two sum the
same products in the same order, the kernel with FMAs.
"""

import numpy as np
import pytest
import torch

from prealps_tpu_torch.core.generators import elasticity3d, poisson3d
from prealps_tpu_torch.ops import formats as tfmt
from prealps_tpu_torch.ops import spmm as tspmm
from prealps_tpu_torch.parallel.driver import DistributedECG
from prealps_tpu_torch.solvers.ecg import ECGOptions

pytestmark = pytest.mark.cuda


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
    assert bool(((y - ref).abs() <= 1e-5 * scale + 1e-30).all())


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
