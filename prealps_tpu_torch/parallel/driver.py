"""DistributedECG on one GPU.

The PyTorch counterpart of ``prealps_tpu/parallel/driver.py`` on one device
(``nshards=1``), float32 or float64, for these paths:

* ``fmt="stencil"``, ``layout="tbn"`` (lane-major panels), with
  ``precond="bj2l"`` (two-level block Jacobi, the headline solve),
  ``"bj"`` (device block Jacobi, the JAX driver's "bj_flat") or ``"none"``;
  on ``layout="nt"`` (row-major panels) the JAX driver's plain product (a
  roll of the (nrb, br, t) panel and one block einsum per offset, XLA
  there, plain PyTorch here, no kernel) with host block Jacobi and
  host-f64 refinement rounds;
* ``fmt="dia"`` (hybrid DIA+ELL: promoted diagonals + ELL remainder):
  on ``layout="tbn"`` the diagonals are the flat (D, n_pad) table of a
  br = 1 stencil through B1 (``stencil_flat_ext``), the remainder one
  transposed ELL gather, and ``precond="bj"`` the device block Jacobi
  assembled from the diagonals at br = 1; on ``layout="nt"`` the plain
  ``dia_ell_spmm`` with host block Jacobi;
* ``fmt="ell"``, ``"block_ell"`` or ``"block_ell_xla"``, ``layout="nt"``
  (row-major panels), with ``precond="bj"`` (block Jacobi built on the
  host: RCM-ordered blocks, f64 factors) or ``"none"`` — the
  general-sparse path;
* ``fmt="auto"``: ``detect_format`` picks stencil, DIA (in the caller's
  order, or under RCM: "dia_rcm"), 8×8 block-ELL (under a Morton order of
  BFS pseudo-coordinates, or natural; built as ``block_ell_xla`` at bk = 8,
  the plain gather product, as in the JAX driver) or ELL. A permuting
  choice builds on A[perm][:, perm]; ``solve`` permutes b in and x back
  out (``pre_perm``), and ``fmt_info`` keeps the scores. Layout policy
  (the JAX driver's, with the card in the TPU's place): with
  ``auto_layout`` stencil and DIA take ``tbn`` on a CUDA device or for
  bj2l, and ``nt`` otherwise; the gather formats take ``nt``. With
  ``auto_layout=False`` a valid ``opts.layout`` is kept (``tbn`` falls to
  ``nt`` for the gather formats).

Build (host, then device):
  RAC scaling -> row layout with padded identity rows (stencil: contiguous;
  general and DIA: ``build_row_layout``, natural order on one shard) ->
  format conversion -> preconditioner.

Each format has an operands object with the same surface (``a_apply``,
``a_apply_df``, ``m_apply``, ``split_assign`` and the panel helpers), so the
solve does not branch on the format.

Solve:
  * float64 (or tol above ``inner_tol``): one ECG solve on the device.
  * float32 with tol below ``inner_tol``: iterative refinement. Where a
    double-float SpMM exists (stencil on tbn, ell), the rounds run on the
    device: each runs an f32 ECG solve to ``inner_tol`` (with a stall
    window) and recomputes the residual in double-float, so the rounds
    reach tolerances below the f32 floor; the result is then checked
    against a host f64 residual, and host-f64 rounds polish it if the
    device rounds fell short. Block-ELL, DIA and the stencil on nt have no
    double-float product: their rounds take host f64 residuals with device
    inner solves, as in the JAX driver.

The operator applies go through the hand-written CUDA kernels on the card
(``ops/spmm.py::stencil_flat_ext``, ``block_ell_spmm_pallas``) and their
plain PyTorch versions on the CPU; ``block_ell_xla``, DIA on ``nt`` and
the DIA remainder are plain PyTorch on the card too, as they are XLA in
the JAX driver.

Not ported (NotImplementedError): ``nshards > 1``,
``precond="chebyshev"``, the bf16 (``bj_lane``) and deduplicated
(``bj_dedup``) block Jacobi, bj2l without ``grid=``, pinned partitions
(``parts=``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Optional, Union

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.layout import (
    RowLayout,
    build_row_layout,
    contiguous_row_layout,
    pad_to_padded,
    permute_and_pad_matrix,
    unpad_from_padded,
)
from prealps_tpu_torch.core.scaling import sym_rac_scaling
from prealps_tpu_torch.direct.device_bj import (
    bj_apply_flat,
    build_device_block_jacobi_flat,
)
from prealps_tpu_torch.ops.doublefloat import df_add
from prealps_tpu_torch.ops.formats import (
    BlockEllMatrix,
    DiaEllMatrix,
    EllMatrix,
    StencilBsrMatrix,
    csr_to_block_ell,
    csr_to_dia_ell,
    csr_to_ell,
    csr_to_stencil_bsr,
    detect_format,
    dia_ell_host,
    panel_from_flat_kmajor,
    panel_to_flat_kmajor,
    stencil_blocks_host,
)
from prealps_tpu_torch.ops.spmm import (
    block_ell_spmm,
    block_ell_spmm_pallas,
    dia_ell_spmm,
    ell_gather_spmm_df,
    ell_spmm,
    extend_wrap,
    stencil_flat_ext,
    stencil_scan_accumulate_df,
)
from prealps_tpu_torch.precond.block_jacobi import BlockJacobi, build_block_jacobi
from prealps_tpu_torch.precond.twolevel import (
    bj2l_apply,
    coarse_matrix_host,
    geometric_rbm_modes,
)
from prealps_tpu_torch.solvers.ecg import ECGOptions, ECGResult, ecg_solve

MAX_REFINE_ROUNDS = 8
Q_MODES = 6          # rigid-body coarse modes per block (3-D elasticity)


def coarse_inverse_host(ac: np.ndarray) -> np.ndarray:
    """Explicit inverse of the (banded, SPD) coarse matrix.

    A_c = Zᵀ A Z is banded for slab-ordered blocks (block b couples only to
    b±1 when the stencil halo is smaller than a block), so a banded Cholesky
    and banded back-substitution give the inverse cheaply; dense Cholesky
    (and then LU) are the fallbacks when the band is wide or A_c is not
    numerically SPD. Returns the symmetrised inverse in float64."""
    nc = ac.shape[0]
    ii, jj = np.nonzero(np.abs(ac) > 0)
    bw = int(np.abs(ii - jj).max()) if ii.size else 0
    ac_inv = None
    if bw <= max(64, nc // 8):
        try:
            ab = np.zeros((bw + 1, nc))
            for kd in range(bw + 1):
                ab[bw - kd, kd:] = np.diagonal(ac, kd)
            cb = sla.cholesky_banded(ab)
            ac_inv = sla.cho_solve_banded((cb, False), np.eye(nc))
        except np.linalg.LinAlgError:
            ac_inv = None
    if ac_inv is None:
        try:
            c_f = sla.cho_factor(ac, overwrite_a=False)
            ac_inv = sla.cho_solve(c_f, np.eye(nc))
        except np.linalg.LinAlgError:
            ac_inv = sla.inv(ac)
    return 0.5 * (ac_inv + ac_inv.T)


class _Operands:
    """Without a double-float product (``df_ok`` False) the refinement
    residuals are host f64 and ``a_apply_df`` is never called."""

    df_ok = False

    def a_apply_df(self, x: torch.Tensor):
        raise NotImplementedError(
            "double-float A-apply exists only for stencil(tbn)/ell")


class _LaneMajor(_Operands):
    """Lane-major ("tbn") panels: a padded vector is the (br, nrb) space."""

    layout = "tbn"

    def to_space(self, v_pad: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(v_pad.reshape(-1, self.br).T)

    def from_space(self, v: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(v.T).reshape(-1)

    @staticmethod
    def expand(v):
        return v[None]

    @staticmethod
    def squeeze(p):
        return p[0]


class _RowMajor(_Operands):
    """Row-major ("nt") panels: a padded vector is the (n_pad,) space."""

    layout = "nt"

    @staticmethod
    def to_space(v_pad: np.ndarray) -> np.ndarray:
        return v_pad

    @staticmethod
    def from_space(v: np.ndarray) -> np.ndarray:
        return v

    @staticmethod
    def expand(v):
        return v[:, None]

    @staticmethod
    def squeeze(p):
        return p[:, 0]

    def split_assign(self, t: int, n_pad: int) -> torch.Tensor:
        """rhs split (n_pad,): row g goes to column (g·t) // n_pad."""
        return (torch.arange(n_pad, device=self.device) * t) // n_pad

    def m_apply(self, z: torch.Tensor) -> torch.Tensor:
        """Host-built block Jacobi, or the identity (precond="none")."""
        return z if self.bj is None else self.bj.apply(z)

    @property
    def precond_kind(self):
        return None if self.bj is None else "bj"


@dataclass
class StencilOperands(_LaneMajor):
    """Device operands of the stencil path: the flat block table and the
    block-Jacobi inverses, plus the coarse space of two-level block Jacobi
    (precond="bj2l"); without them the preconditioner is plain block Jacobi
    (precond="bj", the JAX driver's "bj_flat"), and without ``inv_f`` the
    identity (precond="none")."""

    blocks_flat: torch.Tensor   # (S·br², nrb) block table
    offsets: tuple              # S node offsets
    br: int
    inv_f: Optional[torch.Tensor] = None   # (nb, mb, mb) block inverses
    yq3: Optional[torch.Tensor] = None     # (nb, q, mb) coarse modes
    ac_inv: Optional[torch.Tensor] = None  # (nb·q, nb·q) coarse inverse

    df_ok = True

    @property
    def precond_kind(self):
        if self.inv_f is None:
            return None
        return "bj_flat" if self.yq3 is None else "bj2l"

    @property
    def nrb(self) -> int:
        return int(self.blocks_flat.shape[1])

    @property
    def halo(self) -> int:
        return max(abs(o) for o in self.offsets)

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        """A·x for a lane-major panel x (t, br, nrb)."""
        x_ext = extend_wrap(panel_to_flat_kmajor(x), self.halo)
        yf = stencil_flat_ext(self.blocks_flat, self.offsets, x_ext, self.halo,
                              self.br)
        return panel_from_flat_kmajor(yf, self.br)

    def a_apply_df(self, x: torch.Tensor):
        """A·x in double-float for a lane-major panel: (y_hi, y_lo)."""
        blocks_t = self.blocks_flat.reshape(len(self.offsets), self.br,
                                            self.br, self.nrb)
        return stencil_scan_accumulate_df(blocks_t, self.offsets,
                                          extend_wrap(x, self.halo), self.halo)

    def m_apply(self, z: torch.Tensor) -> torch.Tensor:
        if self.inv_f is None:
            return z
        if self.yq3 is None:
            return bj_apply_flat(self.inv_f, z)
        return bj2l_apply(self.inv_f, self.yq3, self.ac_inv, z)

    def split_assign(self, t: int, n_pad: int) -> torch.Tensor:
        """rhs split (br, nrb): global row (r·br + k) goes to column
        (row·t) // n_pad — a contiguous split into t chunks."""
        dev = self.blocks_flat.device
        r_idx = torch.arange(self.nrb, device=dev)[None, :]
        k_idx = torch.arange(self.br, device=dev)[:, None]
        return ((r_idx * self.br + k_idx) * t) // n_pad


@dataclass
class DiaLaneOperands(StencilOperands):
    """Device operands of fmt="dia" on lane-major panels: the D promoted
    diagonals are the flat (D, n_pad) table of a br = 1 stencil (B1), and
    the remainder entries go through one transposed ELL gather. There is no
    double-float DIA product: refinement residuals are host f64."""

    rem_vals: Optional[torch.Tensor] = None   # (n_pad, L) remainder ELL
    rem_cols: Optional[torch.Tensor] = None

    df_ok = False

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        y = super().a_apply(x)
        if self.rem_vals is None:
            return y
        x_nt = x[:, 0, :].T                                 # (n_pad, t)
        y_rem = torch.einsum("ml,mlt->mt", self.rem_vals, x_nt[self.rem_cols])
        return y + y_rem.T[:, None, :]

    a_apply_df = _Operands.a_apply_df   # not the stencil's: no remainder


@dataclass
class EllOperands(_RowMajor):
    """Device operands of fmt="ell": ELL matrix + host-built block Jacobi.
    The refinement residual runs on the device in double-float."""

    mat: EllMatrix
    bj: Optional[BlockJacobi]

    df_ok = True

    @property
    def device(self) -> torch.device:
        return self.mat.vals.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmm(self.mat, x)

    def a_apply_df(self, x: torch.Tensor):
        return ell_gather_spmm_df(self.mat.vals, x[self.mat.cols])


@dataclass
class BlockEllOperands(_RowMajor):
    """Device operands of fmt="block_ell" (the block-ELL kernel,
    ``block_ell_spmm_pallas``) and fmt="block_ell_xla" (its plain version,
    ``block_ell_spmm``), with host-built block Jacobi. There is no
    double-float block-ELL product: refinement residuals are host f64."""

    mat: BlockEllMatrix
    bj: Optional[BlockJacobi]
    kernel: bool = True

    @property
    def device(self) -> torch.device:
        return self.mat.blocks.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.mat.shape[1] - x.shape[0]
        if pad:
            x = torch.cat([x, torch.zeros((pad, x.shape[1]), dtype=x.dtype,
                                          device=x.device)])
        if self.kernel:
            return block_ell_spmm_pallas(self.mat, x.contiguous())
        return block_ell_spmm(self.mat, x)


@dataclass
class DiaOperands(_RowMajor):
    """Device operands of fmt="dia" on row-major panels: hybrid DIA+ELL
    (``dia_ell_spmm``, plain PyTorch as in the JAX driver) with host-built
    block Jacobi. No double-float product: refinement residuals are host
    f64."""

    mat: DiaEllMatrix
    bj: Optional[BlockJacobi]

    @property
    def device(self) -> torch.device:
        return self.mat.diags.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        return dia_ell_spmm(self.mat, x)


@dataclass
class StencilNtOperands(_RowMajor):
    """Device operands of fmt="stencil" on row-major panels: the node-major
    (nrb, S, br, br) blocks, applied as the JAX driver's nt product does
    (a roll of the (nrb, br, t) panel and one block einsum per offset;
    plain PyTorch, as it is XLA there), with host-built block Jacobi. No
    double-float product: refinement residuals are host f64."""

    mat: StencilBsrMatrix
    bj: Optional[BlockJacobi]

    @property
    def device(self) -> torch.device:
        return self.mat.blocks.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        nrb, _, br, _ = self.mat.blocks.shape
        x3 = x.reshape(nrb, br, x.shape[1])
        y = torch.zeros_like(x3)
        for s, off in enumerate(self.mat.offsets):
            xs = torch.roll(x3, -off, dims=0) if off else x3
            y = y + torch.einsum("rmk,rkt->rmt", self.mat.blocks[:, s], xs)
        return y.reshape(x.shape)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


Operands = Union[StencilOperands, DiaLaneOperands, EllOperands,
                 BlockEllOperands, DiaOperands, StencilNtOperands]
_LATER = "is not ported yet (ROADMAP.md queue A, item 1)"
LANE_FORMATS = ("stencil", "dia")


def build_sharded_block_jacobi(a_pad: sp.csr_matrix, layout: RowLayout,
                               nblocks_per_shard: int = 1, dtype=None,
                               device="cpu") -> BlockJacobi:
    """Block Jacobi of the shard's diagonal block with local row indexing
    (prealps_tpu/parallel/driver.py:46-70), on one shard."""
    if layout.nshards != 1:
        raise NotImplementedError(
            "block Jacobi over several shards is not ported yet (ROADMAP.md "
            "queue A, item 3)")
    mpl = layout.rows_per_shard
    local = a_pad if a_pad.shape[0] == mpl else a_pad[:mpl, :mpl]
    return build_block_jacobi(local, nblocks=nblocks_per_shard, dtype=dtype,
                              device=device)


def _check_options(fmt, precond, layout, grid, bj_dtype, bj_dedupe):
    """Refuse what is not ported (NotImplementedError) or not valid
    (ValueError, as the JAX driver); returns the preconditioner's kind
    ("bj2l", "bj_flat", "bj" or None for the identity)."""
    if fmt not in ("stencil", "dia", "ell", "block_ell", "block_ell_xla"):
        raise ValueError(f"unknown fmt {fmt!r}")
    lane_major = layout == "tbn"
    if lane_major and fmt not in LANE_FORMATS:
        raise ValueError("layout='tbn' requires fmt='stencil' or 'dia'")
    if precond in ("bj2l", "block_jacobi_2l"):
        if not lane_major or fmt != "stencil":
            raise ValueError(
                "bj2l requires the lane-major fast path: fmt='stencil' with "
                f"layout='tbn'; got fmt={fmt!r}, layout={layout!r}")
        if grid is None:
            raise NotImplementedError(
                f"bj2l without grid= (translation-only coarse modes) {_LATER}; "
                "pass the node grid")
        return "bj2l"
    if precond in ("block_jacobi", "bj"):
        if lane_major and bj_dtype == "bf16":
            raise NotImplementedError(f"bj_dtype='bf16' (bj_lane) {_LATER}")
        if lane_major and bj_dedupe and grid is not None:
            raise NotImplementedError(
                f"bj_dedupe=True with grid= (grid-aligned bj_dedup) {_LATER}; "
                "pass bj_dedupe=False or grid=None")
        return "bj_flat" if lane_major else "bj"
    if precond in ("none", "identity", "noprec"):
        return None
    if precond in ("chebyshev", "cheby"):
        raise NotImplementedError(f"precond={precond!r} {_LATER}")
    raise ValueError(
        f"DistributedECG supports block_jacobi/bj2l/chebyshev/none, got {precond!r}")


def _detect(a, br, opts, auto_layout, precond, device):
    """fmt="auto": pick the format with ``detect_format`` and the layout
    (the JAX driver's rule with the card in the TPU's place: tbn for
    stencil/dia on a CUDA device or for bj2l, nt otherwise, unless
    auto_layout=False keeps a valid caller's layout). Returns (fmt, opts,
    a, pre_perm, fmt_info, bell_bk): a is the permuted matrix where the
    choice permutes rows."""
    fmt, info = detect_format(a, br=br, nshards=1, allow_stencil=True,
                              allow_reorder=True)
    tag, pre_perm, bell_bk = fmt, None, 128
    if fmt in ("block_ell_morton", "dia_rcm"):
        pre_perm = info.pop("perm")
        a = info.pop("permuted")
    if fmt in ("block_ell_morton", "block_ell_natural"):
        # the plain gather product at 8×8 blocks, as in the JAX driver
        fmt, bell_bk = "block_ell_xla", 8
    elif fmt == "dia_rcm":
        fmt = "dia"
    if auto_layout:
        want = ("tbn" if fmt in LANE_FORMATS
                and (device.type == "cuda"
                     or precond in ("bj2l", "block_jacobi_2l"))
                else "nt")
    elif opts.layout == "tbn" and fmt not in LANE_FORMATS:
        want = "nt"
    else:
        want = opts.layout
    info["chosen"] = tag
    return fmt, replace(opts, layout=want), a, pre_perm, info, bell_bk


def _stencil_operands(a, kind, br, block_size, grid, scale_d, dtype, device,
                      stage):
    """Stencil path: contiguous layout, flat block table, device block
    Jacobi (+ the bj2l coarse space)."""
    # device block Jacobi: node-block size, a multiple of 8 nodes
    mbn = max(8, (int(block_size or 1024) // br // 8) * 8)
    mult = math.lcm(8, br)
    if kind is not None:
        mult = math.lcm(mult, mbn * br)
    layout = contiguous_row_layout(a.shape[0], 1, row_multiple=mult)
    a_pad = permute_and_pad_matrix(a, layout)
    stage("layout")

    host = stencil_blocks_host(a_pad, br=br, dtype=dtype)
    if host is None:
        raise ValueError("matrix is not stencil-structured; use fmt='ell' or "
                         "'block_ell'")
    blocks_host, offsets = host
    s_off = len(offsets)
    nrb = layout.n_pad // br
    if max(abs(o) for o in offsets) > nrb:
        raise ValueError(f"stencil halo exceeds the node count {nrb}")
    # flat (S·br², nrb) table: row s·br² + m·br + k
    blocks_flat = torch.from_numpy(np.ascontiguousarray(
        blocks_host.transpose(1, 2, 3, 0).reshape(s_off * br * br, nrb)
    )).to(device)
    del blocks_host
    _sync(device)
    stage("fmt_convert")

    ops = StencilOperands(blocks_flat=blocks_flat, offsets=offsets, br=br)
    if kind is not None:
        ops.inv_f = build_device_block_jacobi_flat(
            blocks_flat.reshape(s_off, br, br, nrb), offsets, mbn=mbn)
    if kind == "bj2l":
        nb = ops.inv_f.shape[0]
        mb = br * mbn
        d_pad = pad_to_padded(layout, scale_d) if scale_d is not None else None
        y5 = geometric_rbm_modes(grid, br, nrb, mbn, scale_d=d_pad, q=Q_MODES)
        ac = coarse_matrix_host(a_pad, y5, br)
        # padded rows carry identity blocks; their modes can make A_c
        # ill-conditioned — regularise lightly
        nc = ac.shape[0]
        ac += 1e-10 * np.trace(ac) / nc * np.eye(nc)
        ac_inv = coarse_inverse_host(ac).astype(dtype)
        yq3 = np.ascontiguousarray(
            y5.transpose(0, 3, 1, 2).reshape(nb, -1, mb)).astype(dtype)
        ops.yq3 = torch.from_numpy(yq3).to(device)
        ops.ac_inv = torch.from_numpy(ac_inv).to(device)
    _sync(device)
    stage("precond")
    return layout, ops


def _dia_lane_operands(a, kind, block_size, dtype, device, stage):
    """fmt="dia" on lane-major panels: one-shard partition layout (natural
    order), the promoted diagonals as a br = 1 flat block table, the ELL
    remainder, and device block Jacobi assembled from the diagonals."""
    mbn = max(8, (int(block_size or 1024) // 8) * 8)
    mult = math.lcm(8, mbn) if kind is not None else 8
    layout = build_row_layout(a, 1, row_multiple=mult)
    a_pad = permute_and_pad_matrix(a, layout)
    stage("layout")

    offsets, diags, rem = dia_ell_host(a_pad, min_fill=0.05, dtype=dtype)
    ops = DiaLaneOperands(blocks_flat=torch.from_numpy(diags).to(device),
                          offsets=offsets, br=1)
    if rem is not None:
        ell = csr_to_ell(rem, dtype=dtype, device=device)
        ops.rem_vals, ops.rem_cols = ell.vals, ell.cols
    _sync(device)
    stage("fmt_convert")

    if kind is not None:
        # from the promoted diagonals only: remainder entries inside a block
        # are left out of the preconditioner, as in the JAX driver
        ops.inv_f = build_device_block_jacobi_flat(
            ops.blocks_flat.reshape(len(offsets), 1, 1, -1), offsets, mbn=mbn)
    _sync(device)
    stage("precond")
    return layout, ops


def _general_operands(a, fmt, kind, br, block_size, nblocks_per_shard,
                      bell_bk, dtype, device, stage):
    """Row-major panels: partition layout (stencil: contiguous), ELL /
    block-ELL / DIA+ELL / stencil, host block Jacobi."""
    bell = fmt in ("block_ell", "block_ell_xla")
    if fmt == "stencil":
        layout = contiguous_row_layout(a.shape[0], 1,
                                       row_multiple=math.lcm(8, br))
    else:
        # block-ELL moves whole bk = 128 column blocks: rows pad to 128
        layout = build_row_layout(a, 1, row_multiple=128 if bell else 8)
    a_pad = permute_and_pad_matrix(a, layout)
    stage("layout")

    if fmt == "stencil":
        mat = csr_to_stencil_bsr(a_pad, br=br, dtype=dtype, device=device)
        if mat is None:
            raise ValueError("matrix is not stencil-structured; use "
                             "fmt='ell' or 'block_ell'")
    elif bell:
        mat = csr_to_block_ell(a_pad, bm=8, bk=bell_bk, dtype=dtype,
                               device=device)
    elif fmt == "dia":
        mat = csr_to_dia_ell(a_pad, min_fill=0.05, dtype=dtype, device=device)
    else:
        mat = csr_to_ell(a_pad, dtype=dtype, device=device)
    _sync(device)
    stage("fmt_convert")

    bj = None
    if kind is not None:
        if block_size is not None:
            nblocks_per_shard = max(1, -(-layout.rows_per_shard // block_size))
        bj = build_sharded_block_jacobi(a_pad, layout, nblocks_per_shard,
                                        dtype=dtype, device=device)
    if fmt == "stencil":
        ops = StencilNtOperands(mat=mat, bj=bj)
    elif bell:
        ops = BlockEllOperands(mat=mat, bj=bj, kernel=fmt == "block_ell")
    elif fmt == "dia":
        ops = DiaOperands(mat=mat, bj=bj)
    else:
        ops = EllOperands(mat=mat, bj=bj)
    _sync(device)
    stage("precond")
    return layout, ops


@dataclass
class DistributedECG:
    """Build once, solve many times (see module docstring)."""

    layout: RowLayout
    opts: ECGOptions
    scale_d: Optional[np.ndarray]          # RAC scaling vector
    operands: Operands
    device: torch.device
    dtype: np.dtype
    target_tol: float = 0.0
    a_scaled: Optional[sp.csr_matrix] = None   # set when refining
    timings: dict = field(default_factory=dict)  # build stage wall times (s)
    pre_perm: Optional[np.ndarray] = None  # fmt="auto" row permutation
    fmt_info: Optional[dict] = None        # fmt="auto" detection scores

    @classmethod
    def build(
        cls,
        a: sp.spmatrix,
        nshards: Optional[int] = 1,
        opts: ECGOptions = ECGOptions(),
        precond: str = "block_jacobi",
        scale: bool = True,
        nblocks_per_shard: int = 1,
        block_size: Optional[int] = None,
        dtype=None,
        fmt: str = "ell",
        br: int = 3,
        refine: Optional[bool] = None,
        inner_tol: float = 1e-3,
        grid: Optional[tuple] = None,
        bj_dtype: str = "f32",
        bj_dedupe: bool = True,
        auto_layout: bool = True,
        device="cuda",
    ) -> "DistributedECG":
        """Build the solver on ``device`` (default "cuda", which raises
        when there is no card; pass device="cpu" to run on the host). The
        other defaults are the JAX driver's: fmt="ell", precond=
        "block_jacobi", and one block-Jacobi block per shard unless
        block_size is given. With fmt="auto", ``auto_layout`` picks the
        layout for the detected format; False keeps ``opts.layout`` wherever
        it is valid."""
        device = resolve_device(device)
        strict_fp32()
        if nshards not in (None, 1):
            raise NotImplementedError(
                f"nshards={nshards}: the multi-GPU driver is not ported yet "
                "(ROADMAP.md queue A, item 3)")
        a = sp.csr_matrix(a)
        tb: dict = {}
        mark = [time.perf_counter()]

        def stage(name):
            now = time.perf_counter()
            tb[name] = tb.get(name, 0.0) + (now - mark[0])
            mark[0] = now

        pre_perm = fmt_info = None
        bell_bk = 128
        if fmt == "auto":
            # refuse an unported preconditioner before the detection's work
            if precond in ("chebyshev", "cheby"):
                raise NotImplementedError(f"precond={precond!r} {_LATER}")
            fmt, opts, a, pre_perm, fmt_info, bell_bk = _detect(
                a, br, opts, auto_layout, precond, device)
            stage("detect")
        kind = _check_options(fmt, precond, opts.layout, grid, bj_dtype,
                              bj_dedupe)

        dtype = np.dtype(dtype) if dtype is not None else a.dtype
        if dtype not in (np.float32, np.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        scale_d = None
        if scale:
            a, scale_d = sym_rac_scaling(a)
        target_tol = opts.tol
        if refine is None:
            refine = dtype == np.float32 and opts.tol < inner_tol
        if refine:
            # inner solves stop on stagnation: an early stop just hands the
            # remaining work to the next refinement round
            opts = replace(opts, tol=inner_tol,
                           stall_window=opts.stall_window or 250)
        if fmt == "stencil" and opts.layout == "tbn":
            layout, operands = _stencil_operands(
                a, kind, br, block_size, grid, scale_d, dtype, device, stage)
        elif fmt == "dia" and opts.layout == "tbn":
            layout, operands = _dia_lane_operands(
                a, kind, block_size, dtype, device, stage)
        else:
            layout, operands = _general_operands(
                a, fmt, kind, br, block_size, nblocks_per_shard, bell_bk,
                dtype, device, stage)
        return cls(
            layout=layout, opts=opts, scale_d=scale_d, operands=operands,
            device=device, dtype=dtype, target_tol=target_tol,
            a_scaled=a if refine else None, timings=tb, pre_perm=pre_perm,
            fmt_info=fmt_info,
        )

    def _ecg(self, rhs: torch.Tensor) -> ECGResult:
        ops = self.operands
        return ecg_solve(ops.a_apply, ops.m_apply, rhs, self.opts,
                         split_assign=ops.split_assign(self.opts.t,
                                                       self.layout.n_pad))

    # --- solves ---------------------------------------------------------

    def _solve_scaled_once(self, b_eff: np.ndarray):
        """One device ECG solve of the scaled, padded system."""
        ops = self.operands
        b_pad = pad_to_padded(self.layout, b_eff.astype(self.dtype))
        rhs = torch.from_numpy(ops.to_space(b_pad)).to(self.device)
        res = self._ecg(rhs)
        x = unpad_from_padded(self.layout, ops.from_space(res.x.cpu().numpy()))
        info = {
            "iters": int(res.iters),
            "res": float(res.res),
            "normb": float(res.normb),
            "bs": int(res.bs),
            "breakdown": bool(res.breakdown),
            "history": res.history.cpu().numpy(),
        }
        return x.astype(np.float64), info

    def local_refine(self, b_hi: torch.Tensor, b_lo: torch.Tensor):
        """Mixed-precision iterative refinement on the device.

        b = b_hi + b_lo (double-float, in the operands' space: (br, nrb)
        lane-major or (n_pad,) row-major). Each round
        runs an f32 ECG solve on the current residual, adds the correction
        to x in double-float, and recomputes r = b − A·x with the
        compensated SpMM (A·x_hi in double-float, A·x_lo in f32). Stops
        when the target is reached, a round gains less than 10 %, the
        residual is NaN, the inner solve broke down, or after
        MAX_REFINE_ROUNDS rounds. Returns (x_hi, x_lo, info)."""
        ops = self.operands

        def resid(xh, xl):
            yh, yl = ops.a_apply_df(ops.expand(xh))
            y2 = ops.squeeze(ops.a_apply(ops.expand(xl)))
            rh, rl = df_add((b_hi, b_lo), (-ops.squeeze(yh), -ops.squeeze(yl)))
            return df_add((rh, rl), (-y2, torch.zeros_like(y2)))

        def gnorm(v):
            return torch.sqrt(torch.sum(v * v))

        normb = gnorm(b_hi)
        tol_s = torch.tensor(self.target_tol, dtype=b_hi.dtype,
                             device=b_hi.device)
        xh = torch.zeros_like(b_hi)
        xl = torch.zeros_like(b_hi)
        r = b_hi
        relres = torch.ones((), dtype=b_hi.dtype, device=b_hi.device)
        it_tot, rounds, brk, bs = 0, 0, False, self.opts.t
        history = torch.full((self.opts.maxiter,), -1.0, dtype=b_hi.dtype,
                             device=b_hi.device)
        stop = bool(relres <= tol_s)
        while rounds < MAX_REFINE_ROUNDS and not stop:
            res = self._ecg(r)
            xh, xl = df_add((xh, xl), (res.x, torch.zeros_like(res.x)))
            r, _ = resid(xh, xl)
            relres2 = gnorm(r) / normb
            stop = bool((relres2 <= tol_s) | (relres2 > 0.9 * relres)
                        | torch.isnan(relres2)) or res.breakdown
            relres = relres2
            it_tot += res.iters
            rounds += 1
            brk, bs, history = res.breakdown, res.bs, res.history
        info = {
            "iters": it_tot,
            "res": float(relres * normb),
            "normb": float(normb),
            "bs": int(bs),
            "breakdown": bool(brk),
            "refine_rounds": rounds,
            "device_rounds": rounds,
            "history": history.cpu().numpy(),
        }
        return xh, xl, info

    def _solve_refined_device(self, b_eff: np.ndarray):
        """Device-resident refinement, then a host f64 cross-check."""
        ops = self.operands
        b_pad = ops.to_space(pad_to_padded(self.layout, b_eff))  # f64
        b_hi = b_pad.astype(np.float32)
        b_lo = (b_pad - b_hi.astype(np.float64)).astype(np.float32)
        xh, xl, info = self.local_refine(
            torch.from_numpy(b_hi).to(self.device),
            torch.from_numpy(b_lo).to(self.device))
        x_np = (xh.cpu().numpy().astype(np.float64)
                + xl.cpu().numpy().astype(np.float64))
        x = unpad_from_padded(self.layout, ops.from_space(x_np))
        r = b_eff - self.a_scaled @ x
        info["res"] = float(np.linalg.norm(r))
        info["relres_scaled"] = float(info["res"] / np.linalg.norm(b_eff))
        return x, info

    def solve(self, b: np.ndarray, max_refine_rounds: int = MAX_REFINE_ROUNDS):
        """Solve A x = b (original ordering and scaling). Returns (x, info).
        With fmt="auto"'s row permutation the build ran on A[perm][:, perm]:
        b goes in as b[perm] and x comes back in the original ordering."""
        b = np.asarray(b)
        if self.pre_perm is None:
            return self._solve_permuted(b, max_refine_rounds)
        x_p, info = self._solve_permuted(b[self.pre_perm], max_refine_rounds)
        x = np.empty_like(x_p)
        x[self.pre_perm] = x_p
        return x, info

    def _solve_permuted(self, b: np.ndarray, max_refine_rounds: int):
        b_eff = self.scale_d * b if self.scale_d is not None else b.astype(np.float64)

        if self.a_scaled is None:
            x, info = self._solve_scaled_once(b_eff)
        else:
            x0, info0 = None, None
            if self.dtype == np.float32 and self.operands.df_ok:
                x0, info0 = self._solve_refined_device(b_eff)
                if (info0["relres_scaled"] <= self.target_tol
                        or info0["breakdown"]):
                    if self.scale_d is not None:
                        x0 = self.scale_d * x0
                    return x0, info0
            # the device rounds stopped above the target, the format has no
            # double-float product (block-ELL), or refinement was requested
            # in f64: host f64 residuals, device solves
            a = self.a_scaled
            normb = np.linalg.norm(b_eff)
            x = np.zeros_like(b_eff) if x0 is None else x0
            total_iters = 0 if info0 is None else info0["iters"]
            rounds = 0 if info0 is None else info0["refine_rounds"]
            info = {}
            prev_relres = np.inf
            for _ in range(max_refine_rounds):
                r = b_eff - a @ x
                relres = np.linalg.norm(r) / normb
                if relres <= self.target_tol:
                    break
                if relres > 0.9 * prev_relres:
                    break  # no meaningful progress: at the f32 floor
                prev_relres = relres
                dx, info = self._solve_scaled_once(r)
                x = x + dx
                total_iters += info["iters"]
                rounds += 1
                if info["breakdown"]:
                    break
            r = b_eff - a @ x
            info = dict(info or info0 or {})
            info["iters"] = total_iters
            info["refine_rounds"] = rounds
            info["device_rounds"] = 0 if info0 is None else info0["device_rounds"]
            info["res"] = float(np.linalg.norm(r))
            info["relres_scaled"] = float(np.linalg.norm(r) / normb)

        if self.scale_d is not None:
            x = self.scale_d * x
        return x, info
