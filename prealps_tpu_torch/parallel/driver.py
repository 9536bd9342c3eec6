"""DistributedECG on one GPU, or over several processes, one a shard.

The PyTorch counterpart of ``prealps_tpu/parallel/driver.py``, float32 or
float64. On one device (``nshards=1``, no process group) for these paths:

* ``fmt="stencil"``, ``layout="tbn"`` (lane-major panels), with
  ``precond="bj2l"`` (two-level block Jacobi, the headline solve; with
  ``grid=`` geometric rigid-body coarse modes, without it one translation
  per component), ``"bj"`` (device block Jacobi: the JAX driver's
  "bj_flat"; "bj_dedup" where ``bj_dedupe`` and ``grid=`` align the blocks
  with repeated grid lines or slabs; "bj_lane" with ``bj_dtype="bf16"``),
  ``"chebyshev"`` or ``"none"``;
  on ``layout="nt"`` (row-major panels) the JAX driver's plain product (a
  roll of the (nrb, br, t) panel and one block einsum per offset, XLA
  there, plain PyTorch here, no kernel) with host block Jacobi and
  host-f64 refinement rounds;
* ``fmt="dia"`` (hybrid DIA+ELL: promoted diagonals + ELL remainder):
  on ``layout="tbn"`` the diagonals are the flat (D, n_pad) table of a
  br = 1 stencil through B1 (``stencil_flat_ext``), the remainder one
  transposed ELL gather, and ``precond="bj"`` the device block Jacobi
  assembled from the diagonals at br = 1; on ``layout="nt"`` the plain
  product (``dia_window_spmm`` on the wrap-extended panel, the ELL
  remainder) with host block Jacobi;
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

``precond="chebyshev"`` (degree ``cheb_degree``, λ_min = λ_max /
``cheb_kappa``) runs on every format and layout: its d − 1 products per
apply are the operands' own ``a_apply``. A pinned partition (``parts=``,
one part id per row) or a caller's ``RowLayout`` (``layout=``) replaces the
driver's own row layout, as in the JAX driver.

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

Over several shards (``nshards=N`` with a ``torch.distributed`` group of N
ranks; SPMD: every rank calls ``build`` with the same host matrix and
computes the same host layout, moves only its shard's operands to its
device, and ``solve`` returns the full x and the same info on every rank):

* ``fmt="stencil"`` on ``tbn`` with ``precond`` bj2l, bj (flat blocks: the
  dedup falls back to them, as the JAX driver's ``nshards == 1`` condition
  does; or bf16 "bj_lane"), chebyshev or none: contiguous rows, the ring
  halo of ``ops/spmm.py::extend_ring`` before B1 and before the
  double-float product, bj2l's coarse residual all-gathered;
* ``fmt="ell"`` on ``nt`` with host block Jacobi, chebyshev or none: the
  k-way row layout (``build_row_layout``) or the caller's, the
  ``HaloPlan``'s all-to-all before each product;
* ``fmt="block_ell"`` (B5) and ``"block_ell_xla"`` on ``nt``: the k-way
  layout in whole 128-row blocks, bk 128, the ``BlockHaloPlan``'s
  all-to-all of X blocks before each product on [own ∥ halo] blocks;
* ``fmt="dia"`` on ``tbn``: the k-way layout, the shard's diagonals as a
  br = 1 table through B1 on the ring-extended panel, the remainder's
  ``HaloPlan`` all-to-all, the device block Jacobi from the shard's
  diagonals (no dedup, as in the JAX driver), Chebyshev or none; on
  ``nt``: the diagonals on a ring window (or for thin shards the periodic
  window of the gathered panel), the remainder likewise, host block Jacobi;
* ``fmt="stencil"`` on ``nt``: contiguous rows, an all-gather of x before
  each product;
* ``fmt="auto"``: ``detect_format`` with the shard count (no Morton probe;
  block-ELL scored and built at bk 128), then the chosen format above;

every Gram an all-reduce (``solvers/ecg.py``, ``parallel/mesh.py``). The
JAX driver's Pallas tiling ``rb_per_prog`` has no counterpart (ROADMAP.md
"Not to port").
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
    build_block_halo_plan,
    build_halo_plan,
    build_row_layout,
    contiguous_row_layout,
    layout_from_part,
    pad_to_padded,
    permute_and_pad_matrix,
    unpad_from_padded,
)
from prealps_tpu_torch.core.scaling import sym_rac_scaling
from prealps_tpu_torch.direct.device_bj import (
    BlockGroups,
    bj_apply_flat,
    bj_apply_grouped,
    bj_apply_lane_major,
    block_groups,
    build_device_block_jacobi,
    build_device_block_jacobi_flat,
    build_device_block_jacobi_grouped,
    csr_slab_groups,
)
from prealps_tpu_torch.ops.blockops import psum
from prealps_tpu_torch.ops.doublefloat import df_add
from prealps_tpu_torch.ops.formats import (
    BlockEllMatrix,
    DiaEllMatrix,
    EllMatrix,
    StencilBsrMatrix,
    csr_to_block_ell,
    csr_to_ell,
    detect_format,
    dia_ell_host,
    pack_block_ell_entries,
    panel_from_flat_kmajor,
    panel_to_flat_kmajor,
    stencil_blocks_host,
)
from prealps_tpu_torch.ops.spmm import (
    block_ell_spmm,
    block_ell_spmm_pallas,
    dia_window_spmm,
    ell_gather_spmm_df,
    ell_spmm,
    extend_ring,
    stencil_flat_ext,
    stencil_scan_accumulate_df,
)
from prealps_tpu_torch.parallel.mesh import (
    all_gather,
    all_to_all,
    backend_of,
    check_backend_device,
    rank_of,
    shard_device,
    size_of,
)
from prealps_tpu_torch.precond.block_jacobi import BlockJacobi, build_block_jacobi
from prealps_tpu_torch.precond.chebyshev import Chebyshev, power_lam_max_host
from prealps_tpu_torch.precond.twolevel import (
    bj2l_apply,
    coarse_matrix_host,
    geometric_rbm_modes,
    translation_modes,
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
    residuals are host f64 and ``a_apply_df`` is never called. ``cheb``,
    set at build time, makes the preconditioner a Chebyshev polynomial in
    the operands' own ``a_apply``. ``group`` and ``shard``, set at build
    time over several shards, make the operands one shard's: its rows of
    the operator and the preconditioner, with the exchanges of the group."""

    df_ok = False
    cheb: Optional[Chebyshev] = None
    group = None
    shard = 0

    def local(self, v: np.ndarray) -> np.ndarray:
        """This shard's part of a global array in the operands' space."""
        n = v.shape[self.node_axis] // size_of(self.group)
        lo = self.shard * n
        return v[..., lo:lo + n] if self.node_axis == -1 else v[lo:lo + n]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's part, concatenated: the global array."""
        if self.group is None:
            return x
        return all_gather(x, self.group, dim=self.node_axis)

    def a_apply_df(self, x: torch.Tensor):
        raise NotImplementedError(
            "double-float A-apply exists only for stencil(tbn)/ell")


class _LaneMajor(_Operands):
    """Lane-major ("tbn") panels: a padded vector is the (br, nrb) space."""

    layout = "tbn"
    node_axis = -1

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
    node_axis = 0

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
        """rhs split of this shard's rows: global row g goes to column
        (g·t) // n_pad."""
        n = n_pad // size_of(self.group)
        return ((self.shard * n + torch.arange(n, device=self.device)) * t) // n_pad

    def m_apply(self, z: torch.Tensor) -> torch.Tensor:
        """Chebyshev, host-built block Jacobi, or the identity
        (precond="none")."""
        if self.cheb is not None:
            return self.cheb.apply(z)
        return z if self.bj is None else self.bj.apply(z)

    @property
    def precond_kind(self):
        if self.cheb is not None:
            return "chebyshev"
        return None if self.bj is None else "bj"


@dataclass
class StencilOperands(_LaneMajor):
    """Device operands of the stencil path: the flat block table and the
    preconditioner's operands, one of
    * ``inv_f`` with the coarse space ``yq3``, ``ac_inv``: two-level block
      Jacobi (precond="bj2l");
    * ``inv_f`` alone: block Jacobi, the JAX driver's "bj_flat";
    * ``inv_u`` and ``groups``: one inverse per group of identical blocks
      ("bj_dedup");
    * ``inv5`` in bf16: the split-input bf16 apply ("bj_lane");
    * ``cheb``: Chebyshev (precond="chebyshev");
    and none of them: the identity (precond="none")."""

    blocks_flat: torch.Tensor   # (S·br², nrb) block table
    offsets: tuple              # S node offsets
    br: int
    inv_f: Optional[torch.Tensor] = None   # (nb, mb, mb) block inverses
    yq3: Optional[torch.Tensor] = None     # (nb, q, mb) coarse modes
    ac_inv: Optional[torch.Tensor] = None  # (nb·q, nb·q) coarse inverse
    inv_u: Optional[torch.Tensor] = None   # (ng, br, mbn, br, mbn) unique inverses
    groups: Optional[BlockGroups] = None   # the blocks of each unique inverse
    inv5: Optional[torch.Tensor] = None    # (nb, br, mbn, br, mbn) bf16 inverses

    df_ok = True

    @property
    def precond_kind(self):
        if self.cheb is not None:
            return "chebyshev"
        if self.inv_u is not None:
            return "bj_dedup"
        if self.inv5 is not None:
            return "bj_lane"
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
        """A·x for a lane-major panel x (t, br, nrb): the halo columns from
        the ring neighbours (wrapped on one shard), then B1."""
        x_ext = extend_ring(panel_to_flat_kmajor(x), self.halo, self.group)
        yf = stencil_flat_ext(self.blocks_flat, self.offsets, x_ext, self.halo,
                              self.br)
        return panel_from_flat_kmajor(yf, self.br)

    def a_apply_df(self, x: torch.Tensor):
        """A·x in double-float for a lane-major panel: (y_hi, y_lo)."""
        blocks_t = self.blocks_flat.reshape(len(self.offsets), self.br,
                                            self.br, self.nrb)
        return stencil_scan_accumulate_df(
            blocks_t, self.offsets, extend_ring(x, self.halo, self.group),
            self.halo)

    def m_apply(self, z: torch.Tensor) -> torch.Tensor:
        if self.cheb is not None:
            return self.cheb.apply(z)
        if self.inv_u is not None:
            return bj_apply_grouped(self.inv_u, self.groups, z)
        if self.inv5 is not None:
            return bj_apply_lane_major(self.inv5, z)
        if self.inv_f is None:
            return z
        if self.yq3 is None:
            return bj_apply_flat(self.inv_f, z)
        return bj2l_apply(self.inv_f, self.yq3, self.ac_inv, z, self.group)

    def split_assign(self, t: int, n_pad: int) -> torch.Tensor:
        """rhs split (br, nrb) of this shard's nodes: global row
        ((s·nrb + r)·br + k) goes to column (row·t) // n_pad — a contiguous
        split into t chunks (JAX ``make_split_assign``)."""
        dev = self.blocks_flat.device
        r_idx = self.shard * self.nrb + torch.arange(self.nrb, device=dev)[None, :]
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
    rem_send_idx: Optional[torch.Tensor] = None   # (S, h) over several shards

    df_ok = False

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        """B1 on the ring-extended diagonals, then the remainder on the
        transposed panel: over several shards its halo plan's all-to-all
        first (prealps_tpu/parallel/driver.py:807-824)."""
        y = super().a_apply(x)
        if self.rem_vals is None:
            return y
        x_nt = halo_extended(x[:, 0, :].T, self.rem_send_idx, self.group)
        y_rem = torch.einsum("ml,mlt->mt", self.rem_vals, x_nt[self.rem_cols])
        return y + y_rem.T[:, None, :]

    a_apply_df = _Operands.a_apply_df   # not the stencil's: no remainder


@dataclass
class EllOperands(_RowMajor):
    """Device operands of fmt="ell": ELL matrix + host-built block Jacobi.
    The refinement residual runs on the device in double-float. Over
    several shards ``mat`` holds this shard's rows with columns in
    [own rows ∥ halo buffer] coordinates and ``send_idx`` (S, h) the rows
    each shard needs of this one (``core/layout.py::HaloPlan``)."""

    mat: EllMatrix
    bj: Optional[BlockJacobi]
    send_idx: Optional[torch.Tensor] = None

    df_ok = True

    @property
    def device(self) -> torch.device:
        return self.mat.vals.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmm(self.mat, halo_extended(x, self.send_idx, self.group))

    def a_apply_df(self, x: torch.Tensor):
        x = halo_extended(x, self.send_idx, self.group)
        return ell_gather_spmm_df(self.mat.vals, x[self.mat.cols])


@dataclass
class BlockEllOperands(_RowMajor):
    """Device operands of fmt="block_ell" (the block-ELL kernel,
    ``block_ell_spmm_pallas``) and fmt="block_ell_xla" (its plain version,
    ``block_ell_spmm``), with host-built block Jacobi. There is no
    double-float block-ELL product: refinement residuals are host f64.
    Over several shards ``mat`` holds this shard's row blocks with block
    columns in [own blocks ∥ halo buffer] coordinates and ``send_idx``
    (S, hb) the bk-row X blocks each shard needs of this one
    (``core/layout.py::BlockHaloPlan``). With ``kernel`` the blocks'
    nonzero entries, the kernel's operand, are packed here once
    (``pack_block_ell_entries``), on every build path."""

    mat: BlockEllMatrix
    bj: Optional[BlockJacobi]
    kernel: bool = True
    send_idx: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.kernel and self.mat.entries is None:
            self.mat.entries = pack_block_ell_entries(self.mat)

    @property
    def device(self) -> torch.device:
        return self.mat.blocks.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.send_idx is not None:
            # x as (blocks, bk, t), one all-to-all of the packed blocks, the
            # product on [own ∥ halo] (prealps_tpu/parallel/driver.py:899-924)
            t = x.shape[1]
            xb = x.reshape(-1, self.mat.bk, t)
            x = halo_extended(xb, self.send_idx, self.group).reshape(-1, t)
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
    (plain PyTorch, as it is XLA in the JAX driver) with host-built block
    Jacobi. No double-float product: refinement residuals are host f64.
    ``mat`` holds this shard's columns of the diagonals and rows of the
    remainder (all of them on one shard); over several shards the
    remainder's columns are in [own rows ∥ halo buffer] coordinates and
    ``send_idx`` (S, h) is its halo plan."""

    mat: DiaEllMatrix
    bj: Optional[BlockJacobi]
    send_idx: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.mat.diags.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        # the diagonals on a window of max|offset| rows each side: the ring
        # (one shard: the wrap), or for thin shards the periodic window of
        # the gathered panel (prealps_tpu/parallel/driver.py:826-858;
        # wrapped rows meet zero diagonal entries), then the remainder,
        # over several shards through its halo plan
        halo = max(abs(o) for o in self.mat.offsets)
        x_ext = extend_ring(x.T, halo, self.group).T if halo else x
        y = dia_window_spmm(self.mat.diags, self.mat.offsets, x_ext, halo)
        if self.mat.rem is not None:
            y = y + ell_spmm(self.mat.rem,
                             halo_extended(x, self.send_idx, self.group))
        return y


@dataclass
class StencilNtOperands(_RowMajor):
    """Device operands of fmt="stencil" on row-major panels: the node-major
    (nrb, S, br, br) blocks, applied as the JAX driver's nt product does
    (a roll of the (nrb, br, t) panel and one block einsum per offset;
    plain PyTorch, as it is XLA there), with host-built block Jacobi. No
    double-float product: refinement residuals are host f64. Over several
    shards ``mat`` holds this shard's nodes, and each product all-gathers
    x and takes this shard's nodes of every roll (JAX driver :925-945)."""

    mat: StencilBsrMatrix
    bj: Optional[BlockJacobi]

    @property
    def device(self) -> torch.device:
        return self.mat.blocks.device

    def a_apply(self, x: torch.Tensor) -> torch.Tensor:
        nrb, _, br, _ = self.mat.blocks.shape
        x3 = self.gather(x).reshape(-1, br, x.shape[1])   # every shard's nodes
        nodes = self.shard * nrb + torch.arange(nrb, device=x.device)
        y = torch.zeros((nrb, br, x.shape[1]), dtype=x.dtype, device=x.device)
        for s, off in enumerate(self.mat.offsets):
            xs = x3[(nodes + off) % x3.shape[0]]     # the roll by −off, sliced
            y = y + torch.einsum("rmk,rkt->rmt", self.mat.blocks[:, s], xs)
        return y.reshape(x.shape)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


Operands = Union[StencilOperands, DiaLaneOperands, EllOperands,
                 BlockEllOperands, DiaOperands, StencilNtOperands]
LANE_FORMATS = ("stencil", "dia")


def halo_extended(x: torch.Tensor, send_idx: Optional[torch.Tensor],
                  group) -> torch.Tensor:
    """[x ∥ halo buffer] along axis 0: the rows (or X blocks) of x that each
    shard needs of this one, packed by ``send_idx`` (S, h), moved by one
    all-to-all and appended in source order (prealps_tpu/parallel/driver.py:
    879-897). x itself where there is no halo plan (one shard)."""
    if send_idx is None:
        return x
    recv = all_to_all(x[send_idx], group)             # (S, h, ...)
    return torch.cat([x, recv.reshape(-1, *x.shape[1:])])


def build_sharded_block_jacobi(a_pad: sp.csr_matrix, layout: RowLayout,
                               nblocks_per_shard: int = 1, dtype=None,
                               device="cpu", shard: int = 0) -> BlockJacobi:
    """Block Jacobi of shard ``shard``'s diagonal block with local row
    indexing (prealps_tpu/parallel/driver.py:46-70: the JAX driver builds
    every shard's and concatenates them; each rank here builds its own)."""
    mpl = layout.rows_per_shard
    r0 = shard * mpl
    local = a_pad if a_pad.shape[0] == mpl else a_pad[r0:r0 + mpl, r0:r0 + mpl]
    return build_block_jacobi(local, nblocks=nblocks_per_shard, dtype=dtype,
                              device=device)


def _check_options(fmt, precond, layout):
    """Refuse what is not valid (ValueError, as the JAX driver); returns
    the preconditioner's kind: "bj2l", "bj_device" (block Jacobi built on
    the device from lane-major operands), "bj" (host block Jacobi),
    "chebyshev" or None for the identity."""
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
        return "bj2l"
    if precond in ("block_jacobi", "bj"):
        return "bj_device" if lane_major else "bj"
    if precond in ("none", "identity", "noprec"):
        return None
    if precond in ("chebyshev", "cheby"):
        return "chebyshev"
    raise ValueError(
        f"DistributedECG supports block_jacobi/bj2l/chebyshev/none, got {precond!r}")


def _detect(a, br, opts, auto_layout, precond, device, pinned, nshards):
    """fmt="auto": pick the format with ``detect_format`` (over several
    shards no Morton probe, block fill scored at bk 128) and the layout
    (the JAX driver's rule with the card in the TPU's place: tbn for
    stencil/dia on a CUDA device or for bj2l, nt otherwise, unless
    auto_layout=False keeps a valid caller's layout). A pinned partition
    fixes the row order: no stencil and no reordering. Returns (fmt, opts,
    a, pre_perm, fmt_info, bell_bk): a is the permuted matrix where the
    choice permutes rows."""
    fmt, info = detect_format(a, br=br, nshards=nshards, allow_stencil=not pinned,
                              allow_reorder=not pinned)
    tag, pre_perm, bell_bk = fmt, None, 128
    if fmt in ("block_ell_morton", "dia_rcm"):
        pre_perm = info.pop("perm")
        a = info.pop("permuted")
    if fmt in ("block_ell_morton", "block_ell_natural"):
        # the plain gather product, at 8×8 blocks on one shard, as in the
        # JAX driver (bk 128 over several: the halo moves 128-row blocks)
        fmt, bell_bk = "block_ell_xla", 8 if nshards == 1 else 128
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


def _bj_node_block(nodes, br, block_size, grid, dedupe):
    """Node-block size of the device block Jacobi, and whether its blocks
    are grid-aligned for deduplication (prealps_tpu/parallel/driver.py:
    246-264): ``block_size // br`` rounded down to a multiple of 8 nodes,
    or with ``dedupe`` and a grid, the grid x-line (nx nodes) or z-slab
    (nx·ny) nearest ``block_size // br`` among those that divide the node
    count."""
    mbn = max(8, (int(block_size or 1024) // br // 8) * 8)
    if dedupe and grid is not None:
        target = max(1, int(block_size or 1024) // br)
        cands = [c for c in (int(grid[0]), int(grid[0]) * int(grid[1]))
                 if c > 1 and nodes % c == 0]
        if cands:
            return min(cands, key=lambda c: abs(c - target)), True
    return mbn, False


def _device_block_jacobi(ops, blocks_t, a_pad, mbn, dedupe, bj_dtype):
    """Device block Jacobi of lane-major operands (JAX driver :621-654):
    with grid-aligned blocks of which at most half are unique, one inverse
    per group ("bj_dedup"); else with bj_dtype="bf16" the bf16 5-D inverses
    ("bj_lane"); else flat f32 inverses ("bj_flat")."""
    br = ops.br
    grouping = csr_slab_groups(a_pad, mbn * br) if dedupe else None
    nb = ops.nrb // mbn
    if grouping is not None and len(grouping[0]) <= nb // 2:
        rep_idx, groups = grouping
        ops.inv_u = build_device_block_jacobi_grouped(blocks_t, ops.offsets,
                                                      mbn, rep_idx)
        ops.groups = block_groups(groups, blocks_t.device)
    elif bj_dtype == "bf16":
        ops.inv5 = build_device_block_jacobi(blocks_t, ops.offsets,
                                             mbn).to(torch.bfloat16)
    else:
        ops.inv_f = build_device_block_jacobi_flat(blocks_t, ops.offsets, mbn=mbn)


def _chebyshev(ops, a_pad, degree, kappa, dtype, device):
    """Chebyshev over the operands' a_apply, λ_max from a host power
    iteration on the padded matrix, times 1.05 (JAX driver :663-678)."""
    lam_max = power_lam_max_host(a_pad) * 1.05
    inv_diag = (1.0 / np.asarray(a_pad.diagonal(), dtype=np.float64)).astype(dtype)
    lane_major = ops.layout == "tbn"
    # (br, nrb) lane-major or (n_pad,): this shard's part
    inv_diag = np.ascontiguousarray(ops.local(ops.to_space(inv_diag)))
    ops.cheb = Chebyshev(inv_diag=torch.from_numpy(inv_diag).to(device),
                         lam_min=lam_max / kappa, lam_max=lam_max,
                         degree=int(degree), a_apply=ops.a_apply,
                         lane_major=lane_major)


def _stencil_operands(a, kind, br, block_size, grid, scale_d, dtype, device,
                      stage, layout=None, dedupe=False, bj_dtype="f32",
                      cheb=None, group=None):
    """Stencil path on lane-major panels: contiguous layout (or the
    caller's), flat block table, and the preconditioner: device block
    Jacobi (+ the bj2l coarse space) or Chebyshev. Over several shards the
    host build is global (every rank the same) and the device operands
    this rank's columns: its nodes of the block table, its block inverses
    and coarse modes (blocks never straddle a shard: rows are a multiple
    of mbn·br) and the replicated coarse inverse."""
    device_bj = kind in ("bj2l", "bj_device")
    nshards = size_of(group)
    # the grouped blocks only on one shard, as in the JAX driver
    mbn, dedupe = None, dedupe and kind == "bj_device" and nshards == 1
    if device_bj:
        mbn, dedupe = _bj_node_block(a.shape[0] // br, br, block_size, grid,
                                     dedupe)
    if layout is None:
        mult = math.lcm(8, br)
        if dedupe:
            # the exact slab split (n divides): rounding to a multiple of 8
            # as well would pad rows and break the slab alignment
            mult = mbn * br
        elif device_bj:
            mult = math.lcm(mult, mbn * br)
        layout = contiguous_row_layout(a.shape[0], nshards, row_multiple=mult)
    a_pad = permute_and_pad_matrix(a, layout)
    stage("layout")

    shard = rank_of(group)
    host = stencil_blocks_host(a_pad, br=br, dtype=dtype)
    if host is None:
        raise ValueError("matrix is not stencil-structured; use fmt='ell' or "
                         "'block_ell'")
    blocks_host, offsets = host
    s_off = len(offsets)
    nrb = layout.n_pad // br
    if max(abs(o) for o in offsets) > nrb:
        raise ValueError(f"stencil halo exceeds the node count {nrb}")
    # flat (S·br², nrb) table: row s·br² + m·br + k; this shard's nodes
    nrb_loc = layout.rows_per_shard // br
    blocks_flat = torch.from_numpy(np.ascontiguousarray(
        blocks_host[shard * nrb_loc:(shard + 1) * nrb_loc]
        .transpose(1, 2, 3, 0).reshape(s_off * br * br, nrb_loc)
    )).to(device)
    del blocks_host
    _sync(device)
    stage("fmt_convert")

    ops = StencilOperands(blocks_flat=blocks_flat, offsets=offsets, br=br)
    ops.group, ops.shard = group, shard
    blocks_t = blocks_flat.reshape(s_off, br, br, nrb_loc)
    if kind == "bj_device":
        _device_block_jacobi(ops, blocks_t, a_pad, mbn, dedupe, bj_dtype)
    elif kind == "bj2l":
        ops.inv_f = build_device_block_jacobi_flat(blocks_t, offsets, mbn=mbn)
        nb = ops.inv_f.shape[0]          # this shard's blocks
        mb = br * mbn
        # the coarse space and its inverse are global (every rank the same)
        d_pad = pad_to_padded(layout, scale_d) if scale_d is not None else None
        if grid is not None:
            y5 = geometric_rbm_modes(grid, br, nrb, mbn, scale_d=d_pad, q=Q_MODES)
        else:
            y5 = translation_modes(nrb // mbn, mbn, br, d_pad)
        ac = coarse_matrix_host(a_pad, y5, br)
        # padded rows carry identity blocks; their modes can make A_c
        # ill-conditioned — regularise lightly
        nc = ac.shape[0]
        ac += 1e-10 * np.trace(ac) / nc * np.eye(nc)
        ac_inv = coarse_inverse_host(ac).astype(dtype)
        yq3 = np.ascontiguousarray(
            y5[shard * nb:(shard + 1) * nb].transpose(0, 3, 1, 2)
            .reshape(nb, -1, mb)).astype(dtype)
        ops.yq3 = torch.from_numpy(yq3).to(device)
        ops.ac_inv = torch.from_numpy(ac_inv).to(device)
    elif kind == "chebyshev":
        _chebyshev(ops, a_pad, *cheb, dtype, device)
    _sync(device)
    stage("precond")
    return layout, ops


def _dia_lane_operands(a, kind, block_size, grid, dtype, device, stage,
                       layout=None, dedupe=False, bj_dtype="f32", cheb=None,
                       group=None):
    """fmt="dia" on lane-major panels: partition layout (natural order on
    one shard, k-way over several) or the caller's, the promoted diagonals
    as a br = 1 flat block table, the ELL remainder, and device block
    Jacobi assembled from the diagonals or Chebyshev. Over several shards
    the host build is global and the device operands this rank's columns
    of the table and rows of the remainder, with its halo plan."""
    nshards = size_of(group)
    # the grouped blocks only on one shard, as in the JAX driver
    mbn, dedupe = None, dedupe and kind == "bj_device" and nshards == 1
    if kind == "bj_device":
        mbn, dedupe = _bj_node_block(a.shape[0], 1, block_size, grid, dedupe)
    if layout is None:
        mult = math.lcm(8, mbn) if mbn is not None else 8
        layout = build_row_layout(a, nshards, row_multiple=mult)
    a_pad = permute_and_pad_matrix(a, layout)
    stage("layout")

    shard = rank_of(group)
    mat, send_idx = _dia_shard(a_pad, layout, shard, dtype, device)
    ops = DiaLaneOperands(blocks_flat=mat.diags, offsets=mat.offsets, br=1,
                          rem_send_idx=send_idx)
    if mat.rem is not None:
        ops.rem_vals, ops.rem_cols = mat.rem.vals, mat.rem.cols
    ops.group, ops.shard = group, shard
    _sync(device)
    stage("fmt_convert")

    if kind == "bj_device":
        # from the promoted diagonals only: remainder entries inside a block
        # are left out of the preconditioner, as in the JAX driver
        diags_t = ops.blocks_flat.reshape(len(ops.offsets), 1, 1, -1)
        _device_block_jacobi(ops, diags_t, a_pad, mbn, dedupe, bj_dtype)
    elif kind == "chebyshev":
        _chebyshev(ops, a_pad, *cheb, dtype, device)
    _sync(device)
    stage("precond")
    return layout, ops


def _general_operands(a, fmt, kind, br, block_size, nblocks_per_shard,
                      bell_bk, dtype, device, stage, layout=None, cheb=None,
                      group=None):
    """Row-major panels: partition layout (stencil: contiguous) or the
    caller's, ELL / block-ELL / DIA+ELL / stencil, host block Jacobi or
    Chebyshev. Over several shards the host build is global and the device
    operands this rank's rows, with the exchange of its format: a halo
    plan's all-to-all (ELL, block-ELL at bk 128, the DIA remainder), the
    ring of the DIA diagonals, the all-gather of the stencil."""
    nshards = size_of(group)
    bell = fmt in ("block_ell", "block_ell_xla")
    if layout is None and fmt == "stencil":
        layout = contiguous_row_layout(a.shape[0], nshards,
                                       row_multiple=math.lcm(8, br))
    elif layout is None:
        # block-ELL moves whole bk = 128 column blocks: rows pad to 128
        layout = build_row_layout(a, nshards, row_multiple=128 if bell else 8)
    a_pad = permute_and_pad_matrix(a, layout)
    stage("layout")

    shard = rank_of(group)
    send_idx = None
    if fmt == "stencil":
        mat = _stencil_nt_shard(a_pad, layout, shard, br, dtype, device)
    elif bell:
        mat, send_idx = _block_ell_shard(a_pad, layout, shard, bell_bk, dtype,
                                         device)
    elif fmt == "dia":
        mat, send_idx = _dia_shard(a_pad, layout, shard, dtype, device)
    else:
        mat, send_idx = _ell_shard(a_pad, layout, shard, dtype, device)
    _sync(device)
    stage("fmt_convert")

    bj = None
    if kind == "bj":
        if block_size is not None:
            nblocks_per_shard = max(1, -(-layout.rows_per_shard // block_size))
        bj = build_sharded_block_jacobi(a_pad, layout, nblocks_per_shard,
                                        dtype=dtype, device=device, shard=shard)
    if fmt == "stencil":
        ops = StencilNtOperands(mat=mat, bj=bj)
    elif bell:
        ops = BlockEllOperands(mat=mat, bj=bj, kernel=fmt == "block_ell",
                               send_idx=send_idx)
    elif fmt == "dia":
        ops = DiaOperands(mat=mat, bj=bj, send_idx=send_idx)
    else:
        ops = EllOperands(mat=mat, bj=bj, send_idx=send_idx)
    ops.group, ops.shard = group, shard
    if kind == "chebyshev":
        _chebyshev(ops, a_pad, *cheb, dtype, device)
    _sync(device)
    stage("precond")
    return layout, ops


def _ell_shard(a_pad, layout, shard, dtype, device):
    """The ELL operator of a padded CSR matrix (the operator, or the DIA
    remainder) and, over several shards, this shard's rows with columns in
    [own rows ∥ halo buffer] coordinates and its row of the halo plan's
    send lists (JAX driver :352-366, :405-419); (matrix, send_idx or
    None)."""
    if layout.nshards == 1:
        return csr_to_ell(a_pad, dtype=dtype, device=device), None
    ell = csr_to_ell(a_pad, dtype=dtype, device="cpu")
    plan = build_halo_plan(layout, ell.cols.numpy(), ell.vals.numpy())
    mpl = layout.rows_per_shard
    rows = slice(shard * mpl, (shard + 1) * mpl)
    mat = EllMatrix(ell.vals[rows].contiguous().to(device),
                    torch.from_numpy(plan.cols_local[rows]).to(device),
                    (mpl, mpl + layout.nshards * plan.h))
    return mat, halo_send_row(plan.send_idx, shard, device)


def halo_send_row(send_idx: np.ndarray, shard, device) -> torch.Tensor:
    """This shard's row (S, h) of a halo plan's send lists, as indices."""
    return torch.from_numpy(send_idx[shard].astype(np.int64)).to(device)


def _block_ell_shard(a_pad, layout, shard, bell_bk, dtype, device):
    """The block-ELL operator (bm 8; bk ``bell_bk`` on one shard, 128 over
    several) and, over several shards, this shard's row blocks with block
    columns in [own blocks ∥ halo buffer] coordinates and its row of the
    block halo plan's send lists (JAX driver :460-487); (matrix, send_idx
    or None)."""
    if layout.nshards == 1:
        return csr_to_block_ell(a_pad, bm=8, bk=bell_bk, dtype=dtype,
                                device=device), None
    bk = 128
    bell = csr_to_block_ell(a_pad, bm=8, bk=bk, dtype=dtype, device="cpu")
    plan = build_block_halo_plan(layout, bell.blkcols.numpy(),
                                 bell.blocks.numpy(), bk=bk)
    mpl = layout.rows_per_shard
    rows = slice(shard * mpl // 8, (shard + 1) * mpl // 8)
    mat = BlockEllMatrix(bell.blocks[rows].contiguous().to(device),
                         torch.from_numpy(plan.blkcols_local[rows]).to(device),
                         (mpl, mpl + layout.nshards * plan.hb * bk))
    return mat, halo_send_row(plan.send_idx, shard, device)


def _dia_shard(a_pad, layout, shard, dtype, device):
    """Hybrid DIA+ELL of this shard: its columns of the (D, n_pad)
    diagonals and its rows of the remainder, over several shards through
    the remainder's halo plan (JAX driver :340-373, :425-459); (matrix,
    remainder send_idx or None). The rule of both layouts' DIA."""
    offsets, diags, rem = dia_ell_host(a_pad, min_fill=0.05, dtype=dtype)
    mpl = layout.rows_per_shard
    diags = torch.from_numpy(np.ascontiguousarray(
        diags[:, shard * mpl:(shard + 1) * mpl])).to(device)
    rem_mat, send_idx = (None, None) if rem is None else _ell_shard(
        rem, layout, shard, dtype, device)
    return DiaEllMatrix(offsets=offsets, diags=diags, rem=rem_mat,
                        shape=(mpl, mpl)), send_idx


def _stencil_nt_shard(a_pad, layout, shard, br, dtype, device):
    """The node-major stencil blocks of this shard's nodes (all of them on
    one shard), of shape (rows_per_shard, n_pad): the product reads the
    gathered global panel."""
    host = stencil_blocks_host(a_pad, br=br, dtype=dtype)
    if host is None:
        raise ValueError("matrix is not stencil-structured; use fmt='ell' or "
                         "'block_ell'")
    blocks, offsets = host
    nrb_loc = layout.rows_per_shard // br
    blocks = torch.from_numpy(np.ascontiguousarray(
        blocks[shard * nrb_loc:(shard + 1) * nrb_loc])).to(device)
    return StencilBsrMatrix(blocks, offsets, (layout.rows_per_shard, layout.n_pad))


def _pinned_layout(a, parts, fmt, pre_perm, layout, row_multiple, nshards=1):
    """The row layout of a pinned partition (one part id per row), with the
    JAX driver's checks (prealps_tpu/parallel/driver.py:265-294)."""
    if fmt == "stencil":
        raise ValueError(
            "parts= (pinned partition) cannot be combined with fmt='stencil': "
            "the row permutation destroys the constant-offset structure — use "
            "fmt='auto'/'ell'")
    if layout is not None:
        raise ValueError("pass either parts= or layout=, not both")
    if pre_perm is not None:
        raise ValueError("fmt='auto' chose a clustering permutation; pinned "
                         "partitions require fmt='ell'/'dia'/'block_ell'")
    parts = np.asarray(parts, dtype=np.int64).ravel()
    if parts.shape[0] != a.shape[0]:
        raise ValueError(f"partition has {parts.shape[0]} entries for a "
                         f"{a.shape[0]}-row matrix")
    if parts.min() < 0 or parts.max() >= nshards:
        raise ValueError(f"part ids must lie in [0, {nshards}); got "
                         f"[{parts.min()}, {parts.max()}]")
    return layout_from_part(a, parts, nshards, row_multiple=row_multiple)


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
    group: Optional[object] = None         # process group over the shards

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
        layout: Optional[RowLayout] = None,
        fmt: str = "ell",
        br: int = 3,
        refine: Optional[bool] = None,
        inner_tol: float = 1e-3,
        cheb_degree: int = 8,
        cheb_kappa: float = 30.0,
        bj_dtype: str = "f32",
        grid: Optional[tuple] = None,
        bj_dedupe: bool = True,
        parts: Optional[np.ndarray] = None,
        auto_layout: bool = True,
        device="cuda",
        group=None,
    ) -> "DistributedECG":
        """Build the solver on ``device`` (default "cuda", which raises
        when there is no card; pass device="cpu" to run on the host). The
        other defaults are the JAX driver's: fmt="ell", precond=
        "block_jacobi", one block-Jacobi block per shard unless block_size
        is given, Chebyshev of degree 8 with κ 30, and on lane-major panels
        with ``grid=`` deduplicated block Jacobi (``bj_dedupe``). With
        fmt="auto", ``auto_layout`` picks the layout for the detected
        format; False keeps ``opts.layout`` wherever it is valid. ``parts``
        pins the row partition (one part id per row; all zeros on one
        shard) and ``layout`` hands over a whole ``RowLayout``; neither
        goes with the stencil format's own layout.

        Over several shards every rank of ``group`` (a ``torch.distributed``
        group of ``nshards`` ranks, ``parallel/mesh.py``) calls ``build``
        with the same arguments; ``device="cuda"`` is then ``cuda:{rank}``,
        and ranks that share a card name it and use a gloo group."""
        world = size_of(group)
        nshards = world if nshards is None else int(nshards)
        if nshards != world:
            raise ValueError(
                f"nshards={nshards} needs a process group of {nshards} ranks; "
                f"got {'no group' if group is None else f'{world} ranks'}")
        if layout is not None and layout.nshards != nshards:
            raise ValueError(f"the layout has {layout.nshards} shards; "
                             f"nshards={nshards}")
        if group is None:
            device = resolve_device(device)
        else:
            device = shard_device(device, rank_of(group))
            check_backend_device(backend_of(group), world, device,
                                 rank_of(group))
        strict_fp32()
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
            fmt, opts, a, pre_perm, fmt_info, bell_bk = _detect(
                a, br, opts, auto_layout, precond, device, parts is not None,
                nshards)
            stage("detect")
        kind = _check_options(fmt, precond, opts.layout)

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
        lane_major = opts.layout == "tbn"
        # a pinned partition's rows pad to the format's row multiple and,
        # for the device block Jacobi of DIA, to whole blocks
        if parts is not None:
            mult = 128 if fmt in ("block_ell", "block_ell_xla") else 8
            if lane_major and kind in ("bj2l", "bj_device"):
                mbn, _ = _bj_node_block(a.shape[0], 1, block_size, grid,
                                        bj_dedupe and kind == "bj_device")
                mult = math.lcm(mult, mbn)
            layout = _pinned_layout(a, parts, fmt, pre_perm, layout, mult,
                                    nshards)
        cheb = (cheb_degree, cheb_kappa)
        if fmt == "stencil" and lane_major:
            layout, operands = _stencil_operands(
                a, kind, br, block_size, grid, scale_d, dtype, device, stage,
                layout=layout, dedupe=bj_dedupe, bj_dtype=bj_dtype, cheb=cheb,
                group=group)
        elif fmt == "dia" and lane_major:
            layout, operands = _dia_lane_operands(
                a, kind, block_size, grid, dtype, device, stage, layout=layout,
                dedupe=bj_dedupe, bj_dtype=bj_dtype, cheb=cheb, group=group)
        else:
            layout, operands = _general_operands(
                a, fmt, kind, br, block_size, nblocks_per_shard, bell_bk,
                dtype, device, stage, layout=layout, cheb=cheb, group=group)
        return cls(
            layout=layout, opts=opts, scale_d=scale_d, operands=operands,
            device=device, dtype=dtype, target_tol=target_tol,
            a_scaled=a if refine else None, timings=tb, pre_perm=pre_perm,
            fmt_info=fmt_info, group=group,
        )

    def _ecg(self, rhs: torch.Tensor) -> ECGResult:
        ops = self.operands
        return ecg_solve(ops.a_apply, ops.m_apply, rhs, self.opts,
                         split_assign=ops.split_assign(self.opts.t,
                                                       self.layout.n_pad),
                         group=self.group)

    def _to_shard(self, v_pad: np.ndarray) -> torch.Tensor:
        """This shard's part of a padded global vector, in the operands'
        space, on the device."""
        ops = self.operands
        return torch.from_numpy(np.ascontiguousarray(
            ops.local(ops.to_space(v_pad)))).to(self.device)

    def _from_shards(self, x: torch.Tensor) -> np.ndarray:
        """The padded global vector from every shard's part of x (the same
        on every rank)."""
        ops = self.operands
        return ops.from_space(ops.gather(x).cpu().numpy())

    # --- solves ---------------------------------------------------------

    def _solve_scaled_once(self, b_eff: np.ndarray):
        """One device ECG solve of the scaled, padded system."""
        b_pad = pad_to_padded(self.layout, b_eff.astype(self.dtype))
        res = self._ecg(self._to_shard(b_pad))
        x = unpad_from_padded(self.layout, self._from_shards(res.x))
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

        b = b_hi + b_lo (double-float, this shard's part in the operands'
        space: (br, nrb) lane-major or (n_pad,) row-major). Each round
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
            return torch.sqrt(psum(torch.sum(v * v), self.group))

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
        b_pad = pad_to_padded(self.layout, b_eff)                # f64
        b_hi = b_pad.astype(np.float32)
        b_lo = (b_pad - b_hi.astype(np.float64)).astype(np.float32)
        xh, xl, info = self.local_refine(self._to_shard(b_hi),
                                         self._to_shard(b_lo))
        x_np = (self._from_shards(xh).astype(np.float64)
                + self._from_shards(xl).astype(np.float64))
        x = unpad_from_padded(self.layout, x_np)
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
