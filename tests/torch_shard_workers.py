"""Rank functions of the port's multi-process tests (gloo on the CPU).

``prealps_tpu_torch.parallel.mesh.spawn`` runs each of these in a new
process, one per rank; the test files hold the results against numpy and
against the JAX package in the parent process. This module imports only
numpy, scipy, torch and the port: the ranks never import JAX.

Each function takes (rank, group, *args) and returns picklable results.
"""

import time

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.core.layout import build_row_layout, permute_and_pad_matrix
from prealps_tpu_torch.interop import solver_from_reference
from prealps_tpu_torch.ops.blockops import psum
from prealps_tpu_torch.ops import spmm
from prealps_tpu_torch.ops.spmm import extend_ring, extend_wrap
from prealps_tpu_torch.parallel import mesh
from prealps_tpu_torch.parallel.driver import DistributedECG, EllOperands, _ell_shard
from prealps_tpu_torch.solvers.ecg import ECGOptions


def global_panel(seed, rows, nodes):
    """The global (rows, nodes) panel every rank cuts its shard from."""
    return np.random.default_rng(seed).standard_normal((rows, nodes))


def collectives(rank, group, nrb_loc, halos, ell_matrix):
    """Each collective on this rank's part of seeded global arrays:
    ``extend_ring`` at every halo (ring exchange or, past nrb_loc, the
    all-gather branch), ``psum``, the tiled ``all_gather``, the raw
    ``all_to_all`` and the ELL operands' exchange and product."""
    world = mesh.size_of(group)
    out = {"rank": rank, "world": world}
    x = global_panel(1, 6, world * nrb_loc)
    xl = torch.from_numpy(np.ascontiguousarray(
        x[:, rank * nrb_loc:(rank + 1) * nrb_loc]))
    out["ring"] = {h: extend_ring(xl, h, group).numpy() for h in halos}
    out["ring_3d"] = extend_ring(xl.reshape(2, 3, nrb_loc), halos[0], group).numpy()
    part = torch.from_numpy(np.random.default_rng(10 + rank).standard_normal((3, 4)))
    out["psum"] = psum(part, group).numpy()
    out["psum_none"] = psum(part, None).numpy()
    out["all_gather"] = mesh.all_gather(xl, group, dim=1).numpy()
    send = torch.tensor([[rank * 100 + d, -(rank * 100 + d)] for d in range(world)],
                        dtype=torch.float64)[:, :, None].expand(world, 2, 3)
    out["all_to_all"] = mesh.all_to_all(send, group).numpy()

    # the ELL exchange: this shard's rows of A·x against the global product
    a = sp.csr_matrix(ell_matrix)
    lay = build_row_layout(a, world)
    a_pad = permute_and_pad_matrix(a, lay)
    mat, send_idx = _ell_shard(a_pad, lay, rank, np.float64, "cpu")
    ops = EllOperands(mat=mat, bj=None, send_idx=send_idx)
    ops.group, ops.shard = group, rank
    xg = global_panel(2, lay.n_pad, 3).reshape(lay.n_pad, 3)
    mpl = lay.rows_per_shard
    xs = torch.from_numpy(np.ascontiguousarray(xg[rank * mpl:(rank + 1) * mpl]))
    out["ell_y"] = ops.a_apply(xs).numpy()
    yh, yl = ops.a_apply_df(xs.float())
    out["ell_df"] = (yh.double() + yl.double()).numpy()
    out["ell_ref"] = (a_pad @ xg)[rank * mpl:(rank + 1) * mpl]
    out["calls"] = {f.__name__: f.calls for f in (mesh.all_reduce, mesh.all_gather,
                                                  mesh.ring_exchange, mesh.all_to_all)}
    return out


def solves(rank, group, a, b, cases):
    """``DistributedECG.build(nshards=world, group=group, device="cpu")`` and
    ``solve(b)`` for each case (name -> build keywords, ``opts`` a dict of
    ECGOptions fields); returns name -> (x, info without the history,
    preconditioner kind, n_pad, stencil halo and nodes a shard or None)."""
    world = mesh.size_of(group)
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        opts = ECGOptions(**kw.pop("opts"))
        s = DistributedECG.build(a, nshards=world, opts=opts, device="cpu",
                                 group=group, **kw)
        x, info = s.solve(b)
        info.pop("history")
        ops = s.operands
        shape = (ops.halo, ops.nrb) if hasattr(ops, "halo") else None
        out[name] = (x, info, ops.precond_kind, s.layout.n_pad, shape)
    return out


def refusals(rank, group, a, cases):
    """The build of each case (name -> build keywords) over the group;
    returns name -> (exception type name, message), or None if it built."""
    world = mesh.size_of(group)
    out = {}
    for name, kw in cases.items():
        try:
            DistributedECG.build(a, nshards=world, device="cpu", group=group,
                                 **kw)
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def several(rank, group, jobs):
    """Run each (function name, args) of ``jobs`` in this module in turn on
    one group; returns their results in order."""
    return [globals()[name](rank, group, *args) for name, args in jobs]


def reference_solves(rank, group, b, refs):
    """``solver_from_reference`` on a JAX sharded build's global operands
    (name -> (arrays, meta)), this rank's shard of them, and ``solve(b)``;
    returns name -> (x, iterations, f64 history up to them)."""
    out = {}
    for name, (arrays, meta) in refs.items():
        s = solver_from_reference(arrays, meta, device="cpu", group=group)
        x, info = s.solve(b)
        out[name] = (x, info["iters"], info["history"][: info["iters"]])
    return out


def fails(rank, group):
    """Rank 1 raises; rank 0 waits for it in an all-reduce."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.all_reduce(torch.ones(1), group)
    return rank


def hangs(rank, group):
    """Rank 0 never returns."""
    time.sleep(600 if rank == 0 else 0)
    return rank


# --- on the card (tests/test_torch_cuda.py): ranks that share cuda:0 ---


def card_ring(rank, group, nrb_loc, halos):
    """``extend_ring`` on CUDA panels through the gloo group (host copies)
    against ``extend_wrap`` of the global panel on the card: returns halo
    -> (device type of the result, bitwise equal)."""
    dev = torch.device("cuda", 0)
    world = mesh.size_of(group)
    x = torch.from_numpy(global_panel(3, 36, world * nrb_loc).astype(np.float32)).to(dev)
    xl = x[:, rank * nrb_loc:(rank + 1) * nrb_loc].contiguous()
    out = {}
    for h in halos:
        got = extend_ring(xl, h, group)
        lo = rank * nrb_loc
        want = extend_wrap(x, h)[:, lo:lo + nrb_loc + 2 * h]
        out[h] = (got.device.type, bool(torch.equal(got, want)))
    return out


def card_solve(rank, group, a, b, case, device):
    """A sharded f32 solve on ``device`` (cuda:0, shared by the ranks, or
    the CPU; device double-float rounds); returns (x, info without the
    history, B1 launches during the solve)."""
    kw = dict(case)
    opts = ECGOptions(**kw.pop("opts"))
    s = DistributedECG.build(a, nshards=mesh.size_of(group), opts=opts,
                             device=device, group=group, **kw)
    before = spmm.stencil_flat_ext.launches
    x, info = s.solve(b)
    info.pop("history")
    return x, info, spmm.stencil_flat_ext.launches - before


def card_build(rank, group, build_dir):
    """Load the kernels from ``build_dir`` (empty at the start, shared by
    the ranks); returns (the loaded sources, the sources this rank found
    built)."""
    from pathlib import Path

    from prealps_tpu_torch.ops import _kernels

    _kernels.BUILD_DIR = Path(build_dir)
    libs = _kernels.load()
    cached = sorted(src for src, info in _kernels.build_info.items()
                    if info["log"] == "(cached)")
    return sorted(libs), cached
