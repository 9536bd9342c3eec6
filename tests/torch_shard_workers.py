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
from prealps_tpu_torch.interop import (
    distributed_lorasc_from_reference,
    solver_from_reference,
)
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


def operand_facts(s):
    """What the tests hold of a sharded build's operands: the
    preconditioner kind, the padded size, the operands' class, the
    ``fmt="auto"`` choice, the shape of this shard's row-major operator,
    the columns of its extended operator (block-ELL, the DIA remainder),
    the stencil or DIA offsets."""
    ops = s.operands
    mat = getattr(ops, "mat", None)
    rem = getattr(mat, "rem", None)
    facts = {"kind": ops.precond_kind, "n_pad": s.layout.n_pad,
             "operands": type(ops).__name__,
             "chosen": (s.fmt_info or {}).get("chosen"),
             "layout": ops.layout}
    if mat is not None:
        facts.update(mat_shape=tuple(mat.shape))
    if hasattr(mat, "blkcols"):
        facts.update(ext_cols=mat.shape[1], s_max=int(mat.blocks.shape[1]),
                     bk=mat.bk)
    offsets = getattr(mat, "offsets", getattr(ops, "offsets", None))
    if offsets is not None:
        facts.update(offsets=tuple(offsets))
    if rem is not None:
        facts.update(rem_ext_cols=rem.shape[1])
    if getattr(ops, "rem_cols", None) is not None:
        facts.update(rem_width=int(ops.rem_vals.shape[1]))
    return facts


def format_solves(rank, group, a, b, cases):
    """``DistributedECG.build(nshards=world, group=group, device="cpu")`` and
    ``solve(b)`` for each case (name -> build keywords, ``opts`` a dict of
    ECGOptions fields); returns name -> (x, info without the history,
    ``operand_facts``)."""
    world = mesh.size_of(group)
    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        opts = ECGOptions(**kw.pop("opts"))
        s = DistributedECG.build(a, nshards=world, opts=opts, device="cpu",
                                 group=group, **kw)
        x, info = s.solve(b)
        info.pop("history")
        out[name] = (x, info, operand_facts(s))
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


def reference_applies(rank, group, refs, b, vectors):
    """``solver_from_reference`` on each JAX sharded build's operands (name
    -> (arrays, meta)): M·A·v for each of ``vectors`` (original ordering,
    scaled space; through ``_solve_scaled_once`` with ``ecg_solve``
    replaced by the preconditioned product, as
    ``sharded_cases.jax_driver_applies`` does on the JAX side), then
    ``solve(b)``; returns name -> (the M·A·v, x, iterations)."""
    from prealps_tpu_torch.parallel import driver

    out = {}
    for name, (arrays, meta) in refs.items():
        s = solver_from_reference(arrays, meta, device="cpu", group=group)
        real = driver.ecg_solve
        driver.ecg_solve = _product_only
        try:
            ys = [s._solve_scaled_once(v)[0] for v in vectors]
        finally:
            driver.ecg_solve = real
        x, info = s.solve(b)
        out[name] = (ys, x, info["iters"])
    return out


def _product_only(a_apply, m_apply, b, opts, split_assign=None, group=None):
    """An ``ecg_solve`` stand-in that returns M·A·b as its x, on row-major
    (n,) or lane-major (br, nrb) shards."""
    from prealps_tpu_torch.solvers.ecg import ECGResult

    p = b[:, None] if b.dim() == 1 else b[None]
    y = m_apply(a_apply(p))
    z = torch.zeros((), dtype=b.dtype)
    return ECGResult(x=y[:, 0] if b.dim() == 1 else y[0], iters=0, res=z, normb=z,
                     bs=0, breakdown=False, history=z[None])


def lorasc_solves(rank, group, a, b, cases):
    """``DistributedLorascECG.build(group=group, device="cpu")`` and
    ``solve(b)`` for each case (name -> build keywords, ``opts`` a dict of
    ECGOptions fields, ``mesh_shape`` or ``nshards``); returns name -> (x,
    info, ng_max, ni_max, sigma)."""
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG

    out = {}
    for name, kw in cases.items():
        kw = dict(kw)
        opts = ECGOptions(**kw.pop("opts"))
        s = DistributedLorascECG.build(a, opts=opts, device="cpu", group=group, **kw)
        x, info = s.solve(b)
        out[name] = (x, info, s.ng_max, s.ni_max, s.ops["sigma"].cpu().numpy())
    return out


def lorasc_refusals(rank, group, a, cases):
    """The build of each case (name -> build keywords) over the group;
    returns name -> (exception type name, message), or None if it built."""
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG

    out = {}
    for name, kw in cases.items():
        try:
            DistributedLorascECG.build(a, device="cpu", group=group, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _apply_only(a_apply, m_apply, b, opts, split_assign=None, group=None):
    """An ``ecg_solve`` stand-in that returns M·b as its x."""
    from prealps_tpu_torch.solvers.ecg import ECGResult

    z = torch.zeros((), dtype=b.dtype)
    return ECGResult(x=m_apply(b[:, None])[:, 0], iters=0, res=z, normb=z, bs=0,
                     breakdown=False, history=z[None])


def lorasc_reference_applies(rank, group, refs, b, vectors):
    """``distributed_lorasc_from_reference`` on each JAX build's operands
    (name -> (arrays, meta)): the preconditioner on each of ``vectors``
    (original ordering, scaled space; through ``_solve_scaled_once`` with
    ``ecg_solve`` replaced by M·b, as ``sharded_cases.jax_lorasc_applies``
    does on the JAX side), then ``solve(b)``; returns name -> (the M·v, x,
    info)."""
    from prealps_tpu_torch.parallel import lorasc_driver

    out = {}
    for name, (arrays, meta) in refs.items():
        s = distributed_lorasc_from_reference(arrays, meta, device="cpu", group=group)
        real = lorasc_driver.ecg_solve
        lorasc_driver.ecg_solve = _apply_only
        try:
            ys = [s._solve_scaled_once(v)[0] for v in vectors]
        finally:
            lorasc_driver.ecg_solve = real
        x, info = s.solve(b)
        out[name] = (ys, x, info)
    return out


def banded_two_level(rank, group, d, e, v, device="cpu"):
    """The two-level solve of the factored (d, e) over the group on
    ``device``: every rank its bs/L rows of the folded factors, the whole
    v; returns the solution and ``prepare_two_level``'s arrays (whole), on
    the host."""
    from prealps_tpu_torch.direct.banded import (
        block_banded_cholesky,
        block_banded_solve_two_level,
        prepare_two_level,
    )

    world = mesh.size_of(group)
    dev = torch.device(device)
    fac2 = prepare_two_level(block_banded_cholesky(torch.from_numpy(d).to(dev),
                                                   torch.from_numpy(e).to(dev)))
    rows = d.shape[2] // world
    mine = fac2.rows(rank * rows, (rank + 1) * rows)
    w = block_banded_solve_two_level(mine, torch.from_numpy(v).to(dev), group)
    return w.cpu().numpy(), {k: getattr(fac2, k).cpu().numpy() for k in
                             ("l_inv", "w_fwd", "l_inv_t", "w_bwd")}


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


def card_solve(rank, group, a, b, case, device, kernel="stencil_flat_ext"):
    """A sharded f32 solve on ``device`` (cuda:0, shared by the ranks, or
    the CPU); returns (x, info without the history, the launches of the
    ``kernel`` wrapper of ``ops/spmm.py`` during the solve)."""
    kw = dict(case)
    opts = ECGOptions(**kw.pop("opts"))
    s = DistributedECG.build(a, nshards=mesh.size_of(group), opts=opts,
                             device=device, group=group, **kw)
    counter = getattr(spmm, kernel)
    before = counter.launches
    x, info = s.solve(b)
    info.pop("history")
    return x, info, counter.launches - before


def card_graph_steps(rank, group, a, b, case):
    """``card_solve`` on cuda:0 through the group: (iterations, the change of
    the ``ecg.graph_steps`` counter), 0 where the step ran eager."""
    from prealps_tpu_torch.utils import timing

    before = timing.COUNTERS["ecg.graph_steps"]
    _, info, _ = card_solve(rank, group, a, b, case, "cuda:0")
    return info["iters"], timing.COUNTERS["ecg.graph_steps"] - before


def card_lorasc_solve(rank, group, a, b, case, device):
    """A DistributedLorascECG build over the group on ``device`` (cuda:0,
    shared by the ranks, or the CPU) and its solve; returns (x, info, the
    device type of the operands)."""
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG

    kw = dict(case)
    opts = ECGOptions(**kw.pop("opts"))
    s = DistributedLorascECG.build(a, opts=opts, device=device, group=group, **kw)
    x, info = s.solve(b)
    return x, info, s.ops["ell_vals"].device.type


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


def lorasc_f32_stages(rank, group, a, b, case, arrays, meta):
    """The f32 distributed LORASC build stage by stage, for
    ``tests/dlorasc_f32_stages.py``: the Lanczos Ritz values and residual
    estimates, theta / bnorm2 / resid after Rayleigh-Ritz, deflated and
    sigma, and each refinement round's iterations of the solves on the
    port's own operands, on the JAX build's (``arrays``, ``meta``), on each
    with the other's Ritz basis and sigma, and on the port's with sigma
    scaled by 1 ± 1e-4. Returns a dict of numpy values (rank 0's)."""
    import prealps_tpu_torch.parallel.lorasc_driver as ld

    rec, rounds = {}, []
    lanczos = {name: getattr(ld, name) for name in
               ("block_lanczos_thick_restart", "lanczos_thick_restart", "lanczos_gen")}
    refine, solve = ld.rayleigh_ritz_refine, ld.ecg_solve

    def traced(name, fn):
        def run(*args, **kw):
            res = fn(*args, **kw)
            rec["lanczos"] = name
            rec["ritz"] = res.eigvalues.numpy()
            rec["ritz_resid"] = res.resid.numpy()
            return res
        return run

    def rr(*args, **kw):
        out = refine(*args, **kw)
        rec.update(zip(("theta", "vecs", "bnorm2", "resid"), (t.numpy() for t in out)))
        return out

    def counted(*args, **kw):
        res = solve(*args, **kw)
        rounds.append(int(res.iters))
        return res

    for name, fn in lanczos.items():
        setattr(ld, name, traced(name, fn))
    ld.rayleigh_ritz_refine, ld.ecg_solve = rr, counted
    try:
        kw = dict(case)
        opts = ECGOptions(**kw.pop("opts"))

        def own():
            return ld.DistributedLorascECG.build(a, opts=opts, device="cpu",
                                                 group=group, **kw)

        def ref():
            return distributed_lorasc_from_reference(arrays, meta, device="cpu",
                                                     group=group)

        def rounds_of(s):
            rounds.clear()
            x, info = s.solve(b)
            return int(info["iters"]), list(rounds)

        s_own = own()
        out = {k: rec[k] for k in ("lanczos", "ritz", "ritz_resid", "theta", "bnorm2",
                                   "resid")}
        out.update(deflated=s_own.deflated, sigma=s_own.ops["sigma"].numpy(),
                   own=rounds_of(s_own))
        s_ref = ref()
        out["ref"] = rounds_of(s_ref)
        out["ops_equal"] = sorted(k for k, v in s_own.ops.items()
                                  if isinstance(v, torch.Tensor) and k in s_ref.ops
                                  and torch.equal(v, s_ref.ops[k]))
        pair = ("e_mat", "sigma")
        for name, (dst, src) in {"own_with_ref_pairs": (own(), s_ref),
                                 "ref_with_own_pairs": (ref(), s_own)}.items():
            for k in pair:
                dst.ops[k] = src.ops[k]
            out[name] = rounds_of(dst)
        for eps in (1e-4, -1e-4):
            s = own()
            s.ops["sigma"] = s.ops["sigma"] * (1 + eps)
            out[f"own_sigma_{eps:+g}"] = rounds_of(s)
        return out
    finally:
        for name, fn in lanczos.items():
            setattr(ld, name, fn)
        ld.rayleigh_ritz_refine, ld.ecg_solve = refine, solve


def cli_runs(rank, group, runs):
    """Each (command, argv) of ``runs`` through the port's CLI on this
    rank's group: (exit code, standard output) per run."""
    import contextlib
    import io

    from prealps_tpu_torch import cli

    out = []
    for command, argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.COMMANDS[command](argv)
        out.append((rc, buf.getvalue()))
    return out


def _low_rank_plus_noise(rng, m, n, rank, noise=1e-6):
    """tests/test_tournament_dist.py's generator."""
    u = rng.standard_normal((m, rank))
    v = rng.standard_normal((rank, n))
    scale = np.logspace(0, -3, rank)[:, None]
    return u @ (scale * v) + noise * rng.standard_normal((m, n))


def lx_inputs():
    """The sharded LX cases' global inputs, each JAX test's from its own
    default_rng(42): (the TSQR panel, selection cases name -> (a, k), TP-QR
    cases, the planted columns of "dominant")."""
    tsqr_x = np.random.default_rng(42).standard_normal((512, 4))
    rng = np.random.default_rng(42)
    dominant = _low_rank_plus_noise(rng, 96, 64, rank=6)
    pos = np.array([0, 11, 22, 33, 44, 55])
    dominant[:, pos] = rng.standard_normal((96, 6)) * 50.0
    quality = _low_rank_plus_noise(np.random.default_rng(42), 80, 48, rank=16,
                                   noise=1e-3)
    qr = _low_rank_plus_noise(np.random.default_rng(42), 120, 64, rank=10,
                              noise=1e-9)
    return tsqr_x, {"dominant": (dominant, 6), "quality": (quality, 8)}, \
        {"tp_qr": (qr, 10)}, pos


def lx_sharded(rank, group):
    """The sharded communication-avoiding kernels on this rank's part of
    ``lx_inputs``: ``tsqr_r_distributed`` on its rows of the TSQR panel,
    ``tournament_select_sharded`` on its columns of each selection case and
    ``tp_qr_sharded`` on each TP-QR case; returns their results as numpy,
    with the collective counts of the whole job."""
    from prealps_tpu_torch.ops.tournament import tournament_select_sharded, tp_qr_sharded
    from prealps_tpu_torch.ops.tsqr import tsqr_r_distributed

    tsqr_x, select_cases, qr_cases, _ = lx_inputs()
    world = mesh.size_of(group)
    mesh.all_gather.calls = 0

    def rows(x):
        m = x.shape[0] // world
        return torch.from_numpy(np.ascontiguousarray(x[rank * m:(rank + 1) * m]))

    def cols(a):
        n = a.shape[1] // world
        return torch.from_numpy(np.ascontiguousarray(a[:, rank * n:(rank + 1) * n]))

    out = {"tsqr_r": tsqr_r_distributed(rows(tsqr_x), group).numpy()}
    for name, (a, k) in select_cases.items():
        out[name] = tournament_select_sharded(cols(a), group, k).numpy()
    for name, (a, k) in qr_cases.items():
        q, r_loc, c = tp_qr_sharded(cols(a), group, k)
        out[name] = (q.numpy(), r_loc.numpy(), c.numpy())
    out["all_gather_calls"] = mesh.all_gather.calls
    return out


def ablation(rank, group, world, case):
    """The timing ablation (``PREALPS_TIMING_NO_COLLECTIVES``) on a
    ``world``-rank subgroup of ``group`` (ranks below ``world``; the others
    only join the subgroup's creation): one build on elasticity3d(6, 5, 5)
    with b = default_rng(0), then solves with the knob unset, set to 0 and
    set to 1 (unset again after). Returns the three x, their iteration
    counts and the collective calls of each solve."""
    import os

    import torch.distributed as dist

    from prealps_tpu_torch.core.generators import elasticity3d

    a = elasticity3d(6, 5, 5)
    b = np.random.default_rng(0).standard_normal(a.shape[0])

    sub = dist.new_group([dist.get_global_rank(group, r) for r in range(world)])
    if rank >= world:
        return None
    kw = dict(case)
    opts = ECGOptions(**kw.pop("opts"))
    s = DistributedECG.build(a, nshards=world, opts=opts, device="cpu", group=sub, **kw)
    counters = (mesh.all_reduce, mesh.all_gather, mesh.ring_exchange, mesh.all_to_all)
    out = {}
    for name, knob in (("plain", None), ("off", "0"), ("on", "1")):
        for f in counters:
            f.calls = 0
        if knob is not None:
            os.environ["PREALPS_TIMING_NO_COLLECTIVES"] = knob
        try:
            x, info = s.solve(b)
        finally:
            os.environ.pop("PREALPS_TIMING_NO_COLLECTIVES", None)
        out[name] = (x, int(info["iters"]), {f.__name__: f.calls for f in counters})
    return out
