"""Command-line drivers: ECG with block Jacobi, and ECG with LORASC / PRESC.

The PyTorch counterpart of ``prealps_tpu/cli.py`` (reference:
examples/test_ecg_prealps_op.c, test_lorasc.c). Run as

    python -m prealps_tpu_torch.cli ecg    [options]   # ecg_main
    python -m prealps_tpu_torch.cli lorasc [options]   # lorasc_main

with the JAX commands' options (``prealps-ecg`` / ``prealps-lorasc``) and
one more, ``--device`` (default "cuda", which fails without a card; "cpu"
runs on the host). The run's dtype is f32 on a card and f64 on the CPU
unless ``--dtype`` says otherwise (the JAX rule with the card in the TPU's
place). Runs over several shards (``--nshards`` > 1, ``--np-level1``) run
one process a shard in a ``torch.distributed`` group: launched by
``torchrun --nproc-per-node N`` (NCCL on cards, one card a rank; gloo on
the CPU), or from inside a group that is already initialised; rank 0
prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _on_card(args) -> bool:
    return torch.device(args.device).type == "cuda"


def _resolve_layout(args):
    """Default layout: lane-major on a card where the format has the
    kernel, row-major elsewhere."""
    if args.layout is not None:
        return args.layout
    if args.fmt == "auto":
        return "nt"   # the driver re-resolves the layout for the detected fmt
    return "tbn" if (_on_card(args) and args.fmt in ("stencil", "dia")) else "nt"


def _load_matrix(args):
    from prealps_tpu_torch.core.generators import elasticity3d, poisson3d
    from prealps_tpu_torch.core.io import load_mtx

    if args.matrix:
        if not os.path.exists(args.matrix):
            raise SystemExit(f"error: matrix file not found: {args.matrix}")
        return load_mtx(args.matrix)
    try:
        nx, ny, nz = (int(v) for v in args.size.split("x"))
    except ValueError:
        raise SystemExit(f"error: --size must look like 12x10x10, got {args.size!r}")
    gen = elasticity3d if args.generate.startswith("ela") else poisson3d
    return gen(nx, ny, nz)


def _load_rhs(args, n):
    """b from --rhs, or standard normal from --seed."""
    if args.rhs:
        from prealps_tpu_torch.core.io import load_vector

        b = load_vector(args.rhs)
        if b.shape[0] != n:
            raise SystemExit(f"error: rhs length {b.shape[0]} != matrix size {n}")
        return b
    return np.random.default_rng(args.seed).standard_normal(n)


def _common_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("-m", "--matrix", help="MatrixMarket file (.mtx)")
    p.add_argument("--generate", default="ela", choices=["ela", "poisson"],
                   help="generated problem family when no matrix is given")
    p.add_argument("--size", default="12x10x10", help="elements per dim, e.g. 12x10x10")
    p.add_argument("-e", "--enlarging-factor", type=int, default=4, dest="t")
    p.add_argument("-o", "--ortho-alg", default="odir_fused",
                   choices=["omin", "odir", "odir_fused"])
    p.add_argument("-r", "--adaptive", action="store_true",
                   help="dynamic search-direction reduction (ADAPT_BS)")
    p.add_argument("--adaptive-mode", default="truncate",
                   choices=["truncate", "freeze"], dest="adaptive_mode")
    p.add_argument("-t", "--tol", type=float, default=1e-5)
    p.add_argument("-i", "--maxiter", type=int, default=10000)
    p.add_argument("--nshards", type=int, default=1)
    p.add_argument("--fmt", default="auto",
                   choices=["auto", "ell", "dia", "stencil", "block_ell",
                            "block_ell_xla"],
                   help="matrix storage format; auto detects the structure "
                        "(stencil, DIA, Morton block-ELL, ELL)")
    p.add_argument("--layout", default=None, choices=[None, "nt", "tbn"],
                   help="panel layout (default: tbn on a card for stencil/dia, "
                        "nt otherwise)")
    p.add_argument("--dtype", default=None, choices=[None, "f32", "f64"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rhs", help="right-hand-side vector file (one value per "
                   "line, '%%' comments); default: random with --seed")
    p.add_argument("--save-sol", help="write the solution vector to this file")
    p.add_argument("--partition-file", dest="partition_file",
                   help="pinned row partition (one part id per row, '%%' "
                        "comments; -1 marks separator rows for LORASC)")
    p.add_argument("--save-partition", dest="save_partition",
                   help="write the partition used to this file "
                        "(reloadable via --partition-file)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the residual history")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default, fails without a card) or cpu")
    return p


def _dtype_of(args):
    if args.dtype == "f32":
        return np.float32
    if args.dtype == "f64" or not _on_card(args):
        return np.float64
    return np.float32


def _group(args):
    """The process group of a run over several shards, else None."""
    if args.nshards <= 1 and not getattr(args, "np_level1", 0):
        return None
    import torch.distributed as dist

    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise SystemExit("error: --nshards > 1 runs one process a shard: "
                             "launch with torchrun --nproc-per-node N")
        from prealps_tpu_torch.parallel.mesh import init_group

        init_group("nccl" if _on_card(args) else "gloo")
    return dist.group.WORLD


def _is_root(group) -> bool:
    from prealps_tpu_torch.parallel.mesh import rank_of

    return rank_of(group) == 0


def _report(args, a, b, x, info, wall, group=None):
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    out = {"n": a.shape[0], "nnz": a.nnz, "iters": info["iters"],
           "relres": relres, "wall_s": round(wall, 4)}
    out.update({k: info[k] for k in ("bs", "breakdown", "refine_rounds",
                                     "fmt_chosen") if k in info})
    if _is_root(group):
        if args.save_sol:
            from prealps_tpu_torch.core.io import save_vector

            save_vector(args.save_sol, x)
        if args.json:
            print(json.dumps(out), flush=True)
        else:
            if args.verbose and "history" in info:
                h = info["history"]
                h = h[h >= 0]
                step = max(1, len(h) // 50)
                for i in range(0, len(h), step):
                    print(f"Iteration: {i:5d}  res: {h[i]:.6e}")
            for k, v in out.items():
                print(f"{k:>12}: {v}")
    return 0 if relres < 100 * args.tol else 1


def ecg_main(argv=None):
    """ECG + block Jacobi over DistributedECG (reference:
    examples/test_ecg_prealps_op.c)."""
    p = _common_parser("Enlarged CG with block-Jacobi preconditioning")
    p.add_argument("--nblocks-per-shard", type=int, default=1)
    p.add_argument("--precond", default="block_jacobi",
                   choices=["block_jacobi", "bj2l", "chebyshev", "none"],
                   help="bj2l = block Jacobi + geometric-RBM two-level coarse "
                        "space (generated grids, fmt=stencil, layout=tbn)")
    args = p.parse_args(argv)

    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a = _load_matrix(args)
    b = _load_rhs(args, a.shape[0])
    opts = ECGOptions(t=args.t, tol=args.tol, maxiter=args.maxiter,
                      variant=args.ortho_alg, adaptive=args.adaptive,
                      adaptive_mode=args.adaptive_mode,
                      layout=_resolve_layout(args))
    kwargs = {}
    if args.precond == "bj2l":
        if args.matrix or not args.generate.startswith("ela"):
            raise SystemExit("error: --precond bj2l needs a generated "
                             "elasticity grid (--generate ela --size ...)")
        nx, ny, nz = (int(v) for v in args.size.split("x"))
        kwargs["grid"] = (nx + 1, ny + 1, nz)   # node dims (generators.py)
    parts = None
    if args.partition_file:
        from prealps_tpu_torch.core.io import load_partition

        parts = load_partition(args.partition_file, a.shape[0])
    group = _group(args)
    solver = DistributedECG.build(
        a, nshards=args.nshards, opts=opts, precond=args.precond,
        nblocks_per_shard=args.nblocks_per_shard, dtype=_dtype_of(args),
        fmt=args.fmt, parts=parts, auto_layout=args.layout is None,
        device=args.device, group=group, **kwargs)
    if args.save_partition and _is_root(group):
        from prealps_tpu_torch.core.io import save_partition

        lay = solver.layout
        part = lay.inv_perm // lay.rows_per_shard
        if solver.pre_perm is not None:
            # fmt=auto's clustering permutation: back to the original rows
            part_orig = np.empty_like(part)
            part_orig[solver.pre_perm] = part
            part = part_orig
        save_partition(args.save_partition, part)
    t0 = time.time()
    x, info = solver.solve(b)
    if solver.fmt_info is not None:
        info = dict(info)
        info["fmt_chosen"] = solver.fmt_info.get("chosen")
    return _report(args, a, b, x, info, time.time() - t0, group)


def lorasc_main(argv=None):
    """ECG + LORASC / PRESC (reference: examples/test_lorasc.c,
    test_presc.c): ``ECGSolver`` on one device, ``StencilLorascECG`` with
    ``--scalable``, ``DistributedLorascECG`` with ``--nshards`` /
    ``--np-level1`` under a group."""
    p = _common_parser("Enlarged CG with LORASC/PRESC Schur preconditioning")
    p.add_argument("-p", "--precond", default="lorasc", choices=["lorasc", "presc"])
    p.add_argument("--nparts", type=int, default=8,
                   help="subdomain count (single-device build)")
    p.add_argument("--np-level1", type=int, default=0, dest="np_level1",
                   help="distributed 2-level mesh: number of level-1 groups; "
                        "the mesh is (np_level1, nshards // np_level1)")
    p.add_argument("--deflation-tol", type=float, default=1e-2)
    p.add_argument("--eig-method", default="direct", choices=["direct", "lanczos"])
    p.add_argument("--eigs-kind", default="ssloc", choices=["ssloc", "saloc"])
    p.add_argument("--scalable", action="store_true",
                   help="banded LORASC for stencil operators "
                        "(parallel/lorasc_stencil.py)")
    p.add_argument("--pencil", default="agg", choices=["agg", "sloc", "saloc"],
                   help="deflation pencil for --scalable")
    p.add_argument("--max-deflation", type=int, default=64)
    p.add_argument("--correction", default="sigma", choices=["sigma", "deflate"],
                   help="low-rank correction form (--scalable and distributed "
                        "builds): sigma = E σ Eᵀ; deflate = balancing projection")
    p.add_argument("--factor-store", default=None,
                   choices=[None, "auto", "f32", "bf16"],
                   help="storage dtype of the banded factors (--scalable)")
    args = p.parse_args(argv)

    from prealps_tpu_torch.api import ECGSolver
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a = _load_matrix(args)
    b = _load_rhs(args, a.shape[0])
    opts = ECGOptions(t=args.t, tol=args.tol, maxiter=args.maxiter,
                      variant=args.ortho_alg, adaptive=args.adaptive,
                      adaptive_mode=args.adaptive_mode)
    if ((args.partition_file or args.save_partition)
            and not (args.precond == "lorasc" and args.scalable)):
        raise SystemExit("error: --partition-file/--save-partition are "
                         "supported on the --scalable LORASC path "
                         "(and the ecg command)")
    node_part = None
    if args.partition_file:
        from prealps_tpu_torch.core.io import load_partition

        rowpart = load_partition(args.partition_file, a.shape[0])
        br = 3
        if a.shape[0] % br:
            raise SystemExit("error: matrix size is not divisible by the "
                             "3-dof node block")
        rp = rowpart.reshape(-1, br)
        if not np.all(rp == rp[:, :1]):
            raise SystemExit("error: partition must be constant within "
                             "each 3-dof node block")
        node_part = rp[:, 0]
    group = None
    if args.precond == "lorasc" and args.scalable:
        from dataclasses import replace

        from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG

        solver = StencilLorascECG.build(
            a, nparts=args.nparts, opts=replace(opts, layout="tbn"),
            deflation_tol=args.deflation_tol,
            max_deflation=args.max_deflation, dtype=_dtype_of(args),
            pencil=args.pencil, correction=args.correction,
            node_part=node_part, factor_store=args.factor_store or "auto",
            device=args.device)
        if args.save_partition:
            from prealps_tpu_torch.core.io import save_partition

            save_partition(args.save_partition,
                           np.repeat(solver.precond.plan.part_arr, 3))
    elif args.precond == "lorasc" and (args.nshards > 1 or args.np_level1):
        from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG

        mesh_shape = None
        if args.np_level1:
            nsh = args.nshards if args.nshards > 1 else args.np_level1
            if nsh % args.np_level1:
                raise SystemExit("error: --np-level1 must divide --nshards")
            mesh_shape = (args.np_level1, nsh // args.np_level1)
        group = _group(args)
        solver = DistributedLorascECG.build(
            a, nshards=args.nshards, opts=opts,
            mesh_shape=mesh_shape, deflation_tol=args.deflation_tol,
            dtype=_dtype_of(args), correction=args.correction,
            device=args.device, group=group)
    else:
        if args.correction == "deflate":
            raise SystemExit(
                "error: --correction deflate requires --scalable or a "
                "distributed build (--nshards/--np-level1); the small-scale "
                "path implements the sigma form only")
        kwargs = dict(nparts=args.nparts, deflation_tol=args.deflation_tol,
                      dtype=_dtype_of(args))
        if args.precond == "lorasc":
            kwargs["eig_method"] = args.eig_method
        else:
            kwargs["eigs_kind"] = args.eigs_kind
        solver = ECGSolver.build(a, opts=opts, precond=args.precond,
                                 device=args.device, **kwargs)
    t0 = time.time()
    x, info = solver.solve(b)
    return _report(args, a, b, x, info, time.time() - t0, group)


def bench_main(argv=None):
    """The JAX package's benchmark (bench.py) has no port yet."""
    raise NotImplementedError(
        "the port has no benchmark yet: bench.py drives the JAX package; "
        "ROADMAP.md queue A, item 2 builds the port's")


COMMANDS = {"ecg": ecg_main, "lorasc": lorasc_main, "bench": bench_main}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m prealps_tpu_torch.cli {{{','.join(COMMANDS)}}} "
              "[options]  (-h after a command for its options)", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
