"""Multi-process launch recipe: the distributed LORASC solver across N
processes joined by ``torch.distributed``.

The counterpart of the JAX package's ``examples/multihost_launch.py`` (the
reference scales with ``mpirun -np N test_lorasc``, README.md:53-59). Each
process joins one group with ``parallel/mesh.py::init_group(backend,
init_method="env://")`` (rank, world size and the coordinator's address
from its environment), builds ``DistributedLorascECG`` on a (N / 2, 2)
mesh (interior solves over the inner pair, the separator over the outer
axis; exact_schur=False, the Lanczos deflation with max_deflation 16, the
balancing correction, f64) from the same operator on every process,
solves, and checks the true residual (< 1e-7).

Under ``torchrun`` (one process a card; ``--device cuda`` is
``cuda:{rank}``, NCCL possible with ``--backend nccl``):

    torchrun --nproc-per-node 4 -m prealps_tpu_torch.examples.multihost_launch

or on one machine without it: ``--nproc N`` starts N copies of this
script on a free local port and waits for them (a failed or hung copy
kills the rest); ranks sharing one card name it (``--device cuda:0``,
gloo), and ``--device cpu`` runs on the host:

    python -m prealps_tpu_torch.examples.multihost_launch --nproc 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np


def worker(backend: str, device: str) -> None:
    import torch.distributed as dist

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = mesh.shard_device(device, rank)
    if dev.type == "cpu":
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = mesh.init_group(backend, init_method="env://", device=dev)
    try:
        # every process builds from the same deterministic operator (the
        # reference reads the same .mtx on every rank, operator.c:38)
        a = elasticity3d(6, 5, 5)
        b = np.random.default_rng(0).standard_normal(a.shape[0])
        solver = DistributedLorascECG.build(
            a, mesh_shape=(world // 2, 2), group=group, device=dev,
            dtype=np.float64, exact_schur=False, max_deflation=16,
            correction="deflate",
            opts=ECGOptions(t=2, tol=1e-8, maxiter=2000, variant="odir_fused"))
        x, info = solver.solve(b)
        relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
        print(f"[proc {rank}/{world}] iters={info['iters']} deflated="
              f"{solver.deflated} true_relres={relres:.3e}", flush=True)
        if not relres < 1e-7:
            raise SystemExit(f"rank {rank}: relres {relres:.3e} >= 1e-7")
    finally:
        dist.destroy_process_group()


def launch(nproc: int, backend: str, device: str, timeout: float) -> int:
    """Start ``nproc`` copies of this script as the ranks of one group on
    a free local port; returns 0 when every copy succeeded."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "prealps_tpu_torch.examples.multihost_launch",
             "--backend", backend, "--device", device], env=env))
    rc = 0
    try:
        for p in procs:
            if p.wait(timeout=timeout) != 0:
                rc = 1
    except subprocess.TimeoutExpired:
        rc = 1
    finally:
        # a dead worker leaves the others blocked in collectives: kill the
        # whole set on any failure or timeout
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc = 1
    print("ALL_OK" if rc == 0 else f"FAILED rc={rc}", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=0,
                    help="start this many local processes (0: this process is "
                         "a rank, as under torchrun)")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.nproc:
        return launch(args.nproc, args.backend, args.device, args.timeout)
    worker(args.backend, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
