"""Halo-exchange / compute overlap: the port of
``examples/measure_halo_overlap.py``.

The reference's distributed SpMM sends the X panel, computes the diagonal
block's SpMM while the messages fly, then adds each arrival
(utils/cplm_v0/cplm_v0_matmult_v2.c:184-321). The JAX script measures how
much of that overlap XLA finds for its ring ``ppermute`` and local stencil
product in one program; here ``--ranks`` processes (``parallel/mesh.py::
spawn``, a gloo group) each own a contiguous slab of elasticity3d(nel³),
RAC-scaled (``--nel``, default 24; the JAX defaults: 8 ranks, t 12), and
time three steps of one distributed SpMM on lane-major (t, 3, nrb) shards:

    full     halos from the ring neighbours (``mesh.ring_exchange``), then
             B2b (``stencil_pallas_bs_ext``) on the extended panel
    compute  the own wrap slices as halos (no exchange), then B2b
    halo     the exchange alone (and a trivial use of what arrived)

overlap efficiency = (compute + halo − full) / min(compute, halo):
1 fully hidden, 0 serialised. Each step is chained (its normalised output
is the next input, as in JAX) and timed as the median of ``--steps``
steps, each started after a barrier and ended by a synchronise
(``utils/timing.py::sync``); rank 0 prints one JSON line with the three
times, the efficiency, the card's name and power limit, and the relative
error of the full step's first product, gathered, against the one-rank
product of the whole panel (B2a). The run is f64 (JAX's type off a TPU),
so on the card the product is B2b's f64 instance.

On a host with fewer cards than ranks every rank shares ``cuda:0``: the
exchange then passes through host memory (gloo) and the ranks time-slice
one card, so the numbers time host staging between processes, not overlap
(``mesh.SHARED_NOTE``; ``"shared_card": true`` in the line).

    python -m prealps_tpu_torch.examples.measure_halo_overlap
    python -m prealps_tpu_torch.examples.measure_halo_overlap --ranks 2 --nel 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time

import numpy as np

BR = 3
DTYPE = np.float64     # JAX's type off a TPU


def problem(nel: int, ranks: int, dtype=DTYPE):
    """(stencil table (S, 3, 3, nrb_tot) as numpy, offsets, the panel
    x (t = 12, 3, nrb_tot) from default_rng(0)) of the JAX script's
    problem: elasticity3d(nel³), RAC-scaled, contiguous layout with rows a
    multiple of 3·ranks."""
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.core.layout import contiguous_row_layout, permute_and_pad_matrix
    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.ops.formats import csr_to_stencil_bsr_t

    a, _ = sym_rac_scaling(elasticity3d(nel, nel, nel))
    lay = contiguous_row_layout(a.shape[0], ranks, row_multiple=BR * ranks)
    sb = csr_to_stencil_bsr_t(permute_and_pad_matrix(a, lay), br=BR, dtype=dtype)
    nrb_tot = lay.n_pad // BR
    x = np.random.default_rng(0).standard_normal((12, BR, nrb_tot)).astype(dtype)
    return sb.blocks_t.numpy(), tuple(int(o) for o in sb.offsets), x, a.nnz


def _rank(rank, group, nel, steps, device):
    import torch
    import torch.distributed as dist

    from prealps_tpu_torch.ops.formats import StencilBsrTMatrix
    from prealps_tpu_torch.ops.spmm import stencil_bsr_spmm_t, stencil_pallas_bs_ext
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.utils.timing import sync

    world = mesh.size_of(group)
    dev = mesh.shard_device(device, rank)
    blocks, offsets, x, nnz = problem(nel, world)
    nrb_tot = x.shape[2]
    nrb = nrb_tot // world
    halo = max(abs(o) for o in offsets)
    if halo > nrb:
        raise ValueError(f"halo {halo} exceeds a shard's {nrb} nodes: fewer ranks "
                         "or a larger --nel")
    cols = slice(rank * nrb, (rank + 1) * nrb)
    b_loc = torch.from_numpy(np.ascontiguousarray(blocks[..., cols])).to(dev)
    x_loc = torch.from_numpy(np.ascontiguousarray(x[..., cols])).to(dev)

    def product(x_ext):
        return stencil_pallas_bs_ext(b_loc, offsets, x_ext.contiguous(), halo)

    def step_full(z):
        left, right = mesh.ring_exchange(z[..., :halo], z[..., nrb - halo:], group)
        return product(torch.cat([left, z, right], dim=-1))

    def step_compute(z):
        return product(torch.cat([z[..., nrb - halo:], z, z[..., :halo]], dim=-1))

    def step_halo(z):
        left, right = mesh.ring_exchange(z[..., :halo], z[..., nrb - halo:], group)
        return z + 1e-30 * torch.cat([left, right], dim=-1).sum(dim=-1, keepdim=True)

    def timed(step):
        z = x_loc
        for _ in range(2):                  # warm
            z = step(z)
        times = []
        for _ in range(steps):
            dist.barrier(group)
            sync(dev)
            t0 = time.perf_counter()
            y = step(z)
            sync(dev)
            times.append(1e3 * (time.perf_counter() - t0))
            z = y / torch.sqrt(torch.mean(y * y) + 1.0)
        return statistics.median(times)

    y_full = mesh.all_gather(step_full(x_loc), group, dim=-1)
    err = None
    if rank == 0:
        a_t = StencilBsrTMatrix(torch.from_numpy(blocks).to(dev), offsets,
                                (BR * nrb_tot, BR * nrb_tot))
        y_one = stencil_bsr_spmm_t(a_t, torch.from_numpy(x).to(dev))
        err = float(torch.linalg.norm(y_full - y_one) / torch.linalg.norm(y_one))
    ms = {name: timed(step) for name, step in (("full", step_full),
                                               ("compute", step_compute),
                                               ("halo", step_halo))}
    return dict(ms=ms, full_vs_single_relerr=err, nnz=nnz, nrb_local=nrb, halo=halo,
                b2b_launches=stencil_pallas_bs_ext.launches,
                b2b_f64_launches=stencil_pallas_bs_ext.f64_launches)


def run(ranks: int = 8, nel: int = 24, steps: int = 20, device="cuda",
        timeout: float = 600.0) -> dict:
    """Spawn the ranks and return rank 0's record (see the module docstring)."""
    from prealps_tpu_torch.parallel import mesh

    dev, shared = mesh.rank_device(device, ranks)
    with tempfile.TemporaryDirectory() as tmp:
        res = mesh.spawn(_rank, ranks, args=(nel, steps, dev),
                         init_method=f"file://{tmp}/store", timeout=timeout)[0]
    ms = res.pop("ms")
    denom = min(ms["compute"], ms["halo"])
    eff = (ms["compute"] + ms["halo"] - ms["full"]) / denom if denom > 0 else float("nan")
    return {"metric": "halo_overlap", "ranks": ranks, "nel": nel,
            "dtype": np.dtype(DTYPE).name, "t": 12, "full_ms": ms["full"],
            "compute_ms": ms["compute"], "halo_ms": ms["halo"],
            "overlap_efficiency": eff, "steps": steps, "device": str(dev),
            "shared_card": shared, **res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--nel", type=int, default=24)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from prealps_tpu_torch.config import resolve_device
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.timing import card_line

    on_card = resolve_device(args.device).type == "cuda"
    if on_card:
        from prealps_tpu_torch.ops import _kernels

        _kernels.load()          # built once here, not by every rank at once
    rec = run(args.ranks, args.nel, args.steps, args.device)
    rec["card"] = card_line() if on_card else "cpu"
    if rec["shared_card"]:
        rec["note"] = mesh.SHARED_NOTE
        print(f"# {mesh.SHARED_NOTE}", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
