"""Process groups and collectives of the multi-GPU driver.

The counterpart of ``prealps_tpu/parallel/mesh.py`` and of the
``shard_map`` collectives of the JAX package. There one program runs over a
device mesh; here one process runs each shard (SPMD), joined by a
``torch.distributed`` group:

* ``init_group`` joins a process to a group and ``shard_device`` names its
  device: ``device="cuda"`` is ``cuda:{rank}`` (one host, one card a rank)
  and raises where that card is absent. NCCL needs a card of its own for
  each rank, so ranks that share one card name it (``"cuda:0"``) and a
  ``gloo`` group; ``init_group`` refuses an NCCL group of several ranks on
  one card before it joins. Nothing here picks a backend or a device.
* ``spawn`` starts ``nprocs`` ranks (the ``spawn`` start method), joins them
  into a group, and returns their results; when a rank fails, or the time
  runs out, it kills every rank and raises.
* The collectives, each the counterpart of one JAX collective:
  ``all_reduce`` (``psum``), ``all_gather`` (``all_gather(tiled=True)``),
  ``ring_exchange`` (the two ``ppermute`` of the stencil's ring halo) and
  ``all_to_all`` (the ELL halo plan's exchange). Every transport decision
  is made here: a ``gloo`` group moves a CUDA tensor through one host copy
  (its point-to-point operations take CPU tensors), an NCCL group moves
  device tensors as they are. Each collective counts its calls
  (``all_reduce.calls``, ...).

Every rank must issue the same collectives in the same order, so every
decision a rank takes on the host is taken on replicated values: all-reduced
scalars, which both backends return bitwise equal on every rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import time
import traceback

import torch
import torch.distributed as dist


def shard_device(device, rank: int = 0) -> torch.device:
    """The device of ``rank``: ``"cuda"`` without an index is
    ``cuda:{rank}``; an explicit device is kept. Raises if the card is
    absent."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the host")
    if dev.index is None:
        dev = torch.device("cuda", rank)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {rank} wants {dev}, but this host has "
            f"{torch.cuda.device_count()} card(s); ranks that share a card "
            "name it (device='cuda:0') and a gloo group")
    return dev


def check_backend_device(backend: str, world: int, device, rank: int) -> None:
    """NCCL runs one rank a card: refuse an NCCL group of several ranks
    whose rank does not own its own card (NCCL refuses two ranks on one
    device)."""
    if str(backend).lower() != "nccl" or world == 1:
        return
    dev = torch.device(device)
    if (dev.type != "cuda" or (dev.index is not None and dev.index != rank)
            or (torch.cuda.is_available() and torch.cuda.device_count() < world)):
        raise ValueError(
            f"an NCCL group of {world} ranks needs cuda:{{rank}} on a card "
            f"of its own for each rank (rank {rank} asked for {device!r}, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
            "card(s)); ranks that share a card use backend='gloo'")


def init_group(backend: str, rank: int, world: int, init_method: str,
               timeout: float = 600.0, device=None):
    """Join this process to a ``world``-rank group as ``rank`` and return
    the group. ``init_method`` names the rendezvous (``tcp://localhost:<port>``
    or ``file://<path>``); ``timeout`` (seconds) bounds every collective.
    With ``device`` given, an NCCL group that would put two ranks on one
    card raises before joining."""
    if device is not None:
        check_backend_device(backend, world, device, rank)
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def size_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def backend_of(group) -> str:
    return str(dist.get_backend(group))


def _rank_main(fn, rank, world, args, backend, init_method, timeout,
               threads, results):
    """One spawned rank: join the group, run ``fn(rank, group, *args)``,
    hand back its result or its traceback."""
    try:
        torch.set_num_threads(threads)
        group = init_group(backend, rank, world, init_method, timeout)
        out = (rank, True, fn(rank, group, *args))
    except BaseException:    # reported to the parent, which raises
        out = (rank, False, traceback.format_exc())
    results.put(out)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), *, init_method: str,
          backend: str = "gloo", timeout: float = 120.0, threads: int = 1):
    """Run ``fn(rank, group, *args)`` on ``nprocs`` new processes joined
    into one group; returns the results by rank. ``fn`` and ``args`` must
    pickle (``fn`` a module-level function), and so must the results.
    Raises RuntimeError if a rank fails or exits without a result, and
    TimeoutError if the ranks have not all finished within ``timeout``
    seconds; either way every rank still running is killed first."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, args, backend, init_method,
                               timeout, threads, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    done, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < nprocs and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(nprocs)) - set(done))
                raise TimeoutError(f"ranks {missing} of {nprocs} did not "
                                   f"finish within {timeout:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    # a rank that died without a result (its last message
                    # has had a second to arrive since it exited)
                    if r not in done and p.exitcode not in (None, 0):
                        errors[r] = f"exited with code {p.exitcode}"
                continue
            (done if ok else errors)[rank] = payload
    finally:
        for p in procs:
            if p.is_alive() and (errors or len(done) < nprocs):
                p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        results.close()
    if errors:
        raise RuntimeError("\n".join(f"rank {r} of {nprocs} failed: {msg}"
                                     for r, msg in sorted(errors.items())))
    return [done[r] for r in range(nprocs)]


# --- collectives -----------------------------------------------------------


def _via_host(x: torch.Tensor, group) -> bool:
    return x.device.type != "cpu" and dist.get_backend(group) == dist.Backend.GLOO


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of x on the device the group's transport takes."""
    if _via_host(x, group):
        return x.detach().contiguous().to("cpu", copy=True)
    return x.detach().clone(memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks, on every rank (x unchanged)."""
    buf = _wire(x, group)
    dist.all_reduce(buf, group=group)
    all_reduce.calls += 1
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in rank order (the tiled
    all-gather); every rank's x has the same shape."""
    buf = _wire(x, group)
    parts = [torch.empty_like(buf) for _ in range(size_of(group))]
    dist.all_gather(parts, buf, group=group)
    all_gather.calls += 1
    return torch.cat(parts, dim=dim).to(x.device)


def ring_exchange(to_left: torch.Tensor, to_right: torch.Tensor, group):
    """Send ``to_right`` to rank + 1 and ``to_left`` to rank − 1 (mod the
    group's size); returns (from_left, from_right): what rank − 1 sent
    right and rank + 1 sent left. All four transfers are posted in one
    batch, in the same order on every rank; tag 0 travels right and tag 1
    left, so two ranks, whose two neighbours are the same peer, pair them
    up as well."""
    world, rank = size_of(group), rank_of(group)
    left = dist.get_global_rank(group, (rank - 1) % world)
    right = dist.get_global_rank(group, (rank + 1) % world)
    send_r, send_l = _wire(to_right, group), _wire(to_left, group)
    recv_l, recv_r = torch.empty_like(send_r), torch.empty_like(send_l)
    ops = [dist.P2POp(dist.isend, send_r, right, group, tag=0),
           dist.P2POp(dist.isend, send_l, left, group, tag=1),
           dist.P2POp(dist.irecv, recv_l, left, group, tag=0),
           dist.P2POp(dist.irecv, recv_r, right, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    ring_exchange.calls += 1
    return recv_l.to(to_left.device), recv_r.to(to_right.device)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (S, ...): slot d goes to rank d; returns (S, ...) whose slot s came
    from rank s (``all_to_all(tiled=True)`` along axis 0)."""
    buf = _wire(x, group)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    all_to_all.calls += 1
    return out.to(x.device)


for _fn in (all_reduce, all_gather, ring_exchange, all_to_all):
    _fn.calls = 0
del _fn
