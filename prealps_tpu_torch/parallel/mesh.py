"""Process groups and collectives of the multi-GPU driver.

The counterpart of ``prealps_tpu/parallel/mesh.py`` and of the
``shard_map`` collectives of the JAX package. There one program runs over a
device mesh; here one process runs each shard (SPMD), joined by a
``torch.distributed`` group:

* ``init_group`` joins a process to a group and ``shard_device`` names its
  device: ``device="cuda"`` is ``cuda:{rank}`` (one host, one card a rank)
  and raises where that card is absent; ``rank_device`` picks the device
  to hand ranks spawned on one host (``cuda:0``, shared, where the host has
  fewer cards than ranks). NCCL needs a card of its own for
  each rank, so ranks that share one card name it (``"cuda:0"``) and a
  ``gloo`` group; ``init_group`` refuses an NCCL group of several ranks on
  one card before it joins. Nothing here picks a backend or a device.
* ``spawn`` starts ``nprocs`` ranks (the ``spawn`` start method), joins them
  into a group, and returns their results; when a rank fails, or the time
  runs out, it kills every rank and raises. Ranks started by ``torchrun``
  join with ``init_group(backend, init_method="env://")``: rank, size and
  the coordinator's address then come from its environment.
* ``mesh_groups`` lays a (G, L) mesh over a group, the JAX ``Mesh``
  reshape of the distributed LORASC: rank r is (g, l) = (r // L, r % L),
  and the L ranks of each g form a local group. The JAX package's
  ``parallel/multihost.py`` (per-process host arrays made global) has no
  counterpart: each process already holds its own shard, and the host copy
  of x is the all-gather every solve ends with.
* The collectives, each the counterpart of one JAX collective:
  ``all_reduce`` (``psum``), ``all_gather`` (``all_gather(tiled=True)``),
  ``ring_exchange`` (the two ``ppermute`` of the stencil's ring halo) and
  ``all_to_all`` (the ELL halo plan's exchange), and ``broadcast`` of a
  host value from rank 0 (values that come from host LAPACK, which two
  processes need not round alike). Every transport decision
  is made here: a ``gloo`` group moves a CUDA tensor through one host copy
  (its point-to-point operations take CPU tensors), an NCCL group moves
  device tensors as they are. Each collective counts its calls
  (``all_reduce.calls``, ...).
* ``timing_no_collectives`` reads the timing ablation's knob,
  ``PREALPS_TIMING_NO_COLLECTIVES``: with it set, ``ops/blockops.py::psum``
  is the identity and ``ops/spmm.py::extend_ring`` wraps the shard's own
  panel, so a solve runs its local work alone. Results are wrong by
  construction; ``examples/weak_scaling.py`` and chip_smoke's ``[sharded4]``
  use it to split an iteration's time into compute and communication.

Every rank must issue the same collectives in the same order, so every
decision a rank takes on the host is taken on replicated values: all-reduced
scalars, which both backends return bitwise equal on every rank.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from prealps_tpu_torch.config import resolve_device


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


SHARED_NOTE = ("ranks share one card through gloo: host round trips between "
               "processes, not scaling")


def rank_device(device, world: int) -> tuple:
    """(the device to give every rank, whether the ranks share one card)
    for a gloo group of ``world`` ranks on one host: ``"cuda"`` stays
    ``"cuda"`` (``cuda:{rank}``, see ``shard_device``) where the host has a
    card a rank, else every rank shares ``cuda:0``; an explicit device is
    kept. Raises if the card is absent. Times taken by ranks that share a
    card time host round trips, not scaling (``SHARED_NOTE``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return device, False
    if dev.index is None and torch.cuda.device_count() >= world:
        return "cuda", False
    return (device if dev.index is not None else "cuda:0"), world > 1


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


def init_group(backend: str, rank: int | None = None, world: int | None = None,
               init_method: str = "env://", timeout: float = 600.0, device=None):
    """Join this process to a ``world``-rank group as ``rank`` and return
    the group. ``init_method`` names the rendezvous (``tcp://localhost:<port>``
    or ``file://<path>``; ``env://``, the default, reads ``RANK``,
    ``WORLD_SIZE`` and the coordinator's ``MASTER_ADDR``/``MASTER_PORT``
    from the environment, as ``torchrun`` sets them, where rank and world
    are not given); ``timeout`` (seconds) bounds every collective. With
    ``device`` given, an NCCL group that would put two ranks on one card
    raises before joining."""
    if init_method == "env://":
        import os

        rank = int(os.environ["RANK"]) if rank is None else rank
        world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if device is not None:
        check_backend_device(backend, world, device, rank)
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def timing_no_collectives() -> bool:
    """The timing ablation (``PREALPS_TIMING_NO_COLLECTIVES=1``), read at
    every call: the cross-shard sums of ``ops/blockops.py::psum`` and the
    ring halo of ``ops/spmm.py::extend_ring`` become local no-ops, so an
    iteration runs exactly its local compute. Results are WRONG by
    construction: it exists only to time a solve without its
    communication (the JAX package's ``ops/blockops.py:20-28``) and is
    never on by default. The other collectives (all-gathers, all-to-alls,
    broadcasts) still run. Ranks started by ``spawn`` inherit it only if
    it is set before the spawn; a rank that sets it itself unsets it
    before its next solve."""
    return bool(int(os.environ.get("PREALPS_TIMING_NO_COLLECTIVES", "0")))


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def size_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def backend_of(group) -> str:
    return str(dist.get_backend(group))


def mesh_groups(group, shape: tuple):
    """A (G, L) mesh over ``group`` (G·L ranks): returns (g, l, local),
    this rank's coordinates (r // L, r % L) and the process group of the L
    ranks that share its g (None when L == 1). Every rank of the default
    group must call this, with the same shape: ``dist.new_group`` is
    collective over it, and every rank creates every local group, in
    order."""
    g_n, l_n = (int(v) for v in shape)
    if g_n * l_n != size_of(group):
        raise ValueError(f"a {g_n}x{l_n} mesh needs a group of {g_n * l_n} "
                         f"ranks; got {size_of(group)}")
    rank = rank_of(group)
    local = None
    if l_n > 1:
        for g in range(g_n):
            ranks = [dist.get_global_rank(group, g * l_n + l) for l in range(l_n)]
            sub = dist.new_group(ranks, backend=backend_of(group))
            if g == rank // l_n:
                local = sub
    return rank // l_n, rank % l_n, local


def _rank_main(job, rank, world, backend, init_method, timeout, threads,
               results):
    """One spawned rank: read (fn, args) from the file ``job``, join the
    group, run ``fn(rank, group, *args)``, hand back its result or its
    traceback."""
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
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
    seconds; either way every rank still running is killed first.

    ``fn`` and ``args`` reach the ranks through one temporary file, not
    through each process's start: a start whose data outgrows the pipe's
    buffer waits until the new process reads it, so large arguments
    started the ranks one after another."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    fd, job = tempfile.mkstemp(prefix="prealps_spawn_", suffix=".pkl")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(job, r, nprocs, backend, init_method, timeout,
                               threads, results))
             for r in range(nprocs)]
    done, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for p in procs:
            p.start()
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
            if p.pid is None:        # never started
                continue
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        results.close()
        os.unlink(job)
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


def broadcast(value, group, src: int = 0):
    """Rank ``src``'s value (any picklable host object: numpy arrays,
    scalars, tuples, a CPU tensor) on every rank of the group; the value
    the other ranks pass is ignored. Without a group, the value itself."""
    if group is None or size_of(group) == 1:
        return value
    box = [value if rank_of(group) == src else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    broadcast.calls += 1
    return box[0]


for _fn in (all_reduce, all_gather, ring_exchange, all_to_all, broadcast):
    _fn.calls = 0
del _fn
