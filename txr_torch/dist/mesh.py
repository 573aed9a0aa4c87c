"""Rank layouts, process-group bootstrap and the spawned worlds of ranks
(txr/dist/mesh.py).

The JAX package lays a device mesh over its devices; here a world of
``torch.distributed`` ranks plays the devices, one process each.  A
``Mesh`` is the rank grid over that world, with the axis names of the JAX
mesh (``dp`` shards blocks of rays, ``sp`` splits each block), and this
rank's place in it.  Every sharded function shards over the whole world,
as the JAX functions shard over every axis of their mesh.

Backend rule: ``nccl`` when every rank has a card of its own, ``gloo`` when
ranks share a card or run on the CPU (NCCL refuses two ranks on one card).
Every collective goes through the helpers below (``all_gather_rows``,
``all_reduce_sum``, ``ring_shift``); gloo has no point-to-point transfer of
CUDA tensors, so ``ring_shift`` stages them through the host there
(``_p2p_wire``).  The ranks' work itself stays on their cards.

``spawn_world(n, fn, ...)`` starts a world of n ranks in fresh processes
(the ``spawn`` start method, a ``file://`` store) and runs ``fn`` in each:
the stand-in for the JAX package's virtual devices.  A timeout bounds both
the process group's set-up and the join; past it every rank is killed and
the launcher raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from txr_torch import resolve_device

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks over the world: ``ranks`` [*shape] int, rank ids in
    row-major order; ``axis_names`` one per dimension; ``rank`` this
    process's rank."""

    ranks: np.ndarray
    axis_names: tuple
    rank: int

    @property
    def shape(self):
        """{axis name: size}, as the JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self):
        return int(self.ranks.size)

    @property
    def coords(self):
        """This rank's index along each axis."""
        return tuple(int(c) for c in np.argwhere(self.ranks == self.rank)[0])


def world():
    """(world size, this rank): (1, 0) when no process group is set up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(shape=None, axis_names=("dp", "sp")):
    """Mesh over the world's ranks (txr/dist/mesh.py:26-38).

    shape=None → every rank on the first axis, (n, 1).  A shape must
    multiply to the world size."""
    n, rank = world()
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    ranks = np.arange(n).reshape(shape)
    return Mesh(ranks, tuple(axis_names[: ranks.ndim]), rank)


def default_backend(devices):
    """The backend for ranks on ``devices`` (one per rank): nccl when every
    rank has a card of its own, gloo when ranks share a card or run on the
    CPU."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def init_multihost(init_method=None, world_size=None, rank=None, backend=None):
    """``torch.distributed.init_process_group`` for a multi-process world
    (txr/dist/mesh.py:41-53) → (world size, rank).  Does nothing when it
    gets no ``init_method`` and the environment holds neither
    ``WORLD_SIZE`` nor ``MASTER_ADDR``: a single process is a world of
    one.  ``backend`` defaults to nccl where CUDA is available, else
    gloo; collectives time out after DEFAULT_TIMEOUT_S."""
    if dist.is_initialized():
        return world()
    if init_method is None and not (os.environ.get("WORLD_SIZE") or
                                    os.environ.get("MASTER_ADDR")):
        return 1, 0
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return world()


# -- collectives --------------------------------------------------------------


def _p2p_wire(t):
    """The tensor a point-to-point transfer moves for ``t``: ``t`` itself,
    or, for a CUDA tensor under gloo, a host copy.  gloo moves CUDA tensors
    in ``all_reduce``, ``broadcast`` and ``all_gather``, but its
    ``send``/``recv`` hand the CUDA pointer to its TCP transport, which
    fails (PyTorch 2.11 on the H100), so the ring's hops go through the
    host there: a transport choice, the computation stays on the card."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.cpu()
    return t.contiguous()


def all_gather_rows(t):
    """Every rank's ``t`` [c, ...] (the same shape on each), concatenated in
    rank order → [n·c, ...] on ``t``'s device.  One collective, none
    without a process group."""
    if not dist.is_initialized():
        return t
    n, _ = world()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def all_reduce_sum(t):
    """The sum of every rank's ``t`` → a new tensor on ``t``'s device.
    One collective, none without a process group."""
    if not dist.is_initialized():
        return t
    w = t.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM)
    return w


def ring_shift(t):
    """One hop around the ring of ranks: send ``t`` to rank me+1, receive
    rank me−1's → the received tensor (same shape and type) on ``t``'s
    device.  The send and the receive are posted together
    (``batch_isend_irecv``), so no rank waits on another's order.  A
    world of one has nothing to rotate."""
    n, me = world()
    if n == 1:
        return t
    w = _p2p_wire(t)
    got = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, (me + 1) % n), dist.P2POp(dist.irecv, got, (me - 1) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got.to(t.device)


# -- spawned worlds -------------------------------------------------------------


def _rank_main(rank, n, init_method, backend, devices, timeout_s, fn, args, out_dir):
    """One rank of ``spawn_world``: set up the group, run ``fn(device,
    *args)``, write its result (or the traceback) to ``out_dir``."""
    torch.set_num_threads(1)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    result = None
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = ("ok", fn(device, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
        raise
    finally:
        tmp = os.path.join(out_dir, f"rank{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pkl"))


def rank_devices(n, device=None):
    """The device of each of n ranks: ``cuda:(rank % cards)``, or the CPU
    for every rank when ``device`` is "cpu"."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [str(dev)] * n
    cards = torch.cuda.device_count()
    return [f"cuda:{r % cards}" for r in range(n)]


def spawn_world(n, fn, *args, device=None, timeout_s=DEFAULT_TIMEOUT_S):
    """Run ``fn(device, *args)`` in each rank of a new world of ``n``
    processes → [result of rank 0, ..., rank n−1].

    ``fn`` must be importable by name (a module-level function), and
    ``args`` and the results picklable.  Rank r runs on ``cuda:(r %
    cards)`` unless ``device="cpu"``; the backend follows
    ``default_backend``, and the choice is printed.  The group's set-up and
    the whole run share one timeout of ``timeout_s`` seconds: past it, or
    as soon as one rank fails, every rank is killed and this raises."""
    devices = rank_devices(n, device)
    backend = default_backend(devices)
    print(f"spawn_world: {n} ranks on {sorted(set(devices))}, backend {backend}", flush=True)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="txr_world_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, args=(r, n, init_method, backend, devices,
                                                  timeout_s, fn, args, tmp))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        results, errors, late = [], [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")      # written whole (os.replace)
            res = None
            if os.path.exists(path):
                with open(path, "rb") as f:
                    res = pickle.load(f)
            if res is not None and res[0] == "error":
                errors.append(f"rank {r}:\n{res[1]}")
            elif res is None and p.exitcode is not None:
                errors.append(f"rank {r} exited with code {p.exitcode} and no result")
            elif res is None:
                late.append(r)
            results.append(res)
        if errors:
            raise RuntimeError("spawn_world: a rank failed\n" + "\n".join(errors))
        if late:
            raise TimeoutError(f"spawn_world: ranks {late} of {n} did not finish within "
                               f"{timeout_s} s")
        return [res[1] for res in results]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
