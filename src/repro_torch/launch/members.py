"""Members of a mesh as processes: the process group they join, the card
each uses, and a launcher for tests and scripts.

``torchrun --standalone --nproc-per-node N -m repro_torch.launch.train
...`` starts N members and ``init_from_env`` joins them;
``spawn(fn, n, ...)`` starts n members from Python with
``torch.multiprocessing.spawn`` and a ``file://`` rendezvous, calls
``fn(rank, *args)`` in each and returns what each returned (rank order).
An exception in a member ends the others and is raised by ``spawn``.

Backend: ``torchrun``'s members take ``nccl`` only when every member has a
card of its own, else ``gloo``; ``spawn``'s take ``gloo``, since they share
a card or run on the CPU (NCCL refuses two ranks on one device). Every
group gets a timeout (``TIMEOUT_S``), so a member that hangs fails the run
instead of hanging it.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600


def choose_backend(device, world: int) -> str:
    """``nccl`` when each of ``world`` members has a CUDA card of its own,
    else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def member_device(device, rank: int = None):
    """The card this member uses: ``cuda:<rank mod cards>`` for a bare
    ``"cuda"`` (one a member where there are enough, else they share);
    ``device`` as given otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                  if dist.is_initialized() else 0))
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def init_members(rank: int, world: int, init_method: str) -> None:
    """Join ``world`` members over ``gloo`` at ``init_method``."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def init_from_env(device) -> bool:
    """Join the group ``torchrun`` describes in the environment (once);
    returns whether this process is one of several members. On ``nccl``
    each member first makes its own card the current one, so that object
    collectives and barriers run there."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        backend = choose_backend(device, world)
        if backend == "nccl":
            torch.cuda.set_device(member_device(device))
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return world > 1


def _entry(rank, fn, world, init_method, threads, out, args):
    torch.set_num_threads(threads)
    init_members(rank, world, init_method)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), *, threads: int = 1,
          rendezvous_dir=None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` member processes joined in a
    ``gloo`` group; returns their results in rank order. ``fn`` must be
    importable (a module's top-level function) and its results
    ``torch.save``-able."""
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as d:
        init = f"file://{os.path.join(d, 'rendezvous')}"
        mp.spawn(_entry, args=(fn, world, init, threads, d, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
