"""Process-group bootstrap for data-parallel training (port of
cat_tpu/parallel/distributed.py).

The same program runs in every process:

    dist = maybe_initialize(seed, coordinator, num_processes, process_id)
    n_local = local_env_count(num_envs, dist)
    es = env.init(torch.Generator(dist.device).manual_seed(dist.seed), n_local)

A JAX process drives every chip of its host (one mesh spans them all); a
process here drives ONE card, ``cuda:<local rank>``, so a host runs one
process a card. The group comes from, in this order:
  1. torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
     ``MASTER_ADDR`` / ``MASTER_PORT``;
  2. the reference's three flags: ``coordinator`` ("host:port", a TCP store
     that process 0 serves, or any ``init_method`` URL such as
     "file:///path"), ``num_processes`` and ``process_id``; a group is set
     up for one process too, so the grouped code path can run alone;
  3. nothing: no group, world size 1, no collective (the one-card path).
The backend is NCCL on cuda and gloo on cpu unless the caller names one;
gloo also reduces CUDA tensors (through the host), so several processes can
share one card under it. Every rank's seed is the base seed + its rank
(rl_games train.py:106).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Callable, Optional

import torch
import torch.distributed as tdist

from cat_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DistContext:
    rank: int
    world_size: int
    seed: int                 # base seed + rank
    is_rank0: bool
    group: Optional[object]   # the process group; None: no group
    device: torch.device      # the device this process drives


def maybe_initialize(seed: int, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> DistContext:
    """Join the process group the environment or the flags describe, or
    none (module docstring). ``device`` is "cuda" (a card a process, by
    its local rank) or "cpu"."""
    dev = resolve_device(device)
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        init_method = "env://"
    elif coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in "
                             f"[0, {num_processes})")
        rank, world, local = process_id, num_processes, process_id
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    else:
        return DistContext(0, 1, seed, True, None, dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif "OMP_NUM_THREADS" not in env:
        # the host's cores shared out: with every process on all of them,
        # the small CPU ops ran ~15x slower (torchrun sets OMP_NUM_THREADS
        # for its processes, and a count the environment sets is kept)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
            env.get("LOCAL_WORLD_SIZE", world))))
    tdist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=world, rank=rank)
    return DistContext(rank, world, seed + rank, rank == 0,
                       tdist.group.WORLD, dev)


def close(dist: DistContext):
    """Leave the process group ``maybe_initialize`` joined, if any."""
    if dist.group is not None:
        tdist.destroy_process_group()


def local_env_count(num_envs: int, dist: DistContext) -> int:
    """This process's share of the global env count."""
    if num_envs % dist.world_size:
        raise ValueError(f"num_envs {num_envs} does not divide over "
                         f"{dist.world_size} processes")
    return num_envs // dist.world_size


def free_coordinator() -> str:
    """A "localhost:<port>" on a port free at the time of the call."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          coordinator: Optional[str] = None,
          timeout: Optional[float] = None):
    """Run ``fn(process_id, coordinator, *args)`` in ``nprocs`` new
    processes (the spawn start method; ``fn`` must be importable) and wait
    for all of them. Raises when one fails (the others are stopped) or when
    ``timeout`` seconds pass (all are stopped)."""
    coordinator = coordinator or free_coordinator()
    ctx = torch.multiprocessing.start_processes(
        fn, args=(coordinator, *args), nprocs=nprocs, join=False,
        start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(30)
            raise TimeoutError(f"{nprocs} processes did not end within "
                               f"{timeout} s")
