"""Process groups and rank launching: the port of
``gnnadvisor_osdi21_tpu/parallel/mesh.py``.

The JAX package shards node row blocks over a 1-D device mesh inside one
program.  Here each shard is a process: ``world`` ranks in one
``torch.distributed`` process group, rank r owning row block r.  On the
card the group is NCCL with rank r on ``cuda:r`` (or, on several hosts,
on ``cuda:<its local rank>``); on the host it is gloo.
The ranks meet through a ``file://`` store in a temporary directory, never
a fixed TCP port, so that several groups can start side by side.

``run_ranks`` spawns the ranks of one group and waits for them;
``make_group`` joins the calling process to a group (a group of one rank
needs no launcher).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gnnadvisor_osdi21_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the group: its rank, the group's size, the
    device its shard lives on and the backend's process group."""

    rank: int
    world: int
    device: torch.device
    backend: str
    pg: dist.ProcessGroup
    # the temporary directory of a group of one that made its own store
    _own_dir: str | None = None


def check_cards(num_devices: int, device) -> torch.device:
    """The device type the ranks run on (None: the card); raises when
    there are fewer cards than ranks, as the JAX ``make_mesh`` does with
    fewer devices."""
    if num_devices < 1:
        raise ValueError(f"need at least one rank, got {num_devices}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < num_devices:
            raise ValueError(
                f"need {num_devices} CUDA cards (one per rank), have {have} "
                "(on the host: --platform cpu / device='cpu', gloo)"
            )
    return resolve_device(dev)


def make_group(
    num_devices: int, device=None, rank: int = 0,
    init_file: str | None = None, local_rank: int | None = None,
) -> Group:
    """Join rank ``rank`` of a group of ``num_devices`` ranks.

    ``device``: None for the card (NCCL, the rank on ``cuda:local_rank``;
    raises when this host has no such card), ``"cpu"`` for gloo.
    ``local_rank``: the rank's index among its host's ranks (None: ``rank``,
    every rank on one host).  ``init_file``: the path of the group's
    ``file://`` store, the same for every rank and not yet existing; a
    group of one may leave it None and gets a store in a temporary
    directory of its own (removed by ``destroy_group``)."""
    local = rank if local_rank is None else local_rank
    dev = check_cards(num_devices if local_rank is None else local + 1, device)
    own_dir = None
    if init_file is None:
        if num_devices != 1:
            raise ValueError("a group of several ranks needs their shared "
                             "init_file")
        own_dir = tempfile.mkdtemp(prefix="gnna_group_")
        init_file = os.path.join(own_dir, "store")
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
        kw = {"device_id": dev}
    else:
        dev = torch.device("cpu")
        backend = "gloo"
        kw = {}
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=num_devices,
        rank=rank, **kw,
    )
    return Group(rank, num_devices, dev, backend, dist.group.WORLD, own_dir)


def destroy_group(group: Group) -> None:
    """Leave the group (and remove the store a group of one made)."""
    dist.destroy_process_group(group.pg)
    if group._own_dir is not None:
        shutil.rmtree(group._own_dir, ignore_errors=True)


def _rank_main(rank: int, world: int, device, init_file: str,
               fn: Callable, args: tuple) -> None:
    if device == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = make_group(world, device, rank, init_file)
    try:
        fn(group, *args)
    finally:
        destroy_group(group)


def run_ranks(
    fn: Callable, num_devices: int, device=None, args: tuple = (),
    timeout: float | None = None,
) -> None:
    """Spawn ``num_devices`` ranks (the spawn start method), each calling
    ``fn(group, *args)`` inside its group, and wait for all of them.
    ``fn`` and ``args`` must pickle (``fn`` a module-level function).

    A rank that raises ends the others and raises here; with ``timeout``
    (seconds), ranks still running then are ended and ``TimeoutError``
    raised, so that a rank stuck in a collective cannot hang the caller."""
    dev = check_cards(num_devices, device)
    tmp = tempfile.mkdtemp(prefix="gnna_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main,
            args=(num_devices, "cpu" if dev.type == "cpu" else None,
                  os.path.join(tmp, "store"), fn, args),
            nprocs=num_devices, join=False, start_method="spawn",
        )
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(
            None if deadline is None else max(deadline - time.monotonic(), 0)
        ):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"{num_devices} ranks still running after {timeout} s"
                )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
