"""The process world, ported from the world half of
``repro/launch/mesh.py`` (``make_mesh``).

The reference's mesh gives every rank a device of its own.  Here a rank
is a process, started by ``python -m torch.distributed.run`` (torchrun,
or any launcher that sets the same environment: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), one
per card over NCCL, or one per CPU process over gloo.  Nothing here
touches ``torch.distributed`` or CUDA on import: :func:`init_world`
pins the card and builds the process group, :func:`make_mesh` views the
world as a :class:`repro_torch.comm.DistMesh`.

The spec half of the reference module (``sanitize_spec``,
``best_effort_cache_spec``, ``named``, ``struct_with_sharding``) serves
tensor parallelism, which is not ported (ROADMAP.md queue 1 item 11.2).
"""
from __future__ import annotations

import datetime
import math
import os
import socket
from typing import Sequence

import torch

#: the environment torchrun gives each process it starts
WORLD_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

#: seconds a collective may wait for its peers before the process group
#: gives up: an unmatched exchange fails in minutes, not in the default's
#: ten.
TIMEOUT_S = 300


def is_process_world() -> bool:
    """True when torchrun (or a launcher with its environment) started
    this process: every variable of :data:`WORLD_ENV` is set."""
    return all(k in os.environ for k in WORLD_ENV)


def world_size() -> int:
    """The process world's size, from the environment (no process group
    needed)."""
    return int(os.environ["WORLD_SIZE"])


def rank() -> int:
    """This process's global rank, from the environment."""
    return int(os.environ["RANK"])


def init_world(device: str | torch.device = "cuda",
               timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process world torchrun started; returns this rank's
    device.  On ``cuda`` it pins ``cuda:LOCAL_RANK`` with
    ``torch.cuda.set_device`` before any other CUDA work and builds an
    NCCL group bound to that card (``device_id=``: its communicator is
    made at once, so the first point-to-point call need not involve
    every rank); it refuses a rank with no card of its own, and a world
    in which two ranks share a card (NCCL refuses that too).  On ``cpu``
    the group is gloo.  One warm-up collective runs before it returns.
    A world already joined is returned as it is."""
    import torch.distributed as dist
    if not is_process_world():
        raise RuntimeError(
            f"not a process world: {', '.join(WORLD_ENV)} are unset (start "
            f"the launcher with python -m torch.distributed.run)")
    dev = torch.device(device)
    local = int(os.environ["LOCAL_RANK"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device cuda asked for but torch.cuda.is_available() is "
                "False (pass --device cpu to run the world over gloo)")
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(
                f"rank {rank()} has local rank {local} but this host shows "
                f"{n} card(s): one rank per card (start at most {n} "
                f"processes per host)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dist.is_initialized():
        return dev
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        dist.init_process_group("nccl", device_id=dev, timeout=timeout)
        _check_one_rank_per_card(dev)
    else:
        dist.init_process_group("gloo", timeout=timeout)
        dist.barrier()
    return dev


def _check_one_rank_per_card(dev: torch.device) -> None:
    """Gather every rank's (host, card uuid) and refuse a repeat: the
    world's warm-up collective."""
    import torch.distributed as dist
    me = (socket.gethostname(), str(torch.cuda.get_device_properties(
        dev).uuid))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, me)
    dup = {k for k in seen if seen.count(k) > 1}
    if dup:
        raise RuntimeError(f"two ranks share a card {sorted(dup)}: one rank "
                           f"per card (NCCL refuses more)")


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model")):
    """The joined world as a :class:`~repro_torch.comm.DistMesh` of
    ``shape`` over ``axes`` (data-major, the reference's device order),
    after checking that the world holds ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from ..comm import DistMesh
    n = math.prod(int(s) for s in shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {'x'.join(str(s) for s in shape)} needs a "
                         f"world of {n} processes, have "
                         f"{dist.get_world_size()}")
    return DistMesh(shape, axes)


def describe() -> str:
    """One line naming the world this process runs in (the launchers'
    log line)."""
    import torch.distributed as dist
    if not (is_process_world() and dist.is_initialized()):
        return "in-process world (virtual ranks in one process)"
    return (f"process world: {dist.get_world_size()} processes over "
            f"{dist.get_backend()}, this is rank {dist.get_rank()}")
