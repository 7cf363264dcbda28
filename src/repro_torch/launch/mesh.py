"""The process world and the sharding specs, ported from
``repro/launch/mesh.py``.

The reference's mesh gives every rank a device of its own.  Here a rank
is a process, started by ``python -m torch.distributed.run`` (torchrun,
or any launcher that sets the same environment: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), one
per card over NCCL, or one per CPU process over gloo.  Nothing here
touches ``torch.distributed`` or CUDA on import: :func:`init_world`
pins the card and builds the process group, :func:`make_mesh` views the
world as a :class:`repro_torch.comm.DistMesh`.

The spec half is pure functions of shapes and mesh sizes, and needs no
card and no process group.  It works on the types of
``repro_torch/sharding.py`` (``PartitionSpec``, ``AbstractMesh``,
``NamedSharding``): :func:`make_production_mesh` (the reference's
(16, 16) and (2, 16, 16) meshes as an ``AbstractMesh``, axis name to
size, no devices), :func:`sanitize_spec` / :func:`sanitize_specs` /
:func:`best_effort_cache_spec` (the reference's, line for line), and
:func:`named` / :func:`struct_with_sharding`, which map specs to DTensor
placements (``Shard`` / ``Replicate``, one per mesh axis) and each
leaf's per-rank shape and dtype (a ``meta`` tensor).  Tensor parallelism
runs on the port's own meshes, not on a ``DeviceMesh``:
``models/sharding.tp_layout`` reads the sanitized specs to give each rank
its blocks, and the model-axis calls go over a ``LocalMesh`` or
``DistMesh`` axis (``models/sharding.py`` says why not DTensor).
"""
from __future__ import annotations

import datetime
import math
import os
import socket
from typing import Sequence

import torch

from .. import tree as T
from ..sharding import AbstractMesh, NamedSharding, PartitionSpec, axis_size

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


# ---------------------------------------------------------------------------
# The spec half: meshes by axis sizes, specs, placements
# ---------------------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production meshes: (data=16, model=16), and 2
    pods as (pod=2, data=16, model=16).  Only the axis sizes: it
    allocates no devices and joins no process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def sanitize_spec(mesh, spec: PartitionSpec, shape, *,
                  model_axis: str = "model",
                  fallback: bool = True) -> PartitionSpec:
    """Drop sharding on dims the mesh axes don't divide evenly;
    replication is always sound.  If the model axis was dropped (e.g. 8
    experts on a 16-way model axis, 12 heads on 16) RELOCATE it to the
    largest still-unsharded divisible dim — otherwise the leaf (and its
    optimizer state) silently replicates over the whole model axis,
    which for MoE expert stacks is a per-chip memory catastrophe."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    entries = entries[:len(shape)]
    had_model = any(
        (e == model_axis) or (isinstance(e, tuple) and model_axis in e)
        for e in entries)
    out = []
    for dim, entry in zip(shape, entries):
        size = axis_size(mesh, entry)
        out.append(entry if size > 1 and dim % size == 0 else
                   (entry if size == 1 else None))
    has_model = any(
        (e == model_axis) or (isinstance(e, tuple) and model_axis in e)
        for e in out)
    if fallback and had_model and not has_model and model_axis in mesh.shape:
        msize = mesh.shape[model_axis]
        cand, best = None, 0
        for i, (dim, entry) in enumerate(zip(shape, out)):
            if entry is None and dim % msize == 0 and dim >= msize \
                    and dim > best:
                cand, best = i, dim
        if cand is not None:
            out[cand] = model_axis
    return PartitionSpec(*out)


def _shape_of(leaf) -> tuple:
    """A leaf's shape: a tensor's, or the leaf itself (a shape tuple)."""
    return tuple(getattr(leaf, "shape", leaf))


def sanitize_specs(mesh, specs, shapes, *, model_axis: str = "model"):
    """Tree version: specs and shapes are matching trees (shapes as
    tensors or shape tuples)."""
    return T.unflatten(
        (path, sanitize_spec(mesh, sp, _shape_of(sh), model_axis=model_axis))
        for (path, sp), (_, sh) in zip(T.flatten(specs), T.flatten(shapes)))


def named(mesh, specs):
    """Each spec of the tree as a :class:`NamedSharding` on ``mesh``."""
    return T.map_leaves(lambda sp: NamedSharding(mesh, sp), specs)


def struct_with_sharding(shapes, shardings):
    """Each leaf's per-rank block as a ``meta`` tensor (shape and dtype,
    no storage): ``shapes`` a tree of tensors (``meta`` or not),
    ``shardings`` the matching tree of :func:`named`."""
    return T.unflatten(
        (path, torch.empty(ns.shard_shape(tuple(x.shape)), dtype=x.dtype,
                           device="meta"))
        for (path, x), (_, ns) in zip(T.flatten(shapes),
                                      T.flatten(shardings)))


def best_effort_cache_spec(mesh, shape, global_batch: int,
                           data_axes, model_axis) -> PartitionSpec:
    """Generic cache/state sharding: the dim equal to the global batch goes
    over the data axes; the largest remaining dim divisible by the model
    axis goes over model."""
    entries = [None] * len(shape)
    dsize = int(math.prod([mesh.shape[a] for a in data_axes]))
    msize = mesh.shape[model_axis]
    batch_dim = None
    for i, d in enumerate(shape):
        if d == global_batch and d % dsize == 0:
            batch_dim = i
            entries[i] = tuple(data_axes)
            break
    model_dim, best = None, 0
    for i, d in enumerate(shape):
        if i != batch_dim and d % msize == 0 and d > best and d >= msize:
            model_dim, best = i, d
    if model_dim is not None:
        entries[model_dim] = model_axis
    return PartitionSpec(*entries)
