"""Träff's circulant collectives over a communicator (the wrapper layer).

Ported from ``repro/core/collectives.py``: every function here assembles
a :class:`CollectiveSpec` and executes its cached plan, so the round
loops live in ``core.plan`` only.  Each takes ``xs``, the list of
per-rank tensors of the ranks ``comm`` holds in this process, and returns
the list of per-rank results.  Every round is exactly one
``comm.shift``: ``ceil(log2 p)`` per reduce-scatter or allgather and
twice that per allreduce (Theorems 1 and 2).

New code should hold a spec and call ``plan()`` directly::

    spec = CollectiveSpec(schedule="power2", use_fused_kernel=True)
    shards = plan(spec, p=comm.p).reduce_scatter(xs, comm)

``counts=`` (flat per-rank block row counts) selects Corollary 3's
non-uniform reduce-scatter / allgather / allreduce (``MPI_Reduce_scatter``)
with the same round and exchange counts.  The alltoall by concatenation
(paper §4) and its ragged alltoallv form take ``ceil(log2 p)`` exchanges
too.  The reference's ring /
recursive-halving / xla baselines, broadcast and the hierarchical and
pipelined forms are not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..kernels.quantize import DEFAULT_GROUP
from .plan import plan
from .spec import CollectiveSpec, as_spec

Tensors = Sequence[torch.Tensor]


def _circulant_spec(**kw) -> CollectiveSpec:
    return CollectiveSpec(kind="circulant", **kw)


def circulant_reduce_scatter(xs: Tensors, comm, *, schedule: str = "halving",
                             op: str | Callable = "add",
                             group: int | None = None,
                             use_fused_kernel: bool | None = None,
                             wire_dtype: str | None = None,
                             wire_group: int = DEFAULT_GROUP,
                             counts: Sequence[int] | None = None
                             ) -> list[torch.Tensor]:
    """Paper Algorithm 1.  Each rank's input has a leading dim n divisible
    by p; rank r gets its reduced block ``(n/p, *rest)``:
    ``out_r = ⊕_i x_i[r-th block]``.  Round k sends ``R[s_k : s_{k-1}]``
    to ``r + s_k`` and folds the received blocks into
    ``R[0 : s_{k-1} - s_k]``; exactly p-1 blocks are sent, received and
    folded per rank (Theorem 1).  ``use_fused_kernel`` routes each
    round's fold and next-send layout through one kernel launch;
    ``wire_dtype="int8"`` sends every round on the packed int8 wire
    (``wire_group`` elements per scale; ~4x fewer bytes, lossy);
    ``counts`` enables Corollary 3's per-rank block row sizes: input
    ``sum(counts)`` rows, output ``max(counts)`` rows with rows past this
    rank's count zeroed."""
    spec = _circulant_spec(schedule=schedule, op=op, group=group,
                           use_fused_kernel=use_fused_kernel,
                           wire_dtype=wire_dtype, wire_group=wire_group,
                           counts=counts)
    return plan(spec, p=comm.p).reduce_scatter(xs, comm)


def circulant_allgather(xs: Tensors, comm, *, schedule: str = "halving",
                        group: int | None = None,
                        use_fused_kernel: bool | None = None,
                        wire_dtype: str | None = None,
                        wire_group: int = DEFAULT_GROUP,
                        counts: Sequence[int] | None = None
                        ) -> list[torch.Tensor]:
    """Gather rank blocks in rank order: each rank's ``(blk, *rest)`` to
    ``(p*blk, *rest)``, identical on every rank.  Replays the
    reduce-scatter skips in reverse; p-1 blocks communicated per rank.
    On the int8 wire each block is quantized once, by its owner.  With
    ``counts`` (Corollary 3 layout) the input is the non-uniform
    reduce-scatter's ``(max(counts), *rest)`` block and the output
    ``(sum(counts), *rest)`` in rank order, replicated."""
    spec = _circulant_spec(schedule=schedule, group=group,
                           use_fused_kernel=use_fused_kernel,
                           wire_dtype=wire_dtype, wire_group=wire_group,
                           counts=counts)
    return plan(spec, p=comm.p).allgather(xs, comm)


def circulant_allreduce(xs: Tensors, comm, *, schedule: str = "halving",
                        op: str | Callable = "add",
                        group: int | None = None,
                        use_fused_kernel: bool | None = None,
                        wire_dtype: str | None = None,
                        wire_group: int = DEFAULT_GROUP,
                        counts: Sequence[int] | None = None
                        ) -> list[torch.Tensor]:
    """Paper Algorithm 2: reduce-scatter + reversed allgather;
    2*ceil(log2 p) exchanges, 2(p-1) blocks moved, p-1 folds per rank.
    ``wire_dtype="int8"`` compresses both phases (a wire RS, then a wire
    AG of the reduced blocks); ``counts`` runs both phases on
    Corollary 3's per-rank block sizes (``(sum(counts), *rest)`` in and
    out, replicated)."""
    spec = _circulant_spec(schedule=schedule, op=op, group=group,
                           use_fused_kernel=use_fused_kernel,
                           wire_dtype=wire_dtype, wire_group=wire_group,
                           counts=counts)
    return plan(spec, p=comm.p).allreduce(xs, comm)


def circulant_alltoall(xs: Tensors, comm, *, schedule: str = "halving",
                       group: int | None = None,
                       use_fused_kernel: bool | None = None,
                       counts: Sequence[Sequence[int]] | None = None
                       ) -> list[torch.Tensor]:
    """All-to-all in ceil(log2 p) rounds: Algorithm 1 with ⊕ =
    concatenation.  Each rank's ``(p, blk, *rest)``, row j its payload
    for rank j, becomes ``(p, blk, *rest)`` with row j rank j's payload
    for it.  Blocks hop through intermediate ranks (the Bruck trade-off:
    round-optimal, not volume-optimal).  The fused form keeps each slot
    as one stacked buffer and lays the final slot into source order with
    one ``permute_rows`` launch.

    ``counts`` (a p×p matrix, ``counts[src][dst]`` rows) selects the
    ragged alltoallv: each rank's input is ``(max_r sum(counts[r]),
    *rest)``, its payload rows in destination order, and its output
    ``(max_r recv_total_r, *rest)``, the received rows in source order,
    zero past its receive total."""
    spec = _circulant_spec(schedule=schedule, group=group,
                           use_fused_kernel=use_fused_kernel, counts=counts)
    return plan(spec, p=comm.p).alltoall(xs, comm)


def circulant_alltoallv(xs: Tensors, comm, counts: Sequence[Sequence[int]],
                        *, schedule: str = "halving",
                        group: int | None = None) -> list[torch.Tensor]:
    """Ragged alltoall (MPI_Alltoallv): :func:`circulant_alltoall` with a
    required per-pair ``counts`` matrix."""
    return circulant_alltoall(xs, comm, schedule=schedule, group=group,
                              counts=counts)


def reduce_scatter(xs: Tensors, comm, *, spec: CollectiveSpec | None = None,
                   **kw) -> list[torch.Tensor]:
    """Reduce-scatter dispatcher: ``spec=CollectiveSpec(...)`` or bare
    spec kwargs."""
    return plan(as_spec(spec, **kw), p=comm.p).reduce_scatter(xs, comm)


def allgather(xs: Tensors, comm, *, spec: CollectiveSpec | None = None,
              **kw) -> list[torch.Tensor]:
    """Allgather dispatcher — see :func:`reduce_scatter`."""
    return plan(as_spec(spec, **kw), p=comm.p).allgather(xs, comm)


def allreduce(xs: Tensors, comm, *, spec: CollectiveSpec | None = None,
              **kw) -> list[torch.Tensor]:
    """Allreduce dispatcher — see :func:`reduce_scatter`."""
    return plan(as_spec(spec, **kw), p=comm.p).allreduce(xs, comm)


def alltoall(xs: Tensors, comm, *, spec: CollectiveSpec | None = None,
             **kw) -> list[torch.Tensor]:
    """Alltoall(v) dispatcher — see :func:`reduce_scatter`.  A spec with a
    p×p ``counts`` matrix runs the ragged alltoallv."""
    return plan(as_spec(spec, **kw), p=comm.p).alltoall(xs, comm)
