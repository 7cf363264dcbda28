"""Transport for the circulant collectives: one exchange per round.

The reference runs every round as one ``lax.ppermute`` under
``shard_map`` (``repro.compat.ppermute`` with the ``_fwd_perm`` /
``_bwd_perm`` permutations of ``repro/core/plan.py``).  Here a round is
one :meth:`shift`: the tensor of rank ``r`` goes to rank ``(r + s) mod p``
(a negative ``s`` is the allgather direction).  Two worlds implement it:

* :class:`LocalComm` — ``p`` virtual ranks in one process on one device.
  Every plan function takes a list of per-rank tensors, one per local
  rank, and the ranks step in lockstep through the plan's round protocol.
  An exchange is an explicit copy (``clone``), so no two ranks ever share
  storage.  A :class:`LocalMesh` of ``D × M`` virtual ranks (data-major,
  the reference's device order) has one ``LocalComm`` per mesh axis: each
  holds all ``D·M`` ranks and exchanges along its axis only, every group
  of that axis in the same lockstep exchange.
* :class:`DistComm` — one rank per process over ``torch.distributed``
  (``batch_isend_irecv``: gloo on the CPU, NCCL on cards).  Its lists
  hold one tensor.

``exchanges`` counts one per :meth:`shift` call in both worlds.  It takes
the place of the reference's HLO collective-permute count, which is the
oracle for round counts: ``ceil_log2(p)`` per reduce-scatter and twice
that per allreduce.  ``bytes`` sums the bytes of every payload a
:meth:`shift` sends from this process (all its local ranks), standing in
for the byte half of ``repro/analysis/hlo_budget.py``: on the int8 wire a
round moves ``rows * (cols + 4 * ceil(cols / g))`` bytes per rank.  On a
mesh both count per axis.

:meth:`shift` is differentiable: under autograd its backward is the
reverse shift, one more counted exchange, as the transpose of the
reference's ``ppermute`` is the reverse collective-permute in its HLO.
"""
from __future__ import annotations

from typing import Sequence

import torch


class LocalComm:
    """``p`` virtual ranks in one process (lists hold ``p`` tensors), or
    one axis of a :class:`LocalMesh`: lists then hold all ``size`` ranks
    of the mesh, and ``ranks[g]`` is rank g's coordinate on this axis,
    ``(g // stride) % p``."""

    def __init__(self, p: int, *, stride: int = 1, size: int | None = None):
        if p < 1:
            raise ValueError(f"p must be >= 1, got {p}")
        size = p if size is None else size
        if stride < 1 or size % (p * stride):
            raise ValueError(f"axis of {p} at stride {stride} does not tile "
                             f"{size} ranks")
        self.p, self.stride, self.size = p, stride, size
        self.ranks = tuple((g // stride) % p for g in range(size))
        self.exchanges = 0
        self.bytes = 0

    def _peer(self, g: int, s: int) -> int:
        """The rank whose tensor rank g receives in a shift by ``s``."""
        c = self.ranks[g]
        return g + ((c - s) % self.p - c) * self.stride

    def shift(self, xs: Sequence[torch.Tensor], s: int) -> list[torch.Tensor]:
        """Rank r's tensor goes to rank (r + s) mod p of its axis group;
        returns what each local rank received (fresh storage)."""
        _check_len(self, xs)
        return _shift(self, xs, s)

    def _exchange(self, xs, s: int) -> list[torch.Tensor]:
        self.exchanges += 1
        self.bytes += sum(_nbytes(x) for x in xs)
        return [xs[self._peer(g, s)].clone() for g in range(self.size)]

    def all_reduce_sum(self, xs: Sequence[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """Elementwise sum over each axis group, in rank order,
        replicated within the group (differentiable)."""
        _check_len(self, xs)
        out: list = [None] * self.size
        for g in range(self.size):
            if out[g] is not None:
                continue
            members = [g + (k - self.ranks[g]) * self.stride
                       for k in range(self.p)]  # the group, in axis order
            acc = xs[members[0]]
            for m in members[1:]:
                acc = acc + xs[m]
            for m in members:
                out[m] = acc.clone()
        return out


class LocalMesh:
    """``D × M`` (any rank) virtual ranks in one process, numbered
    row-major over ``shape`` — for ``("data", "model")`` data-major,
    rank ``d·M + m``, the reference's ``make_mesh`` device order — with
    one :class:`LocalComm` per axis (:meth:`axis`), each counting its own
    exchanges and bytes."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model")):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.size = 1
        for n in self.shape:
            self.size *= n
        self.axes = {}
        stride = self.size
        for name, n in zip(self.axis_names, self.shape):
            stride //= n
            self.axes[name] = LocalComm(n, stride=stride, size=self.size)

    def axis(self, name: str) -> LocalComm:
        """The communicator of axis ``name``."""
        return self.axes[name]


class _Shift(torch.autograd.Function):
    """A differentiable exchange: the backward is the reverse shift."""

    @staticmethod
    def forward(ctx, comm, s, *xs):
        ctx.comm, ctx.s = comm, s
        return tuple(comm._exchange(xs, s))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.comm._exchange(gs, -ctx.s))


def _shift(comm, xs, s: int) -> list[torch.Tensor]:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_Shift.apply(comm, s, *xs))
    return comm._exchange(xs, s)


class DistComm:
    """One rank of the default ``torch.distributed`` process group (lists
    hold one tensor: this process's)."""

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "DistComm needs torch.distributed.init_process_group first")
        self.p = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)
        self.exchanges = 0
        self.bytes = 0

    def shift(self, xs: Sequence[torch.Tensor], s: int) -> list[torch.Tensor]:
        """Send to rank (r + s) mod p and receive from (r - s) mod p as one
        paired ``batch_isend_irecv``; returns ``[received]``."""
        _check_len(self, xs)
        return _shift(self, xs, s)

    def _exchange(self, xs, s: int) -> list[torch.Tensor]:
        import torch.distributed as dist
        self.exchanges += 1
        self.bytes += _nbytes(xs[0])
        x = xs[0].contiguous()
        p, r = self.p, self.rank
        if s % p == 0:
            return [x.clone()]
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (r + s) % p),
               dist.P2POp(dist.irecv, out, (r - s) % p)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [out]

    def all_reduce_sum(self, xs: Sequence[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """``all_reduce`` (SUM) of this rank's tensor; returns a new one."""
        import torch.distributed as dist
        _check_len(self, xs)
        out = xs[0].clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return [out]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _check_len(comm, xs) -> None:
    if len(xs) != len(comm.ranks):
        raise ValueError(
            f"{type(comm).__name__} holds {len(comm.ranks)} local rank(s), "
            f"got {len(xs)} tensors")
