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
  storage.
* :class:`DistComm` — one rank per process over ``torch.distributed``
  (``batch_isend_irecv``: gloo on the CPU, NCCL on cards).  Its lists
  hold one tensor.

``exchanges`` counts one per :meth:`shift` call in both worlds.  It takes
the place of the reference's HLO collective-permute count, which is the
oracle for round counts: ``ceil_log2(p)`` per reduce-scatter and twice
that per allreduce.  ``bytes`` sums the bytes of every payload a
:meth:`shift` sends from this process (all its local ranks), standing in
for the byte half of ``repro/analysis/hlo_budget.py``: on the int8 wire a
round moves ``rows * (cols + 4 * ceil(cols / g))`` bytes per rank.
"""
from __future__ import annotations

from typing import Sequence

import torch


class LocalComm:
    """``p`` virtual ranks in one process (lists hold ``p`` tensors)."""

    def __init__(self, p: int):
        if p < 1:
            raise ValueError(f"p must be >= 1, got {p}")
        self.p = p
        self.ranks = tuple(range(p))
        self.exchanges = 0
        self.bytes = 0

    def shift(self, xs: Sequence[torch.Tensor], s: int) -> list[torch.Tensor]:
        """Rank r's tensor goes to rank (r + s) mod p; returns what each
        local rank received (fresh storage)."""
        _check_len(self, xs)
        self.exchanges += 1
        self.bytes += sum(_nbytes(x) for x in xs)
        p = self.p
        return [xs[(r - s) % p].clone() for r in range(p)]

    def all_reduce_sum(self, xs: Sequence[torch.Tensor]
                       ) -> list[torch.Tensor]:
        """Elementwise sum over ranks, in rank order, replicated."""
        _check_len(self, xs)
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return [acc.clone() for _ in xs]


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
        import torch.distributed as dist
        _check_len(self, xs)
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
