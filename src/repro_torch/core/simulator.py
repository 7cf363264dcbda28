"""Message-passing simulator executing Träff's Algorithms 1 and 2 verbatim.

Ported from ``repro/core/simulator.py``: pure numpy, no torch.  It
serves two purposes:

1. **Paper validation** — counts communication rounds, blocks sent/received
   and ⊕-applications per processor and asserts the exact Theorem 1/2
   quantities (rounds = ceil(log2 p); blocks = p-1 for reduce-scatter and
   2(p-1) for allreduce; ⊕-applications = p-1).

2. **Numerical oracle** — the port's circulant collectives fold in the
   schedule's order, as these do, so the conformance harness
   (``core/conformance.py``) holds them bitwise equal to these results
   for float32 and int32, the non-uniform (``counts=``) form included.

The simulator models the paper's communication model exactly: in each
round every processor simultaneously sends one contiguous block range and
receives one (``Send || Recv``); send/receive pairs are matched through a
mailbox, so a round is a synchronous step of the circulant graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .schedule import (
    allgather_plan,
    ceil_log2,
    get_skips,
    reduce_scatter_plan,
)

__all__ = [
    "CommStats", "simulate_reduce_scatter", "simulate_allgather",
    "simulate_allreduce", "simulate_alltoall", "simulate_alltoallv",
    "ref_reduce_scatter", "ref_allreduce", "ref_alltoall",
]

Op = Callable[[np.ndarray, np.ndarray], np.ndarray]


@dataclass
class CommStats:
    """Per-processor communication/computation counters (Theorem 1/2)."""
    rounds: int = 0
    blocks_sent: list[int] = field(default_factory=list)   # per processor
    blocks_recv: list[int] = field(default_factory=list)
    reductions: list[int] = field(default_factory=list)    # ⊕ applications
    send_events: list[tuple[int, int, int, int]] = field(default_factory=list)
    # (round, src, dst, nblocks) — full trace for graph-structure tests

    def assert_theorem1(self, p: int) -> None:
        assert self.rounds == ceil_log2(p), (self.rounds, ceil_log2(p))
        assert all(b == p - 1 for b in self.blocks_sent), self.blocks_sent
        assert all(b == p - 1 for b in self.blocks_recv), self.blocks_recv
        assert all(x == p - 1 for x in self.reductions), self.reductions

    def assert_theorem2(self, p: int) -> None:
        assert self.rounds == 2 * ceil_log2(p), (self.rounds, ceil_log2(p))
        assert all(b == 2 * (p - 1) for b in self.blocks_sent)
        assert all(b == 2 * (p - 1) for b in self.blocks_recv)
        assert all(x == p - 1 for x in self.reductions)


def _check_block_shapes(inputs: Sequence[Sequence[np.ndarray]]) -> int:
    p = len(inputs)
    for r, vec in enumerate(inputs):
        if len(vec) != p:
            raise ValueError(f"processor {r} has {len(vec)} blocks, want {p}")
    # Paper requirement: V_i[r] and V_j[r] must have equal element counts.
    for i in range(p):
        sizes = {np.asarray(inputs[r][i]).shape for r in range(p)}
        if len(sizes) != 1:
            raise ValueError(f"block column {i} has inconsistent shapes {sizes}")
    return p


def simulate_reduce_scatter(
    inputs: Sequence[Sequence[np.ndarray]],
    op: Op = np.add,
    schedule: str = "halving",
    group: int | None = None,
) -> tuple[list[np.ndarray], CommStats]:
    """Algorithm 1 (partitioned all-reduce), executed for all p processors.

    ``inputs[r][i]`` is V_r[i].  Returns ``(W, stats)`` where ``W[r]`` is
    the reduction over column r:  W[r] = op-reduce_i  V_i[r].

    Blocks may have different sizes per column (MPI_Reduce_scatter flavor);
    Corollary 3's worst case is exercised by concentrating elements in one
    column.  ``group`` is the ``two_level`` schedule's intra-group size
    (an addition to the reference's signature, which cannot run that
    schedule).
    """
    p = _check_block_shapes(inputs)
    stats = CommStats(blocks_sent=[0] * p, blocks_recv=[0] * p,
                      reductions=[0] * p)
    # Rotated initial copy: R_r[i] = V_r[(r + i) mod p]
    R = [[np.array(inputs[r][(r + i) % p], copy=True)
          for i in range(p)] for r in range(p)]
    plans = reduce_scatter_plan(p, schedule, group)
    for k, pl in enumerate(plans):
        stats.rounds += 1
        s = pl.skip
        # Synchronous round: gather all messages first (Send || Recv).
        mailbox = {}
        for r in range(p):
            dst = (r + s) % p
            payload = [R[r][i] for i in range(pl.lo, pl.hi)]
            mailbox[dst] = payload
            stats.blocks_sent[r] += len(payload)
            stats.send_events.append((k, r, dst, len(payload)))
        for r in range(p):
            T = mailbox[r]
            stats.blocks_recv[r] += len(T)
            for i, t in enumerate(T):
                R[r][i] = op(R[r][i], t)
                stats.reductions[r] += 1
    W = [R[r][0] for r in range(p)]
    return W, stats


def simulate_allgather(
    blocks: Sequence[np.ndarray],
    schedule: str = "halving",
    group: int | None = None,
) -> tuple[list[list[np.ndarray]], CommStats]:
    """Algorithm 2's second phase standalone: rank r starts with ``blocks[r]``
    and ends with all p blocks in rank order.

    Buffer semantics: R_r[i] will hold the block belonging to rank
    (r + i) mod p (same rotated coordinates as the RS phase).  Rounds
    replay the reversed RS skips: with skip s and previous range bound s',
    send R[0 .. s'-s-1] to (r - s) mod p, receive into R[s .. s'-1] from
    (r + s) mod p.
    """
    p = len(blocks)
    stats = CommStats(blocks_sent=[0] * p, blocks_recv=[0] * p,
                      reductions=[0] * p)
    R: list[list[np.ndarray | None]] = [[None] * p for _ in range(p)]
    for r in range(p):
        R[r][0] = np.array(blocks[r], copy=True)
    for pl in allgather_plan(p, schedule, group):
        stats.rounds += 1
        s, nb = pl.skip, pl.nblocks
        mailbox = {}
        for r in range(p):
            dst = (r - s) % p
            payload = [R[r][i] for i in range(0, nb)]
            assert all(x is not None for x in payload), "sending unfilled block"
            mailbox[dst] = payload
            stats.blocks_sent[r] += nb
        for r in range(p):
            T = mailbox[r]
            stats.blocks_recv[r] += len(T)
            for i, t in enumerate(T):
                R[r][pl.lo + i] = t
    # Un-rotate: out[r][j] = block of rank j = R[r][(j - r) mod p]
    out = [[R[r][(j - r) % p] for j in range(p)] for r in range(p)]
    for r in range(p):
        for j in range(p):
            assert out[r][j] is not None
    return out, stats  # type: ignore[return-value]


def simulate_allreduce(
    inputs: Sequence[Sequence[np.ndarray]],
    op: Op = np.add,
    schedule: str = "halving",
    group: int | None = None,
) -> tuple[list[list[np.ndarray]], CommStats]:
    """Algorithm 2: reduce-scatter phase + reversed allgather phase.

    Returns ``(W, stats)`` with ``W[r][i]`` = fully reduced block i on
    processor r (identical across r; Theorem 2 counters in stats).
    """
    p = _check_block_shapes(inputs)
    W_scat, st1 = simulate_reduce_scatter(inputs, op, schedule, group)
    out, st2 = simulate_allgather(W_scat, schedule, group)
    stats = CommStats(
        rounds=st1.rounds + st2.rounds,
        blocks_sent=[a + b for a, b in zip(st1.blocks_sent, st2.blocks_sent)],
        blocks_recv=[a + b for a, b in zip(st1.blocks_recv, st2.blocks_recv)],
        reductions=st1.reductions,
        send_events=st1.send_events,
    )
    return out, stats


def simulate_alltoall(
    inputs: Sequence[Sequence[np.ndarray]],
    schedule: str = "halving",
) -> tuple[list[list[np.ndarray]], CommStats]:
    """All-to-all via reduce-scatter with ⊕ = concatenation (paper §4).

    ``inputs[r][i]`` is the block rank r wants delivered to rank i.
    Implemented exactly as Algorithm 1 where a "block" is a *list* of
    (source_rank, payload) pairs and ⊕ concatenates lists; at the end,
    processor r's W is the list of p payloads addressed to it.

    Blocks may have ANY shape per (src, dst) pair — including empty —
    so this is also the alltoallv (MPI_Alltoallv) oracle; see
    :func:`simulate_alltoallv`.

    Round count is ceil(log2 p) (optimal); volume is amplified (blocks
    travel multiple hops) — the known Bruck trade-off, reported in stats.
    """
    p = len(inputs)
    stats = CommStats(blocks_sent=[0] * p, blocks_recv=[0] * p,
                      reductions=[0] * p)
    # R_r[i]: list of (src, payload) destined for rank (r + i) mod p.
    R = [[[(r, np.array(inputs[r][(r + i) % p], copy=True))]
          for i in range(p)] for r in range(p)]
    for k, pl in enumerate(reduce_scatter_plan(p, schedule)):
        stats.rounds += 1
        s = pl.skip
        mailbox = {}
        for r in range(p):
            dst = (r + s) % p
            payload = [R[r][i] for i in range(pl.lo, pl.hi)]
            mailbox[dst] = payload
            stats.blocks_sent[r] += sum(len(x) for x in payload)
        for r in range(p):
            T = mailbox[r]
            stats.blocks_recv[r] += sum(len(x) for x in T)
            for i, t in enumerate(T):
                R[r][i] = R[r][i] + t  # ⊕ = concatenation
                stats.reductions[r] += 1
    out: list[list[np.ndarray]] = []
    for r in range(p):
        got = {src: payload for src, payload in R[r][0]}
        assert set(got) == set(range(p)), f"rank {r} missing sources"
        out.append([got[j] for j in range(p)])
    return out, stats


def simulate_alltoallv(
    inputs: Sequence[Sequence[np.ndarray]],
    schedule: str = "halving",
) -> tuple[list[list[np.ndarray]], CommStats]:
    """Ragged alltoall oracle: ``inputs[src][dst]`` is the (arbitrarily
    sized, possibly empty) payload src sends to dst.  Round structure is
    identical to :func:`simulate_alltoall` (which already moves payloads
    verbatim); this wrapper only asserts the round count — Theorem 1's
    ``rounds`` survive ragged per-pair counts unchanged."""
    p = len(inputs)
    out, stats = simulate_alltoall(inputs, schedule=schedule)
    assert stats.rounds == len(get_skips(p, schedule)), \
        (stats.rounds, p, schedule)
    return out, stats


# ---------------------------------------------------------------------------
# Reference "one-shot" answers for oracle comparisons
# ---------------------------------------------------------------------------

def ref_alltoall(inputs) -> list[list[np.ndarray]]:
    """Host ground truth for alltoall(v): a transpose of the per-pair
    payload matrix — ``out[r][j] = inputs[j][r]``."""
    p = len(inputs)
    return [[np.array(inputs[j][r], copy=True) for j in range(p)]
            for r in range(p)]


def ref_reduce_scatter(inputs, op=np.add):
    """Oracle: rank r's result block = op-fold of inputs[i][r] over all
    ranks i, in rank order (the sequential reference the simulated
    schedules must reproduce)."""
    p = len(inputs)
    out = []
    for r in range(p):
        acc = np.array(inputs[0][r], copy=True)
        for i in range(1, p):
            acc = op(acc, inputs[i][r])
        out.append(acc)
    return out


def ref_allreduce(inputs, op=np.add):
    """Oracle allreduce: every rank ends with the full reduced block
    column (reduce-scatter oracle replicated p times)."""
    col = ref_reduce_scatter(inputs, op)
    return [list(col) for _ in range(len(inputs))]
