"""Circulant-graph skip schedules for Träff's reduce-scatter / allreduce.

The paper's Algorithm 1 computes skips by repeated halving with round-up:
``s_0 = p, s_{k+1} = ceil(s_k / 2)`` until 1 — giving exactly
``ceil(log2 p)`` communication rounds for ANY p.  Corollary 2 generalises:
any strictly decreasing sequence ``s_0 > s_1 > ... > s_{q-1} = 1`` works
provided every ``0 < i < p`` is a sum of DISTINCT skips.

Pure Python, framework-free: the JAX package's ``repro.core.schedule``
copied for the PyTorch port (importing it would pull JAX in through
``repro/core/__init__.py``).  The tests hold both copies equal for every
schedule and p <= 64.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Sequence


def ceil_log2(p: int) -> int:
    """ceil(log2 p) for p >= 1 (0 rounds for p == 1)."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    return (p - 1).bit_length()


# ---------------------------------------------------------------------------
# Skip-sequence constructors (Corollary 2 family)
# ---------------------------------------------------------------------------

def halving_skips(p: int) -> tuple[int, ...]:
    """The paper's schedule: repeated halving of p with round-up.

    Returns the per-round skips ``(s_1, s_2, ..., s_q)``; the send in
    round k uses skip ``s_k`` and block range [s_k, s_{k-1}).
    len == ceil_log2(p).
    """
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    skips = []
    s = p
    while s > 1:
        s = (s + 1) // 2
        skips.append(s)
    return tuple(skips)


def power2_skips(p: int) -> tuple[int, ...]:
    """Straight power-of-two schedule (Bruck-style, paper §2.1 Examples):
    s_0 = p and s_k = largest power of two < s_{k-1}."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    skips = []
    s = p
    while s > 1:
        nxt = 1 << (s - 1).bit_length() - 1  # largest power of two < s
        skips.append(nxt)
        s = nxt
    return tuple(skips)


def fully_connected_skips(p: int) -> tuple[int, ...]:
    """The folklore p-1-round schedule (paper §2.1 Examples): p-1, ..., 1."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    return tuple(range(p - 1, 0, -1))


def sqrt_skips(p: int) -> tuple[int, ...]:
    """O(sqrt p)-round schedule (paper §2.1 Examples):
    s_k = p - k*ceil(sqrt p) while > ceil(sqrt p), then halving below."""
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    if p == 1:
        return ()
    c = math.isqrt(p - 1) + 1  # ceil(sqrt(p)) for non-squares; >= 1
    skips: list[int] = []
    s = p - c
    while s > c:
        skips.append(s)
        s -= c
    prev = skips[-1] if skips else p
    s = prev
    while s > 1:
        s = (s + 1) // 2
        if not skips or s < skips[-1]:
            skips.append(s)
    if not skips:
        skips = [1]
    if skips[-1] != 1:
        skips.append(1)
    return tuple(skips)


def two_level_skips(p: int, group: int) -> tuple[int, ...]:
    """Topology-decomposed schedule: the halving skips of ``group``
    (intra-group) merged with ``group`` x the halving skips of
    ``p // group`` (inter-group), in decreasing order."""
    if p % group != 0:
        raise ValueError(f"group {group} must divide p {p}")
    intra = halving_skips(group)
    inter = tuple(s * group for s in halving_skips(p // group))
    skips = tuple(sorted(set(intra) | set(inter), reverse=True))
    if p > 1 and (not skips or skips[-1] != 1):
        raise AssertionError("two_level schedule must end at 1")
    return skips


SCHEDULES: dict[str, Callable[[int], tuple[int, ...]]] = {
    "halving": halving_skips,
    "power2": power2_skips,
    "fully_connected": fully_connected_skips,
    "sqrt": sqrt_skips,
}


def get_skips(p: int, schedule: str = "halving", *, group: int | None = None
              ) -> tuple[int, ...]:
    """Per-round skip distances of ``schedule`` at ``p`` ranks — the
    s_k of Corollary 2; ``len(get_skips(p, s))`` is the round count."""
    if schedule == "two_level":
        if group is None:
            raise ValueError("two_level schedule needs group=")
        return two_level_skips(p, group)
    try:
        fn = SCHEDULES[schedule]
    except KeyError:
        raise ValueError(
            f"unknown schedule {schedule!r}; have {sorted(SCHEDULES)} + two_level"
        ) from None
    return fn(p)


# ---------------------------------------------------------------------------
# Corollary-2 validity
# ---------------------------------------------------------------------------

def _subset_sum_reachable(p: int, skips: Sequence[int]) -> bool:
    """Exact check: every 0 < i < p is a sum of distinct skips."""
    reach = 1  # bitmask; bit i set <=> i reachable
    for s in skips:
        reach |= reach << s
    mask = (1 << p) - 1
    return (reach & mask) == mask


def is_valid_schedule(p: int, skips: Sequence[int]) -> bool:
    """Corollary 2 precondition plus fold-liveness ``s_{k-1} <= 2 s_k``
    (received blocks must fold into still-live blocks)."""
    if p == 1:
        return len(skips) == 0
    sk = list(skips)
    if sorted(sk, reverse=True) != sk or len(set(sk)) != len(sk):
        return False
    if sk[-1] != 1:
        return False
    prev = p
    for s in sk:
        if prev > 2 * s:
            return False
        prev = s
    return _subset_sum_reachable(p, sk)


@dataclass(frozen=True)
class RoundPlan:
    """One communication round of Algorithm 1 (forward direction).

    send block range [lo, hi) to rank (r + skip) mod p;
    receive same count from (r - skip) mod p; reduce into [0, hi-lo).
    """
    skip: int
    lo: int
    hi: int

    @property
    def nblocks(self) -> int:
        return self.hi - self.lo


@lru_cache(maxsize=4096)
def reduce_scatter_plan(p: int, schedule: str = "halving",
                        group: int | None = None) -> tuple[RoundPlan, ...]:
    """Round plans for Algorithm 1 under any Corollary-2 schedule: round k
    sends R[s_k .. s_{k-1} - 1] to (r + s_k) mod p (s_0 = p).  Total
    blocks sent = p - 1 (Theorem 1)."""
    skips = get_skips(p, schedule, group=group)
    if p > 1 and not is_valid_schedule(p, skips):
        raise ValueError(f"schedule {schedule} invalid for p={p}: {skips}")
    plans = []
    prev = p
    for s in skips:
        plans.append(RoundPlan(skip=s, lo=s, hi=prev))
        prev = s
    return tuple(plans)


def allgather_plan(p: int, schedule: str = "halving",
                   group: int | None = None) -> tuple[RoundPlan, ...]:
    """Reversed skip stack (Algorithm 2's second phase): the round with
    skip s sends R[0 .. s'-s-1] toward (r - s) mod p and receives into
    R[s .. s'-1] from (r + s) mod p."""
    return tuple(reversed(reduce_scatter_plan(p, schedule, group)))


@lru_cache(maxsize=4096)
def alltoall_moves(p: int, schedule: str = "halving",
                   group: int | None = None
                   ) -> tuple[tuple[int, tuple[tuple[int, int], ...]], ...]:
    """Entry trajectories of alltoall-by-concatenation (paper §4).

    In the Bruck-style alltoall, the payload addressed from ``src`` to
    ``dst`` starts in rotated slot ``d = (dst - src) mod p`` and, whenever
    its current slot lies in a round's send window ``[skip, prev)``, hops
    forward by ``skip`` (slot decreases by ``skip``).  The whole walk is
    trace-time data: this returns, per round, ``(skip, moved)`` where
    ``moved`` is the tuple of ``(d, shift)`` pairs — the destination
    offsets whose entries hop this round and the total shift already
    applied to them, i.e. the entry for offset ``d`` currently sits on
    rank ``(src + shift) mod p``.  After the last round every offset has
    reached slot 0 with total shift ``d`` — delivered (asserted).

    Consumed by the plan layer (alltoallv row tables) and the cost model
    (the hop-through-intermediate-ranks β volume: the classic Bruck
    amplification, sum(len(moved)) block sends per rank instead of p-1).
    """
    plans = reduce_scatter_plan(p, schedule, group)
    slot = list(range(p))
    shift = [0] * p
    rounds = []
    for pl in plans:
        moved = []
        for d in range(1, p):
            if pl.lo <= slot[d] < pl.hi:
                moved.append((d, shift[d]))
                slot[d] -= pl.skip
                shift[d] += pl.skip
        rounds.append((pl.skip, tuple(moved)))
    assert all(s == 0 for s in slot), \
        f"alltoall trajectories must end in slot 0 (p={p}, {schedule})"
    assert all(shift[d] == d for d in range(p)), \
        f"total shift must equal the destination offset (p={p}, {schedule})"
    return tuple(rounds)
