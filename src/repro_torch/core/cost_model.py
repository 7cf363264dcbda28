"""The alltoall part of the reference's cost model (``repro.core.cost_model``).

Only the two functions the alltoall(v) plans need: the blocks each rank
sends per round of alltoall-by-concatenation, and the per-round wire
widths of the ragged alltoallv, which ``plan._build_a2a`` takes its
table widths from (one implementation of the worst-windowed-count-sum
formula, as in the reference).  The α-β-γ timing model and the other
collectives' formulas are not ported yet (ROADMAP.md queue 1 item 1).
Pure Python; the tests hold both copies equal.
"""
from __future__ import annotations

from .schedule import alltoall_moves


def a2a_round_entries(p: int, schedule: str = "halving",
                      group: int | None = None) -> tuple[int, ...]:
    """Blocks each rank sends per round of alltoall-by-concatenation.

    Entries hop through intermediate ranks, so the per-round send count
    is the number of destination offsets whose slot lies in the round's
    window — NOT the p-1 of reduce-scatter.  ``sum(a2a_round_entries(p))``
    is the classic Bruck volume amplification (≈ (p/2)·ceil(log2 p) for
    the halving schedule)."""
    return tuple(len(moved) for _, moved in
                 alltoall_moves(p, schedule, group))


def alltoallv_round_widths(counts, schedule: str = "halving",
                           group: int | None = None) -> tuple[int, ...]:
    """Per-round wire widths (rows) of the ragged alltoallv: the worst
    windowed count sum over ranks, at least 1 — the widths of
    ``A2APlan.round_tables``."""
    p = len(counts)
    widths = []
    for _, moved in alltoall_moves(p, schedule, group):
        per_rank = []
        for r in range(p):
            w = 0
            for d, m in moved:
                src = (r - m) % p
                w += counts[src][(src + d) % p]
            per_rank.append(w)
        widths.append(max(max(per_rank), 1) if per_rank else 1)
    return tuple(widths)
