"""Message-passing oracle of alltoall(v) by concatenation (paper §4).

Ported from ``repro/core/simulator.py`` (its alltoall part): pure numpy,
executing Algorithm 1 verbatim with ⊕ = list concatenation.  The tests
hold the port's alltoall(v) plans against it and against the host
transpose :func:`ref_alltoall`.  The reduce-scatter / allreduce
simulators are not ported (the port's collectives are held against the
reference's plans directly).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .schedule import get_skips, reduce_scatter_plan

__all__ = ["CommStats", "simulate_alltoall", "simulate_alltoallv",
           "ref_alltoall"]


@dataclass
class CommStats:
    """Per-processor communication counters."""
    rounds: int = 0
    blocks_sent: list[int] = field(default_factory=list)   # per processor
    blocks_recv: list[int] = field(default_factory=list)
    reductions: list[int] = field(default_factory=list)    # ⊕ applications


def simulate_alltoall(
    inputs: Sequence[Sequence[np.ndarray]],
    schedule: str = "halving",
) -> tuple[list[list[np.ndarray]], CommStats]:
    """All-to-all via reduce-scatter with ⊕ = concatenation.

    ``inputs[r][i]`` is the block rank r wants delivered to rank i.  A
    "block" is a list of (source_rank, payload) pairs and ⊕ concatenates
    lists; at the end, processor r's W is the list of p payloads
    addressed to it.  Blocks may have any shape per (src, dst) pair,
    empty included, so this is also the alltoallv oracle.  ceil(log2 p)
    rounds; blocks hop through intermediate ranks (reported in stats).
    """
    p = len(inputs)
    stats = CommStats(blocks_sent=[0] * p, blocks_recv=[0] * p,
                      reductions=[0] * p)
    # R_r[i]: list of (src, payload) destined for rank (r + i) mod p.
    R = [[[(r, np.array(inputs[r][(r + i) % p], copy=True))]
          for i in range(p)] for r in range(p)]
    for pl in reduce_scatter_plan(p, schedule):
        stats.rounds += 1
        s = pl.skip
        mailbox = {}
        for r in range(p):
            payload = [R[r][i] for i in range(pl.lo, pl.hi)]
            mailbox[(r + s) % p] = payload
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
    sized, possibly empty) payload src sends to dst.  The rounds are
    :func:`simulate_alltoall`'s; this asserts their count."""
    p = len(inputs)
    out, stats = simulate_alltoall(inputs, schedule=schedule)
    assert stats.rounds == len(get_skips(p, schedule)), \
        (stats.rounds, p, schedule)
    return out, stats


def ref_alltoall(inputs) -> list[list[np.ndarray]]:
    """Host ground truth for alltoall(v): a transpose of the per-pair
    payload matrix — ``out[r][j] = inputs[j][r]``."""
    p = len(inputs)
    return [[np.array(inputs[j][r], copy=True) for j in range(p)]
            for r in range(p)]
