"""Analytic cost models: the paper's α-β-γ model and a torus refinement.

Ported from ``repro/core/cost_model.py``, pure Python (the reference
module imports no JAX itself, but importing it runs ``repro/core``'s
package init, which does).  The tests hold both copies equal for the
five schedules and p <= 64.

Corollary 1 (uniform blocks, m elements total, p processors):
    T_rs(m, p) = α·ceil(log2 p) + β·(p-1)/p·m + γ·(p-1)/p·m
    T_ar(m, p) = 2α·ceil(log2 p) + 2β·(p-1)/p·m + γ·(p-1)/p·m

Corollary 3 (irregular blocks): T <= ceil(log2 p) · (α + β·m + γ·m).
:func:`nonuniform_round_widths` gives the exact per-round rows that
bound maximizes over: the widths of the non-uniform plan's row tables
(``plan.BlockLayout.window_rows``), and so the rows ``comm.bytes``
counts per round and rank.

Torus refinement: a shift by s on a p-ring with wraparound traverses
``min(s, p-s)`` links, so with ``torus=True`` a round's β term is
charged once per hop.  The paper's model charges β once per element.
:meth:`CommModel.tpu_v5e` carries the reference's TPU constants, which
are not this port's device; the model's constants are the caller's.
"""
from __future__ import annotations

from dataclasses import dataclass

from .schedule import (RoundPlan, allgather_plan, alltoall_moves, ceil_log2,
                       reduce_scatter_plan)


@dataclass(frozen=True)
class CommModel:
    """Homogeneous, linear-affine transmission cost model (paper §2.1).

    alpha: per-round latency [s]
    beta:  per-element transmission time [s/elem]  (elem = one vector elem)
    gamma: per-element reduction time [s/elem]
    elem_bytes: bytes of one UNCOMPRESSED vector element (what beta was
        calibrated against); lets the wire-format scaling below convert a
        compressed bytes-per-element figure back into a beta multiplier.
    """
    alpha: float
    beta: float
    gamma: float
    elem_bytes: float = 4.0

    @staticmethod
    def tpu_v5e(elem_bytes: int = 2) -> "CommModel":
        """v5e-flavored constants: ~1us collective-permute launch latency,
        ~50 GB/s/link ICI, VPU reduce >> link bw so gamma ~ HBM-bound add
        (2 reads + 1 write per elem @ 819 GB/s)."""
        return CommModel(alpha=1e-6,
                         beta=elem_bytes / 50e9,
                         gamma=3 * elem_bytes / 819e9,
                         elem_bytes=elem_bytes)


def wire_bytes_per_elem(elem_bytes: float, wire_dtype: str | None = None,
                        wire_group: int = 512) -> float:
    """Bytes on the wire per payload element under a wire format.

    ``int8`` sends one code byte per element plus one f32 scale per
    ``wire_group`` elements (the packed [codes | scale bytes] buffer of
    kernels.quantize) — ``1 + 4/group`` bytes/elem vs ``elem_bytes``
    uncompressed, i.e. a ~3.9x β-term reduction from f32 at the default
    group of 512."""
    if wire_dtype is None:
        return float(elem_bytes)
    if wire_dtype == "int8":
        return 1.0 + 4.0 / wire_group
    raise ValueError(f"unknown wire_dtype {wire_dtype!r}")


def _wire_scale(model: CommModel, wire_dtype: str | None,
                wire_group: int) -> float:
    """β multiplier for a wire format (1.0 when uncompressed)."""
    if wire_dtype is None:
        return 1.0
    return (wire_bytes_per_elem(model.elem_bytes, wire_dtype, wire_group)
            / model.elem_bytes)


def _round_cost(plans: tuple[RoundPlan, ...], block_elems: float,
                model: CommModel, p: int, *, torus: bool,
                reduce_on_recv: bool, wire_scale: float = 1.0) -> float:
    t = 0.0
    for pl in plans:
        m_k = pl.nblocks * block_elems
        hops = min(pl.skip, p - pl.skip) if torus else 1
        t += model.alpha + model.beta * wire_scale * hops * m_k
        if reduce_on_recv:
            t += model.gamma * m_k
    return t


def t_reduce_scatter(m: float, p: int, model: CommModel,
                     schedule: str = "halving", *, torus: bool = False,
                     wire_dtype: str | None = None,
                     wire_group: int = 512) -> float:
    """Predicted time of Algorithm 1 on m total elements (uniform blocks).
    ``wire_dtype="int8"`` scales the β term to the compressed payload
    (codes + scales bytes); α (round count) and γ (every element is still
    reduced) are unchanged."""
    if p == 1:
        return 0.0
    plans = reduce_scatter_plan(p, schedule)
    return _round_cost(plans, m / p, model, p, torus=torus,
                       reduce_on_recv=True,
                       wire_scale=_wire_scale(model, wire_dtype, wire_group))


def t_allgather(m: float, p: int, model: CommModel,
                schedule: str = "halving", *, torus: bool = False,
                wire_dtype: str | None = None,
                wire_group: int = 512) -> float:
    """Predicted circulant allgather time for an ``m``-element result at
    ``p`` ranks (transport only — no gamma term; Corollary 1 dual of the
    reduce-scatter)."""
    if p == 1:
        return 0.0
    plans = allgather_plan(p, schedule)
    return _round_cost(plans, m / p, model, p, torus=torus,
                       reduce_on_recv=False,
                       wire_scale=_wire_scale(model, wire_dtype, wire_group))


def t_allreduce(m: float, p: int, model: CommModel,
                schedule: str = "halving", *, torus: bool = False,
                wire_dtype: str | None = None,
                wire_group: int = 512) -> float:
    """Algorithm 2 = Algorithm 1 + reversed allgather (Theorem 2)."""
    return (t_reduce_scatter(m, p, model, schedule, torus=torus,
                             wire_dtype=wire_dtype, wire_group=wire_group)
            + t_allgather(m, p, model, schedule, torus=torus,
                          wire_dtype=wire_dtype, wire_group=wire_group))


def t_bucketed_allreduce(m: float, p: int, model: CommModel,
                         nbuckets: int, schedule: str = "halving", *,
                         torus: bool = False, wire_dtype: str | None = None,
                         wire_group: int = 512,
                         overlap: float = 1.0) -> float:
    """Predicted time of the bucketed, software-pipelined allreduce.

    The serial (single-bucket) lower bound is Corollary 1's
    ``α·2⌈log₂p⌉ + β·2(p-1)/p·m + γ·(p-1)/p·m``.  Splitting into B
    buckets pays the round latency B times (every bucket runs its own
    2⌈log₂p⌉ ppermutes), moves the same total β bytes, and lets each
    bucket's fold (γ) work hide under a neighboring bucket's ppermute —
    except the last bucket's, which has nothing left to hide behind.
    ``overlap`` in [0, 1] scales how much of the hideable fold actually
    overlaps (1 = perfect latency-hiding scheduler, 0 = fully serial,
    which recovers ``t_allreduce`` at any B up to the extra α rounds).

    ``t_bucketed_allreduce(m, p, model, 1)`` == ``t_allreduce(m, p,
    model)`` exactly; the α-vs-γ trade is minimized at
    :func:`optimal_bucket_count`.
    """
    if nbuckets < 1:
        raise ValueError(f"nbuckets must be >= 1, got {nbuckets}")
    if not 0.0 <= overlap <= 1.0:
        raise ValueError(f"overlap must be in [0, 1], got {overlap}")
    if p == 1:
        return 0.0
    comm = CommModel(alpha=model.alpha, beta=model.beta, gamma=0.0,
                     elem_bytes=model.elem_bytes)
    t_comm = nbuckets * t_allreduce(m / nbuckets, p, comm, schedule,
                                    torus=torus, wire_dtype=wire_dtype,
                                    wire_group=wire_group)
    t_fold = (t_reduce_scatter(m, p, model, schedule, torus=torus,
                               wire_dtype=wire_dtype, wire_group=wire_group)
              - t_reduce_scatter(m, p, comm, schedule, torus=torus,
                                 wire_dtype=wire_dtype,
                                 wire_group=wire_group))
    hidden = overlap * t_fold * (nbuckets - 1) / nbuckets
    return t_comm + t_fold - hidden


def optimal_bucket_count(m: float, p: int, model: CommModel,
                         schedule: str = "halving") -> int:
    """Bucket count minimizing :func:`t_bucketed_allreduce` at full
    overlap: balancing the extra round latency ``B·rounds·α`` against
    the unhidden fold tail ``γ·(p-1)/p·m / B`` gives
    ``B* = sqrt(γ·(p-1)/p·m / (rounds·α))`` (rounded, clamped to >= 1).
    """
    if p == 1:
        return 1
    rounds = (len(reduce_scatter_plan(p, schedule))
              + len(allgather_plan(p, schedule)))
    fold = model.gamma * (p - 1) / p * m
    if fold <= 0 or model.alpha <= 0:
        return 1
    return max(1, round((fold / (rounds * model.alpha)) ** 0.5))


def t_corollary1(m: float, p: int, model: CommModel) -> float:
    """Closed form of Corollary 1 — must equal t_reduce_scatter(halving)."""
    if p == 1:
        return 0.0
    return (model.alpha * ceil_log2(p)
            + (model.beta + model.gamma) * (p - 1) / p * m)


def t_corollary3_bound(m: float, p: int, model: CommModel) -> float:
    """Upper bound for arbitrary block-size partitions (Corollary 3)."""
    if p == 1:
        return 0.0
    return ceil_log2(p) * (model.alpha + (model.beta + model.gamma) * m)


def nonuniform_round_widths(counts, schedule: str = "halving",
                            group: int | None = None, *,
                            phase: str = "rs") -> tuple[int, ...]:
    """Per-round wire widths (rows) of the non-uniform RS/AG: the worst
    windowed count sum over ranks — the exact per-round quantity
    Corollary 3's bound maximizes over, and the analytic width the plan
    layer's row tables must match (checked by ``repro.analysis``'s plan
    verifier, so a table-construction bug cannot silently widen or
    narrow the wire)."""
    p = len(counts)
    plans = (reduce_scatter_plan(p, schedule, group) if phase == "rs"
             else allgather_plan(p, schedule, group))
    widths = []
    for pl in plans:
        window = (range(pl.lo, pl.hi) if phase == "rs"
                  else range(0, pl.nblocks))
        w = max(sum(counts[(r + i) % p] for i in window) for r in range(p))
        widths.append(max(w, 1))
    return tuple(widths)


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


def t_alltoall(m: float, p: int, model: CommModel,
               schedule: str = "halving", *, torus: bool = False) -> float:
    """Predicted time of alltoall-by-concatenation on m total elements
    per rank (uniform p blocks of m/p).  β is charged for the FULL
    hop-through-intermediate-ranks volume (every entry in a round's
    window retransmits); no γ — concatenation does no arithmetic."""
    if p == 1:
        return 0.0
    t = 0.0
    for (skip, moved) in alltoall_moves(p, schedule):
        hops = min(skip, p - skip) if torus else 1
        t += model.alpha + model.beta * hops * len(moved) * (m / p)
    return t


def alltoallv_round_widths(counts, schedule: str = "halving",
                           group: int | None = None) -> tuple[int, ...]:
    """Per-round wire widths (rows) of the ragged alltoallv: the worst
    windowed count sum over ranks — the analytic bound the plan's
    ``A2APlan.round_widths`` must equal (asserted by the CI ``a2a``
    gate), and the β quantity of the Corollary 3 style per-round cost."""
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


def t_alltoallv(counts, model: CommModel, schedule: str = "halving", *,
                elems_per_row: float = 1.0, torus: bool = False) -> float:
    """Predicted alltoallv time for a per-pair ``counts`` row matrix.
    Every round ships one fixed-width wire buffer (SPMD static shapes),
    so β is charged for the worst windowed count sum per round."""
    p = len(counts)
    if p == 1:
        return 0.0
    t = 0.0
    moves = alltoall_moves(p, schedule)
    for (skip, _), w in zip(moves, alltoallv_round_widths(counts, schedule)):
        hops = min(skip, p - skip) if torus else 1
        t += model.alpha + model.beta * hops * w * elems_per_row
    return t


def t_ring_reduce_scatter(m: float, p: int, model: CommModel) -> float:
    """Classic p-1-round ring algorithm [Patarasuk-Yuan]: volume optimal,
    latency linear.  One block of m/p per round, 1 hop."""
    if p == 1:
        return 0.0
    return (p - 1) * (model.alpha + (model.beta + model.gamma) * m / p)


def t_ring_allreduce(m: float, p: int, model: CommModel) -> float:
    """Classic bandwidth-optimal ring allreduce baseline: 2(p-1) rounds
    of m/p-sized messages (latency term 2(p-1)·alpha vs the circulant
    2⌈log2 p⌉·alpha)."""
    if p == 1:
        return 0.0
    return (t_ring_reduce_scatter(m, p, model)
            + (p - 1) * (model.alpha + model.beta * m / p))


def t_bcast_reduce_allreduce(m: float, p: int, model: CommModel) -> float:
    """Naive binomial-tree reduce + broadcast (the detour the paper warns
    against): 2·ceil(log2 p) rounds but FULL vector each round."""
    if p == 1:
        return 0.0
    return 2 * ceil_log2(p) * (model.alpha + model.beta * m) \
        + ceil_log2(p) * model.gamma * m


def crossover_m(p: int, model: CommModel, lo: float = 1.0,
                hi: float = 1e12) -> float:
    """Smallest m where ring allreduce beats circulant allreduce on the
    TORUS model (hop-amplified).  Bisection; returns hi if never."""
    if t_allreduce(hi, p, model, torus=True) <= t_ring_allreduce(hi, p, model):
        return hi
    for _ in range(200):
        mid = (lo + hi) / 2
        if t_allreduce(mid, p, model, torus=True) > t_ring_allreduce(mid, p, model):
            hi = mid
        else:
            lo = mid
    return hi
