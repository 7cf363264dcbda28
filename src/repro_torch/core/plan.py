"""``plan()`` — compile a :class:`CollectiveSpec` into an executable plan.

The execute half of the plan/execute API, ported from
``repro/core/plan.py``.  A :class:`CollectivePlan` holds what Algorithm 1
and 2 precompute before any data moves — the resolved skip sequence,
per-round :class:`RoundPlan`s for both phases and the per-round send/recv
block index tables — resolved once per ``(spec, p)`` and memoized.

Execution takes a communicator (``repro_torch.comm``) and a list of
per-rank tensors, one per rank the communicator holds in this process::

    pl = plan(CollectiveSpec(schedule="halving"), p=comm.p)
    shards = pl.reduce_scatter(xs, comm)     # one comm.shift per round

Every phase runs the reference's round protocol: ``rs_begin`` /
``ag_begin`` open a :class:`RoundState`; ``start_round`` issues exactly
one exchange for all local ranks; ``finish_round`` is exchange-free (the
local fold and the next send's layout: the seam the fused kernel fills);
``rs_end`` / ``ag_end`` extract the result.  On a ``LocalComm`` the ``p``
virtual ranks therefore step in lockstep: every rank starts, one
exchange, every rank finishes.

Backends: ``eager`` (plain torch ops) and ``fused`` (the CUDA
``fused_round`` kernel on a card, its plain version on the CPU), and on
the int8 wire (``wire_dtype="int8"``) ``eager+int8`` (the plain
quantizer and compressed round) and ``fused+int8`` (the ``quantize`` and
``fused_round_dq`` kernels on a card).  With ``use_fused_kernel=None``
the backend is chosen per call from the payload's device
(``resolve_fused``).  ``broadcast`` is the allgather phase run
standalone (:meth:`CollectivePlan.broadcast`); the baselines ``ring``,
``recursive_halving`` and ``xla`` run one-shot only, by the functions of
this module's Baselines section, which ``core/collectives.py`` exports
(their folds are plain ``reduce_fn``, as in the reference: no kernel).  ``BACKENDS`` lists which collectives each
backend implements.

The uniform circulant reduce-scatter takes per-round ``compress=`` /
``decompress=`` hooks (``kernels.ops.make_compressors``): the payload a
round sends is ``compress(send)``, a dict of tensors, each of which is
one counted exchange (the reference's pytree ``ppermute`` is one
collective-permute per leaf), and the fold takes ``decompress`` of what
arrived.  ``reduce_scatter_pipelined`` / ``allgather_pipelined`` run
many payloads of one plan with their rounds interleaved: payload b's
round-k exchange is posted before payload b-1's round-k fold
(``comm.post``), with ``len(payloads) * rounds`` exchanges, each payload
bitwise its one-shot result.

A flat per-rank ``counts`` spec (Corollary 3, ``MPI_Reduce_scatter``)
compiles a :class:`BlockLayout` and per-round absolute-row tables and
runs on the ``nonuniform`` backend: each round gathers a rank's rows into
one fixed-width wire, one ``comm.shift``, and ⊕-folds the received rows
in place.  It runs one-shot only (no round protocol) and no kernel, as
in the reference, whose fused kernel assumes equal blocks.

:meth:`CollectivePlan.alltoall` is the alltoall by concatenation (paper
§4, Algorithm 1 with ⊕ = concatenation) on the ``eager`` and ``fused``
backends (the fused one stacks each slot into one buffer and lays the
final slot into source order with the ``permute_rows`` kernel), and the
ragged alltoallv over a p×p ``counts`` matrix (``alltoallv`` backend,
row tables compiled into an :class:`A2APlan`).  Every round is one
``comm.shift`` either way.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..kernels import (fused_round, fused_round_dq, permute_rows,
                       quantize_rows, resolve_fused)
from ..kernels import ref as _kref
from ..kernels.quantize import MAX_GROUP, pack_wire, pad2d, unpack_wire
from .cost_model import alltoallv_round_widths
from .schedule import (RoundPlan, allgather_plan, alltoall_moves,
                       reduce_scatter_plan)
from .spec import CollectiveSpec, as_spec

ReduceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REDUCERS: dict[str, ReduceFn] = {
    "add": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
}

#: ops the fused backend supports.
NAMED_OPS = tuple(_REDUCERS)


def resolve_op(op) -> ReduceFn:
    """Named-or-callable ⊕ resolution."""
    if callable(op):
        return op
    try:
        return _REDUCERS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}") from None


# ---------------------------------------------------------------------------
# Block layout — uniform blocks and the non-uniform row tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockLayout:
    """Per-rank block row counts along the leading axis.

    The one place block geometry is derived from: the uniform blocks
    (:meth:`uniform`, :meth:`as_blocks`) and the non-uniform row tables
    of Corollary 3 (:meth:`window_rows`) both consume a layout.
    """

    counts: tuple[int, ...]

    @classmethod
    def uniform(cls, p: int, n: int) -> "BlockLayout":
        """Equal blocks of ``ceil(n/p)`` rows (zero-pad to fit)."""
        if p < 1:
            raise ValueError(f"p must be >= 1, got {p}")
        b = -(-n // p) if n else 0
        return cls(counts=(b,) * p)

    @property
    def p(self) -> int:
        return len(self.counts)

    @property
    def total(self) -> int:
        return sum(self.counts)

    @property
    def bmax(self) -> int:
        return max(self.counts)

    @property
    def offsets(self) -> tuple[int, ...]:
        """Row offset of each block (plus the total as a sentinel)."""
        off, acc = [], 0
        for c in self.counts:
            off.append(acc)
            acc += c
        off.append(acc)
        return tuple(off)

    @property
    def is_uniform(self) -> bool:
        return len(set(self.counts)) <= 1

    def as_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """Reshape the leading axis into (p, bmax, *rest) — uniform only."""
        if not self.is_uniform:
            raise ValueError(
                f"non-uniform layout {self.counts} cannot reshape to "
                f"equal blocks; use the row tables")
        n, p = x.shape[0], self.p
        if n != self.total:
            raise ValueError(
                f"leading dim {n} not divisible by axis size {p}; pad first")
        return x.reshape(p, self.bmax, *x.shape[1:])

    def window_rows(self, window: Sequence[int]) -> np.ndarray:
        """Per-rank row index table for a rotated block window.

        Row ``r`` lists, in block order, the absolute row indices of
        blocks ``(r + i) mod p`` for ``i`` in ``window``, padded with the
        sentinel ``total`` (a dummy row) to the worst-case window width
        (at least 1) — the quantity Corollary 3's round bound maximizes
        over, and ``cost_model.nonuniform_round_widths``'s.
        """
        p, off, total = self.p, self.offsets, self.total
        widths = [sum(self.counts[(r + i) % p] for i in window)
                  for r in range(p)]
        W = max(widths) if widths else 0
        tab = np.full((p, max(W, 1)), total, dtype=np.int32)
        for r in range(p):
            j = 0
            for i in window:
                c = (r + i) % p
                tab[r, j:j + self.counts[c]] = np.arange(
                    off[c], off[c] + self.counts[c], dtype=np.int32)
                j += self.counts[c]
        return tab


# ---------------------------------------------------------------------------
# Alltoall(v) geometry — per-pair counts compiled to row tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class A2APlan:
    """Geometry of a ragged alltoallv (per-pair ``counts``), as the
    reference's ``repro.core.plan.A2APlan``.

    The per-rank buffer holds the FULL absolute (src, dst) pair layout
    (``total`` rows + one sentinel row); each rank only ever populates the
    rows of entries it currently holds.  ``round_tables[k]`` is the
    ``(p, W_k)`` absolute-row table of round k: row r lists the buffer
    rows rank r gathers into the wire (its entries hopping this round, in
    ``alltoall_moves`` order), sentinel-padded to the worst windowed count
    sum ``W_k`` over ranks (one wire shape for every rank).  Sender and
    receiver store every entry at the same absolute rows, so the receive
    table of rank r is row ``(r - skip) mod p`` of the SAME table.
    """

    counts: tuple[tuple[int, ...], ...]   # [src][dst] rows
    pair_offsets: np.ndarray              # (p, p) absolute row of each pair
    total: int                            # sum of all counts
    send_total: tuple[int, ...]           # per-src row sum
    recv_total: tuple[int, ...]           # per-dst row sum
    in_height: int                        # static input rows: max send_total
    out_height: int                       # static output rows: max recv_total
    seed_src: np.ndarray                  # (p, in_height) input rows gathered
    seed_dst: np.ndarray                  # (p, in_height) buffer rows written
    round_tables: tuple[np.ndarray, ...]  # (p, W_k) wire gather/scatter rows
    out_rows: np.ndarray                  # (p, out_height) output gather rows

    @property
    def round_widths(self) -> tuple[int, ...]:
        """Per-round wire width (rows) — the worst windowed count sum."""
        return tuple(t.shape[1] for t in self.round_tables)


def _build_a2a(counts: tuple[tuple[int, ...], ...], p: int,
               schedule: str, group: int | None) -> A2APlan:
    moves = alltoall_moves(p, schedule, group)
    offs = np.zeros((p, p), np.int64)
    acc = 0
    for s in range(p):
        for dcol in range(p):
            offs[s, dcol] = acc
            acc += counts[s][dcol]
    total = acc
    send_total = tuple(sum(row) for row in counts)
    recv_total = tuple(sum(counts[s][dcol] for s in range(p))
                       for dcol in range(p))
    in_h = max(max(send_total), 1)
    out_h = max(max(recv_total), 1)

    # Seed: rank r's input rows (dst-ordered, rows [0, send_total[r]))
    # scatter into the absolute pair layout; sentinel-padded.
    seed_src = np.full((p, in_h), in_h, dtype=np.int32)   # input sentinel
    seed_dst = np.full((p, in_h), total, dtype=np.int32)  # buffer sentinel
    for r in range(p):
        j = 0
        for dcol in range(p):
            c = counts[r][dcol]
            seed_src[r, j:j + c] = np.arange(j, j + c, dtype=np.int32)
            seed_dst[r, j:j + c] = np.arange(
                offs[r, dcol], offs[r, dcol] + c, dtype=np.int32)
            j += c

    # Table widths come from the cost model's formula (one implementation
    # of the worst windowed count sum); the fill below would overrun a
    # too-small width, so the two are checked against each other.
    widths = alltoallv_round_widths(counts, schedule, group)
    tables = []
    for (_, moved), W in zip(moves, widths):
        tab = np.full((p, W), total, dtype=np.int32)
        for r in range(p):
            j = 0
            for d, m in moved:
                src = (r - m) % p
                dst = (src + d) % p
                c = counts[src][dst]
                tab[r, j:j + c] = np.arange(
                    offs[src, dst], offs[src, dst] + c, dtype=np.int32)
                j += c
            assert j <= W, (j, W)
        tables.append(tab)

    out_rows = np.full((p, out_h), total, dtype=np.int32)
    for r in range(p):
        j = 0
        for src in range(p):
            c = counts[src][r]
            out_rows[r, j:j + c] = np.arange(
                offs[src, r], offs[src, r] + c, dtype=np.int32)
            j += c
    return A2APlan(counts=counts, pair_offsets=offs, total=total,
                   send_total=send_total, recv_total=recv_total,
                   in_height=in_h, out_height=out_h,
                   seed_src=seed_src, seed_dst=seed_dst,
                   round_tables=tuple(tables), out_rows=out_rows)


# ---------------------------------------------------------------------------
# Round protocol state
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class RoundState:
    """State of one phase of a collective, across the local ranks.

    plan / comm: what runs it; phase: ``"rs"`` or ``"ag"``; backend: the
    resolved ops (``eager``/``fused``, ``eager+int8``/``fused+int8``);
    nrounds: rounds of the phase (0 for p == 1); k: rounds finished;
    started: an exchange is in flight; inflight: the started round's
    pending exchange (``wait()`` gives the received payloads, one per
    local rank); data: backend-private per-rank buffers, one dict per
    local rank; compress / decompress: the round hooks (reduce-scatter
    only).
    """

    plan: "CollectivePlan"
    comm: object
    phase: str
    backend: str
    nrounds: int
    k: int = 0
    started: bool = False
    inflight: object = None
    data: list = field(default_factory=list)
    compress: Callable | None = None
    decompress: Callable | None = None

    @property
    def done(self) -> bool:
        """True once every round is finished (``end`` may be called)."""
        return self.k >= self.nrounds

    @property
    def round(self) -> RoundPlan:
        """The :class:`RoundPlan` of the round being started/finished."""
        rounds = (self.plan.rs_rounds if self.phase == "rs"
                  else self.plan.ag_rounds)
        return rounds[self.k]


# ---------------------------------------------------------------------------
# The compiled plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class CollectivePlan:
    """Compiled, cached form of a :class:`CollectiveSpec` at p ranks.

    ``rs_send_blocks[k]`` / ``rs_recv_blocks[k]`` are the rotated block
    indices moved in reduce-scatter round k (``ag_*`` likewise for the
    reversed allgather); over all rounds the send sets partition
    ``{1, .., p-1}`` exactly (Theorem 1).  For flat ``counts``,
    ``rs_row_tables[k]`` (``ag_row_tables[k]``) is the ``(p, W_k)``
    absolute-row gather/scatter table realizing those block sets at row
    granularity.  ``backend`` is ``"eager"``, ``"fused"``,
    ``"eager+int8"``, ``"fused+int8"``, ``"nonuniform"`` (flat
    ``counts``), ``"alltoallv"`` (a p×p ``counts`` spec; ``a2a`` holds
    its row tables), ``"auto"`` (resolved from each payload's device),
    ``"broadcast"``, or a baseline kind (``"ring"``,
    ``"recursive_halving"``, ``"xla"``: no rounds are planned).
    """

    spec: CollectiveSpec
    p: int
    backend: str
    skips: tuple[int, ...]
    rs_rounds: tuple[RoundPlan, ...]
    ag_rounds: tuple[RoundPlan, ...]
    rs_send_blocks: tuple[tuple[int, ...], ...]
    rs_recv_blocks: tuple[tuple[int, ...], ...]
    ag_send_blocks: tuple[tuple[int, ...], ...]
    ag_recv_blocks: tuple[tuple[int, ...], ...]
    layout: BlockLayout | None = None     # non-None iff flat spec.counts
    rs_row_tables: tuple[np.ndarray, ...] | None = None
    ag_row_tables: tuple[np.ndarray, ...] | None = None
    a2a: A2APlan | None = None            # non-None iff matrix spec.counts
    #: device copies of the row tables' rows (``_rows``), filled on use.
    rows_cache: dict = field(default_factory=dict, repr=False)

    def backend_for(self, device: torch.device | str | None) -> str:
        """The backend that runs a payload on ``device``."""
        if self.backend != "auto":
            return self.backend
        return _resolve_backend(self.spec, device)

    # -- one-shot execution -------------------------------------------------

    def reduce_scatter(self, xs: Sequence[torch.Tensor], comm, *,
                       compress=None, decompress=None
                       ) -> list[torch.Tensor]:
        """Paper Algorithm 1: each rank's ``(n, *rest)`` input (n divisible
        by p) to its reduced ``(n/p, *rest)`` block; one exchange per
        round (per tensor of a ``compress``-ed payload).  With flat
        ``counts``: ``(sum(counts), *rest)`` to ``(max(counts), *rest)``,
        rank r's block in rows ``[0, counts[r])`` and zeros above."""
        self._check_hooks(compress, decompress)
        self._check_not_a2a("reduce_scatter")
        if self.backend in _BASELINE_RS:
            self._check_world(xs, comm)
            return _BASELINE_RS[self.backend](xs, comm, op=self.spec.op)
        if self.backend == "nonuniform":
            self._check_world(xs, comm)
            return list(xs) if self.p == 1 else _rs_nonuniform(self, xs, comm)
        st = self.rs_begin(xs, comm, compress=compress,
                           decompress=decompress)
        while not st.done:
            self.finish_round(self.start_round(st))
        return self.rs_end(st)

    def allgather(self, xs: Sequence[torch.Tensor], comm
                  ) -> list[torch.Tensor]:
        """Algorithm 2's second phase standalone: each rank's block
        ``(blk, *rest)`` to ``(p*blk, *rest)`` in rank order.  With flat
        ``counts``: ``(max(counts), *rest)`` to ``(sum(counts), *rest)``,
        replicated bitwise."""
        self._check_not_a2a("allgather")
        if self.backend in _BASELINE_AG:
            self._check_world(xs, comm)
            return _BASELINE_AG[self.backend](xs, comm, op=self.spec.op)
        if self.backend == "nonuniform":
            self._check_world(xs, comm)
            return list(xs) if self.p == 1 else _ag_nonuniform(self, xs, comm)
        st = self.ag_begin(xs, comm)
        while not st.done:
            self.finish_round(self.start_round(st))
        return self.ag_end(st)

    def allreduce(self, xs: Sequence[torch.Tensor], comm, *,
                  compress=None, decompress=None) -> list[torch.Tensor]:
        """Paper Algorithm 2: reduce-scatter + reversed allgather (the
        hooks compress the reduce-scatter's rounds only)."""
        if self.backend in _BASELINE_AR:
            self._check_world(xs, comm)
            return _BASELINE_AR[self.backend](xs, comm, op=self.spec.op)
        return self.allgather(self.reduce_scatter(
            xs, comm, compress=compress, decompress=decompress), comm)

    def broadcast(self, xs: Sequence[torch.Tensor], comm
                  ) -> list[torch.Tensor]:
        """Round-optimal all-broadcast (Träff, arXiv:2407.18004): every
        rank's block ``(blk, *rest)`` reaches every rank as ``(p*blk,
        *rest)``, row-block j rank j's, the same bits on every rank, in
        ``ceil(log2 p)`` rounds of one exchange each: Algorithm 2's
        allgather phase run standalone, with no reduction.  A
        ``kind="broadcast"`` spec moves payloads uncompressed (its
        ``wire_dtype`` and ``use_fused_kernel`` are refused at spec
        construction); any uniform circulant plan broadcasts too."""
        self._check_not_a2a("broadcast")
        self._check_world(xs, comm)
        backend = self.backend_for(xs[0].device)
        impl = _ASYNC_IMPLS.get((backend, "ag"))
        if impl is None:
            raise ValueError(
                f"backend {backend!r} does not implement broadcast; use "
                f"kind='broadcast' (or any uniform circulant backend)")
        if self.p == 1:
            return list(xs)
        # ag_begin refuses a plan with no reduce-scatter phase (the paired
        # protocol); broadcast has none, so it opens the state directly.
        st = RoundState(plan=self, comm=comm, phase="ag", backend=backend,
                        nrounds=len(self.ag_rounds))
        st.data = [impl.begin(self, x, r) for x, r in zip(xs, comm.ranks)]
        while not st.done:
            self.finish_round(self.start_round(st))
        return self.ag_end(st)

    def alltoall(self, xs: Sequence[torch.Tensor], comm
                 ) -> list[torch.Tensor]:
        """All-to-all by concatenation (paper §4): Algorithm 1 with ⊕ =
        concatenation, one exchange per round.

        Uniform form (``counts=None``): each rank's ``(p, blk, *rest)``,
        row j its payload for rank j, becomes the same shape with row j
        the payload FROM rank j.  Ragged form (p×p ``counts``,
        MPI_Alltoallv): rank r's ``(in_height, *rest)`` holds its payload
        rows concatenated in destination order in rows ``[0,
        send_total[r])``, and the result ``(out_height, *rest)`` the
        received rows concatenated in source order, zero past this
        rank's receive total.  Differentiable through ``comm.shift``."""
        if self.spec.wired:
            raise NotImplementedError(
                "alltoall does not support wire_dtype (blocks hop through "
                "intermediate ranks; requantizing per hop would compound "
                "the error)")
        if self.layout is not None:
            raise NotImplementedError(
                "alltoall does not support flat (Corollary 3) counts; "
                "pass a p×p per-pair counts matrix for alltoallv")
        self._check_world(xs, comm)
        impl = _A2A_IMPLS.get(self.backend_for(xs[0].device))
        if impl is None:
            raise ValueError(
                f"backend {self.backend!r} does not implement alltoall; "
                f"have {sorted(_A2A_IMPLS)}")
        if self.p == 1:
            return list(xs)
        return impl(self, xs, comm)

    def _check_not_a2a(self, fn: str) -> None:
        if self.a2a is not None:
            raise ValueError(
                f"a p×p per-pair counts matrix is alltoall(v)-only; "
                f"{fn} takes flat per-rank counts (Corollary 3)")

    def _check_hooks(self, compress, decompress) -> None:
        if compress is None and decompress is None:
            return
        if self.spec.wired:
            raise ValueError(
                "wire_dtype and compress/decompress hooks are mutually "
                "exclusive")
        if self.layout is not None:
            raise ValueError(
                "compress/decompress hooks do not support non-uniform "
                "counts")
        if self.spec.kind != "circulant":
            raise ValueError(
                f"compress/decompress hooks need kind='circulant' "
                f"(per-round payloads), got {self.spec.kind!r}")

    def _check_world(self, xs, comm) -> None:
        if comm.p != self.p:
            raise ValueError(
                f"plan compiled for p={self.p}, communicator has {comm.p}")
        if len(xs) != len(comm.ranks):
            raise ValueError(
                f"{len(comm.ranks)} local rank(s), got {len(xs)} payloads")

    # -- multi-call round protocol ------------------------------------------

    def rs_begin(self, xs: Sequence[torch.Tensor], comm, *, compress=None,
                 decompress=None) -> RoundState:
        """Open a reduce-scatter over the local ranks' ``xs``: rotate each
        into block coordinates and lay out round 0's send payload, without
        any exchange.  Uniform circulant backends only: baselines,
        non-uniform counts and alltoallv have no round seam and raise."""
        self._check_hooks(compress, decompress)
        st = self._begin(xs, comm, "rs")
        st.compress, st.decompress = compress, decompress
        return st

    def ag_begin(self, xs: Sequence[torch.Tensor], comm) -> RoundState:
        """Open an allgather of the local ranks' blocks ``xs``."""
        return self._begin(xs, comm, "ag")

    def _begin(self, xs, comm, phase: str) -> RoundState:
        self._check_not_a2a(f"{phase}_begin")
        self._check_world(xs, comm)
        _check_wire_payload(self, xs[0])
        backend = self.backend_for(xs[0].device)
        if (backend, "rs") not in _ASYNC_IMPLS:  # the paired protocol
            supported = sorted({b for (b, ph) in _ASYNC_IMPLS if ph == "rs"})
            raise NotImplementedError(
                f"backend {backend!r} has no multi-call round protocol "
                f"({phase}_begin); async-capable backends: {supported}")
        nrounds = len(self.rs_rounds if phase == "rs" else self.ag_rounds)
        st = RoundState(plan=self, comm=comm, phase=phase, backend=backend,
                        nrounds=nrounds)
        if self.p == 1:
            st.data = [{"identity": x} for x in xs]
            return st
        ops = _ASYNC_IMPLS[(backend, phase)]
        st.data = [ops.begin(self, x, r) for x, r in zip(xs, comm.ranks)]
        return st

    def start_round(self, st: RoundState) -> RoundState:
        """Post round ``st.k``'s single exchange: every local rank's send
        payload goes ``+skip`` (reduce-scatter) or ``-skip`` (allgather)
        in one ``comm.post`` (one per tensor of a ``compress``-ed
        payload).  Mutates and returns ``st``."""
        self._check_state(st)
        if st.done:
            raise ValueError(
                f"{st.phase} phase complete: all {st.nrounds} rounds "
                f"finished (call {st.phase}_end)")
        if st.started:
            raise ValueError(
                f"round {st.k} already started; call finish_round() first")
        ops = _ASYNC_IMPLS[(st.backend, st.phase)]
        rnd = st.round
        payloads = [ops.payload(self, d, rnd) for d in st.data]
        if st.compress is not None:
            payloads = [st.compress(x) for x in payloads]
        step = rnd.skip if st.phase == "rs" else -rnd.skip
        st.inflight = _post(st.comm, payloads, step)
        st.started = True
        return st

    def finish_round(self, st: RoundState) -> RoundState:
        """Complete round ``st.k``'s exchange, fold the received payloads
        and lay out the next round's send buffers (no exchange; the fused
        backend does both in one kernel launch per rank).  Mutates and
        returns ``st``."""
        self._check_state(st)
        if not st.started:
            raise ValueError(
                f"round {st.k} has no exchange in flight; call "
                f"start_round() first")
        ops = _ASYNC_IMPLS[(st.backend, st.phase)]
        received = st.inflight.wait()
        if st.decompress is not None:
            received = [st.decompress(t) for t in received]
        for d, t in zip(st.data, received):
            ops.finish(self, d, t, st)
        st.inflight = None
        st.started = False
        st.k += 1
        return st

    def rs_end(self, st: RoundState) -> list[torch.Tensor]:
        """Each local rank's reduced block, once every round is done."""
        return self._phase_end(st, "rs")

    def ag_end(self, st: RoundState) -> list[torch.Tensor]:
        """Each local rank's gathered, rank-ordered buffer."""
        return self._phase_end(st, "ag")

    def _phase_end(self, st: RoundState, phase: str) -> list[torch.Tensor]:
        self._check_state(st)
        if st.phase != phase:
            raise ValueError(
                f"state is mid-{st.phase}, not {phase} (use {st.phase}_end)")
        if st.started or not st.done:
            raise ValueError(
                f"{phase}_end with {st.nrounds - st.k} round(s) unfinished "
                f"(started={st.started})")
        if self.p == 1:
            return [d["identity"] for d in st.data]
        ops = _ASYNC_IMPLS[(st.backend, phase)]
        return [ops.end(self, d) for d in st.data]

    def _check_state(self, st: RoundState) -> None:
        if st.plan is not self:
            raise ValueError("RoundState belongs to a different plan")

    # -- software-pipelined execution ---------------------------------------

    def reduce_scatter_pipelined(self, xss, comm, *, compress=None,
                                 decompress=None) -> list[list]:
        """Reduce-scatter many independent payloads (``xss``: an iterable
        of per-rank lists) with their rounds interleaved; returns each
        payload's per-rank results, bitwise its one-shot result.  Payload
        b's round-k exchange is posted before payload b-1's round-k fold,
        so on a ``DistComm`` each fold runs while the next payload's
        sends are in flight; exchanges are ``len(xss) * rounds``.  Each
        payload is opened as it is drawn from ``xss``, so a generator's
        inputs are released once opened."""
        sts = [self.rs_begin(xs, comm, compress=compress,
                             decompress=decompress) for xs in xss]
        return self._run_pipelined(sts, "rs")

    def allgather_pipelined(self, xss, comm) -> list[list]:
        """Allgather counterpart of :meth:`reduce_scatter_pipelined`."""
        return self._run_pipelined([self.ag_begin(xs, comm) for xs in xss],
                                   "ag")

    def _run_pipelined(self, sts: list, phase: str) -> list[list]:
        q = max((st.nrounds for st in sts), default=0)
        for _ in range(q):
            prev = None
            for st in sts:
                self.start_round(st)
                if prev is not None:
                    self.finish_round(prev)
                prev = st
            if prev is not None:
                self.finish_round(prev)
        end = self.rs_end if phase == "rs" else self.ag_end
        out = []
        for i, st in enumerate(sts):
            out.append(end(st))
            sts[i] = None  # its buffers go once its result is taken
        return out


# ---------------------------------------------------------------------------
# plan(): spec -> CollectivePlan, memoized
# ---------------------------------------------------------------------------

def _check_wire_payload(plan: CollectivePlan, x: torch.Tensor) -> None:
    """The int8 wire needs float payloads (a quantization grid); checked
    at execution because the spec is payload-agnostic."""
    if plan.spec.wired and not x.dtype.is_floating_point:
        raise ValueError(
            f"wire_dtype='int8' needs a float payload, got {x.dtype}")


#: the baseline kinds: one-shot backends (this module's Baselines).
_BASELINE_KINDS = ("ring", "recursive_halving", "xla")


def _resolve_backend(spec: CollectiveSpec, device=None) -> str:
    """Backend for ``spec`` with a payload on ``device``."""
    if spec.kind in _BASELINE_KINDS:
        return spec.kind
    if spec.kind == "broadcast":
        return "broadcast"
    if spec.counts_matrix:
        if spec.wire_dtype is not None:
            raise ValueError(
                "alltoallv (per-pair counts) does not support wire_dtype "
                "(blocks hop through intermediate ranks; requantizing per "
                "hop would compound the error)")
        if spec.use_fused_kernel is True:
            raise ValueError(
                "use_fused_kernel does not support per-pair counts (the "
                "ragged wire is table-gathered, not slot-stacked)")
        return "alltoallv"
    if spec.counts is not None:
        if spec.wire_dtype is not None:
            raise ValueError(
                "non-uniform counts and wire_dtype cannot be combined yet "
                "(quantization groups would straddle ragged blocks)")
        if spec.use_fused_kernel is True:
            raise ValueError(
                "use_fused_kernel does not support non-uniform counts "
                "(the fused round kernel assumes equal blocks)")
        if spec.op not in NAMED_OPS:
            raise ValueError(
                f"non-uniform counts need a named op {NAMED_OPS}, "
                f"got {spec.op!r}")
        return "nonuniform"
    if spec.wire_dtype is not None:
        if not isinstance(spec.op, str):
            raise ValueError(
                f"wire_dtype needs a named op ('add'/'max'/'min'), "
                f"got {spec.op!r}")
        if spec.op not in NAMED_OPS:
            raise ValueError(f"unknown reduce op {spec.op!r}")
        if not resolve_fused(spec.use_fused_kernel, device):
            return "eager+int8"
        if spec.wire_group > MAX_GROUP:
            raise ValueError(
                f"the int8 wire kernels take wire_group up to {MAX_GROUP}, "
                f"got {spec.wire_group}")
        return "fused+int8"
    if resolve_fused(spec.use_fused_kernel, device):
        if not isinstance(spec.op, str):
            if spec.use_fused_kernel:
                raise ValueError(
                    "use_fused_kernel needs a named op ('add'/'max'/'min'), "
                    f"got callable {spec.op!r}")
            return "eager"  # auto keeps callables on the eager path
        if spec.op not in NAMED_OPS:
            raise ValueError(f"unknown reduce op {spec.op!r}")
        return "fused"
    return "eager"


class _PlanCache:
    """LRU memo for compiled plans with selective invalidation (the
    elastic runtime of a later slice evicts plans of a world that no
    longer exists).  Entries are identical objects across hits."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self._data: dict = {}

    def get(self, key, build):
        try:
            val = self._data.pop(key)
            self._data[key] = val  # re-insert: LRU recency order
            return val
        except KeyError:
            val = build()
            self._data[key] = val
            while len(self._data) > self.maxsize:
                self._data.pop(next(iter(self._data)))
            return val

    def invalidate(self, p: int | None = None) -> int:
        """Evict every cached plan compiled for ``p`` ranks (``None``
        evicts all); returns the number evicted."""
        doomed = [k for k in self._data if p is None or k[1] == p]
        for k in doomed:
            del self._data[k]
        return len(doomed)


_PLAN_CACHE = _PlanCache(maxsize=4096)


def _build_plan(spec: CollectiveSpec, p: int) -> CollectivePlan:
    backend = _resolve_backend(spec)  # validates op x kernel choice
    if spec.kind in _BASELINE_KINDS:
        return CollectivePlan(
            spec=spec, p=p, backend=backend, skips=(), rs_rounds=(),
            ag_rounds=(), rs_send_blocks=(), rs_recv_blocks=(),
            ag_send_blocks=(), ag_recv_blocks=())
    if (spec.kind == "circulant" and spec.use_fused_kernel is None
            and spec.counts is None):
        backend = "auto"
    rs = reduce_scatter_plan(p, spec.schedule, spec.group)
    ag = allgather_plan(p, spec.schedule, spec.group)
    rs_send = tuple(tuple(range(pl.lo, pl.hi)) for pl in rs)
    ag_send = tuple(tuple(range(0, pl.nblocks)) for pl in ag)
    layout = rs_tables = ag_tables = a2a = None
    if spec.counts is not None:
        if len(spec.counts) != p:
            raise ValueError(
                f"counts has {len(spec.counts)} entries for axis size {p}")
        if spec.counts_matrix:
            a2a = _build_a2a(spec.counts, p, spec.schedule, spec.group)
        else:
            layout = BlockLayout(counts=spec.counts)
            rs_tables = tuple(layout.window_rows(w) for w in rs_send)
            ag_tables = tuple(layout.window_rows(w) for w in ag_send)
    return CollectivePlan(
        spec=spec, p=p, backend=backend,
        skips=tuple(pl.skip for pl in rs), rs_rounds=rs, ag_rounds=ag,
        rs_send_blocks=rs_send,
        rs_recv_blocks=tuple(tuple(range(0, pl.nblocks)) for pl in rs),
        ag_send_blocks=ag_send,
        ag_recv_blocks=tuple(tuple(range(pl.lo, pl.hi)) for pl in ag),
        layout=layout, rs_row_tables=rs_tables, ag_row_tables=ag_tables,
        a2a=a2a)


def plan(spec: CollectiveSpec | None = None, p: int | None = None,
         **kw) -> CollectivePlan:
    """Compile ``spec`` for ``p`` ranks (cached on ``(spec, p)``; a spec
    compares by value, its ``counts`` matrix included).  Bare kwargs
    build the spec in place: ``plan(p=8, schedule="power2")``."""
    spec = as_spec(spec, **kw)
    if p is None:
        raise ValueError("plan() needs p (the communicator's size)")
    return _PLAN_CACHE.get((spec, int(p)), lambda: _build_plan(spec, int(p)))


plan.invalidate = _PLAN_CACHE.invalidate


# ---------------------------------------------------------------------------
# Round ops (per rank): begin / payload / finish / end
# ---------------------------------------------------------------------------

def _rotated_blocks(plan: CollectivePlan, x: torch.Tensor, r: int
                    ) -> torch.Tensor:
    """Rotate ``x`` into block coordinates: R[i] = block of rank (r+i)."""
    blocks = BlockLayout.uniform(plan.p, x.shape[0]).as_blocks(x)
    return torch.roll(blocks, -r, dims=0)


def _next_lo(plan: CollectivePlan, st: RoundState) -> int:
    rounds = plan.rs_rounds
    return rounds[st.k + 1].lo if st.k + 1 < len(rounds) else st.round.lo


class _RsEager:
    """Algorithm 1's rounds on plain torch ops: the shrinking rotated
    buffer ``R``; round k sends ``R[lo:hi]`` and folds the received
    blocks into ``R[:nblocks]``."""

    @staticmethod
    def begin(plan, x, r):
        return {"R": _rotated_blocks(plan, x, r)}

    @staticmethod
    def payload(plan, d, rnd):
        return d["R"][rnd.lo:rnd.hi]

    @staticmethod
    def finish(plan, d, t, st):
        rnd, R = st.round, d["R"]
        nb = rnd.nblocks
        head = resolve_op(plan.spec.op)(R[:nb], t)
        d["R"] = head if nb == rnd.lo else torch.cat([head, R[nb:rnd.lo]])

    @staticmethod
    def end(plan, d):
        return d["R"][0]


class _RsFused:
    """Algorithm 1's rounds on the fused kernel.  The rotated buffer is
    viewed as 2-D ``(blocks, block_numel)``; every round is exchange →
    ``fused_round``, which emits both the shrunken live buffer and the
    next round's contiguous send payload.  Same values and exchanges as
    the eager path: only the local data movement is fused."""

    @staticmethod
    def begin(plan, x, r):
        R = _rotated_blocks(plan, x, r)
        R2 = R.reshape(plan.p, -1)
        first = plan.rs_rounds[0]
        return {"blk_shape": R.shape[1:], "live": R2[:first.lo],
                "send": R2[first.lo:first.hi]}

    @staticmethod
    def payload(plan, d, rnd):
        return d["send"]

    @staticmethod
    def finish(plan, d, t, st):
        live = d["live"]
        if t.dtype != live.dtype:
            # A decompressed payload (hooks) may be wider than the buffer:
            # promote both, as the eager path's concatenation does.
            dt = torch.promote_types(live.dtype, t.dtype)
            live, t = live.to(dt), t.to(dt)
        d["live"], d["send"] = fused_round(
            live, t, nb=st.round.nblocks, next_lo=_next_lo(plan, st),
            op=plan.spec.op)

    @staticmethod
    def end(plan, d):
        return d["live"][0].reshape(d["blk_shape"])


class _AgPlain:
    """Allgather rounds (no ⊕), eager: the growing concatenation.  Send
    payloads are buffer prefixes."""

    in_place = False

    @classmethod
    def begin(cls, plan, x, r):
        if cls.in_place:
            buf = x.new_empty((plan.p, *x.shape))
            buf[0] = x
        else:
            buf = x[None]  # (1, blk, *rest): rotated, R[i] = block of (r+i)
        return {"buf": buf, "r": r, "blk": x.shape}

    @staticmethod
    def payload(plan, d, rnd):
        return d["buf"][:rnd.nblocks]

    @classmethod
    def finish(cls, plan, d, t, st):
        rnd = st.round
        if cls.in_place:
            d["buf"][rnd.lo:rnd.hi] = t  # received blocks land at [lo, hi)
        else:
            d["buf"] = torch.cat([d["buf"], t])

    @staticmethod
    def end(plan, d):
        blk = d["blk"]
        out = torch.roll(d["buf"], d["r"], dims=0)  # out[j] = block of j
        return out.reshape(plan.p * blk[0], *blk[1:])


class _AgInPlace(_AgPlain):
    """Allgather rounds on the fused backend: one preallocated
    ``(p, blk)`` buffer written in place, so each block is copied once
    (the allgather has no ⊕, so no kernel is needed)."""

    in_place = True


class _RsWire:
    """Algorithm 1's rounds on the int8 wire format.

    The rotated block buffer becomes a float32 ``(blocks, block_numel)``
    accumulation buffer whose columns are padded to whole quantization
    groups.  Round 0's send rows are quantized; every round then sends
    ONE packed int8 buffer (``[codes | scale bytes]``) and runs one
    dequantize + ⊕-fold + requantize-the-next-send pass.  ``eager+int8``
    runs the plain versions (the reference's ``jnp+int8``), the fused
    backend the ``quantize`` and ``fused_round_dq`` kernels on a card;
    the arithmetic is bitwise the same.  Rounds and exchanges are those
    of the uncompressed path.
    """

    fused = False

    @classmethod
    def begin(cls, plan, x, r):
        R = _rotated_blocks(plan, x, r)
        R2 = R.reshape(plan.p, -1).to(torch.float32)
        cols = R2.shape[1]
        g = min(plan.spec.wire_group, cols)
        R2 = pad2d(R2, 1, g)
        first = plan.rs_rounds[0]
        quant = quantize_rows if cls.fused else _kref.quantize_ref
        codes, scales = quant(R2[first.lo:first.hi], group=g)
        return {"blk_shape": R.shape[1:], "out_dtype": R.dtype, "cols": cols,
                "g": g, "live": R2[:first.lo],
                "wire": pack_wire(codes, scales)}

    @staticmethod
    def payload(plan, d, rnd):
        return d["wire"]

    @classmethod
    def finish(cls, plan, d, t, st):
        live, g = d["live"], d["g"]
        codes, scales = unpack_wire(t, live.shape[1], group=g)
        kern = fused_round_dq if cls.fused else _kref.fused_round_dq_ref
        d["live"], send = kern(live, codes, scales, nb=st.round.nblocks,
                               next_lo=_next_lo(plan, st), op=plan.spec.op,
                               group=g)
        if send is not None:
            d["wire"] = pack_wire(*send)

    @staticmethod
    def end(plan, d):
        out = d["live"][0][:d["cols"]]
        return out.reshape(d["blk_shape"]).to(d["out_dtype"])


class _RsWireFused(_RsWire):
    """:class:`_RsWire` on the ``quantize`` / ``fused_round_dq`` kernels."""

    fused = True


class _AgWire(_AgPlain):
    """Allgather rounds on the int8 wire format.

    The allgather has no ⊕, so each rank quantizes its own block once and
    the rounds move the packed int8 rows unchanged (one quantization step
    of error).  Every rank dequantizes the same codes, so the gathered
    result is replicated bitwise.  The fused backend quantizes with the
    kernel and gathers in place, like :class:`_AgInPlace`.
    """

    fused = False

    @classmethod
    def begin(cls, plan, x, r):
        x2 = x.reshape(1, -1).to(torch.float32)
        cols = x2.shape[1]
        g = min(plan.spec.wire_group, cols)
        x2 = pad2d(x2, 1, g)
        quant = quantize_rows if cls.fused else _kref.quantize_ref
        row = pack_wire(*quant(x2, group=g))       # (1, wire width) int8
        d = super().begin(plan, row[0], r)
        d.update(g=g, cols=cols, padded_cols=x2.shape[1], blk=x.shape,
                 out_dtype=x.dtype)
        return d

    @staticmethod
    def end(plan, d):
        codes, scales = unpack_wire(d["buf"], d["padded_cols"], group=d["g"])
        vals = _kref.dequant_ref(codes, scales, group=d["g"])[:, :d["cols"]]
        out = torch.roll(vals, d["r"], dims=0)  # out[j] = block of rank j
        blk = d["blk"]
        return out.reshape(plan.p * blk[0], *blk[1:]).to(d["out_dtype"])


class _AgWireInPlace(_AgWire):
    """:class:`_AgWire` on the ``quantize`` kernel, gathered in place."""

    fused = True
    in_place = True


#: (backend, phase) → per-rank round ops.  ``payload`` names what
#: ``start_round`` sends; ``finish`` is exchange-free.
_ASYNC_IMPLS: dict[tuple[str, str], type] = {
    ("eager", "rs"): _RsEager,
    ("fused", "rs"): _RsFused,
    ("eager", "ag"): _AgPlain,
    ("fused", "ag"): _AgInPlace,
    ("eager+int8", "rs"): _RsWire,
    ("fused+int8", "rs"): _RsWireFused,
    ("eager+int8", "ag"): _AgWire,
    ("fused+int8", "ag"): _AgWireInPlace,
    # kind="broadcast" is the allgather phase run standalone: it has no
    # ("broadcast", "rs") entry, so its only operation is broadcast().
    ("broadcast", "ag"): _AgPlain,
}


class _PendingDict:
    """The pending exchanges of a ``compress``-ed payload, one per key."""

    def __init__(self, pending: dict, n: int):
        self._pending, self._n = pending, n

    def wait(self) -> list[dict]:
        got = {k: p.wait() for k, p in self._pending.items()}
        return [{k: v[i] for k, v in got.items()} for i in range(self._n)]


def _post(comm, payloads: list, step: int):
    """Post one round's payloads: one exchange, or one per tensor of a
    dict payload (a hook's compressed form)."""
    if isinstance(payloads[0], dict):
        return _PendingDict({k: comm.post([pl[k] for pl in payloads], step)
                             for k in payloads[0]}, len(payloads))
    return comm.post(payloads, step)


# ---------------------------------------------------------------------------
# All-to-all by concatenation (paper §4)
# ---------------------------------------------------------------------------

def _a2a_eager(plan: CollectivePlan, xs, comm) -> list[torch.Tensor]:
    """Bruck-style rounds (the reference's ``_a2a_jnp``): per live slot a
    list of (source offset, payload) pairs — the concatenation ⊕ as
    Python lists — and every round one exchange of each rank's stacked
    send entries.  (p/2)·ceil(log2 p) blocks sent per rank: round-optimal,
    not volume-optimal."""
    p = plan.p
    # per rank: slots[i] = [(offset o, payload from rank r + o), ...]
    ranks = [[[(0, row)] for row in torch.roll(x, -r, dims=0)]
             for x, r in zip(xs, comm.ranks)]
    for pl in plan.rs_rounds:
        s = pl.skip
        sends = [torch.stack([a for i in range(pl.lo, pl.hi)
                              for _, a in slots[i]]) for slots in ranks]
        for slots, T in zip(ranks, comm.shift(sends, s)):
            idx = 0
            for j in range(pl.nblocks):
                for o, _ in slots[pl.lo + j]:
                    slots[j].append(((o - s) % p, T[idx]))
                    idx += 1
            assert idx == T.shape[0]
            del slots[pl.lo:]  # slots [lo, hi) were sent; live = [0, s)
    outs = []
    for slots, r in zip(ranks, comm.ranks):
        assert len(slots[0]) == p, f"expected {p} payloads, got {slots[0]}"
        ordered = torch.stack([a for _, a in
                               sorted(slots[0], key=lambda e: e[0])])
        outs.append(torch.roll(ordered, r, dims=0))  # row j = from rank j
    return outs


def _a2a_fused(plan: CollectivePlan, xs, comm) -> list[torch.Tensor]:
    """Bruck-style rounds over stacked slot buffers (the reference's
    ``_a2a_fused``): slot i is one ``(count_i, blk)`` buffer with the
    parallel list of source offsets; entry order inside each slot matches
    :func:`_a2a_eager`, and the final slot goes into source order with
    one ``permute_rows`` launch per rank (always, the identity order
    included), so the result is bitwise the eager one."""
    p = plan.p
    blk_shape = xs[0].shape[1:]
    ranks = []
    for x, r in zip(xs, comm.ranks):
        rot2 = torch.roll(x, -r, dims=0).reshape(p, -1)
        ranks.append(([rot2[i:i + 1] for i in range(p)],
                      [[0] for _ in range(p)]))
    for pl in plan.rs_rounds:
        s = pl.skip
        sends = [slots[pl.lo] if pl.nblocks == 1 else
                 torch.cat(slots[pl.lo:pl.hi]) for slots, _ in ranks]
        for (slots, offs), T in zip(ranks, comm.shift(sends, s)):
            idx = 0
            for j in range(pl.nblocks):
                src = pl.lo + j
                cnt = len(offs[src])
                slots[j] = torch.cat([slots[j], T[idx:idx + cnt]])
                offs[j] = offs[j] + [(o - s) % p for o in offs[src]]
                idx += cnt
            assert idx == T.shape[0]
            del slots[pl.lo:], offs[pl.lo:]
    outs = []
    for (slots, offs), r in zip(ranks, comm.ranks):
        assert slots[0].shape[0] == p, \
            f"expected {p} payloads, got {slots[0].shape[0]}"
        order = sorted(range(p), key=lambda i: offs[0][i])
        ordered = permute_rows(slots[0], order)  # ordered[o] = from (r+o)
        out = torch.roll(ordered, r, dims=0)     # row j = from rank j
        outs.append(out.reshape(p, *blk_shape))
    return outs


def final_slot_order(p: int, schedule: str = "halving",
                     group: int | None = None) -> tuple[int, ...]:
    """The permutation the fused alltoall hands ``permute_rows`` at p
    ranks: its final slot's entries, by source offset (the same on every
    rank)."""
    offs = [[0] for _ in range(p)]
    for pl in reduce_scatter_plan(p, schedule, group):
        for j in range(pl.nblocks):
            offs[j] = offs[j] + [(o - pl.skip) % p for o in offs[pl.lo + j]]
        del offs[pl.lo:]
    return tuple(sorted(range(p), key=lambda i: offs[0][i]))


def _rows(plan: CollectivePlan, table: np.ndarray, r: int,
          device) -> torch.Tensor:
    """Row ``r`` of one of ``plan``'s tables as an index tensor on
    ``device``, uploaded once per plan (no host-to-device copy, and so no
    stream synchronisation, inside the rounds)."""
    key = (id(table), r, str(device))
    rows = plan.rows_cache.get(key)
    if rows is None:
        rows = plan.rows_cache[key] = torch.as_tensor(
            table[r], dtype=torch.long, device=device)
    return rows


def _a2a_v(plan: CollectivePlan, xs, comm) -> list[torch.Tensor]:
    """Ragged alltoallv over the per-pair counts matrix (the reference's
    ``_a2a_v``): each buffer stays in ABSOLUTE (src, dst) pair order;
    round k gathers a rank's hopping rows through ``a2a.round_tables[k]``
    into one fixed-width wire buffer, exchanges it once, and the receiver
    sets the rows through the sender's row of the same table (no ⊕, so
    any dtype).  Sentinel rows stay zero: padding reads and writes only
    ever move zeros."""
    a2a, p = plan.a2a, plan.p
    bufs, shapes = [], []
    for x, r in zip(xs, comm.ranks):
        if x.shape[0] != a2a.in_height:
            raise ValueError(
                f"input has {x.shape[0]} rows, counts matrix needs "
                f"in_height={a2a.in_height} (= max per-rank send total)")
        x2 = x.reshape(a2a.in_height, -1)
        zero = x2.new_zeros((1, x2.shape[1]))
        xpad = torch.cat([x2, zero])
        buf = x2.new_zeros((a2a.total + 1, x2.shape[1]))
        buf = buf.index_put((_rows(plan, a2a.seed_dst, r, x.device),),
                            xpad[_rows(plan, a2a.seed_src, r, x.device)])
        bufs.append(buf)
        shapes.append(x.shape[1:])
    for k, pl in enumerate(plan.rs_rounds):
        table = a2a.round_tables[k]
        sends = [b[_rows(plan, table, r, b.device)]
                 for b, r in zip(bufs, comm.ranks)]
        got = comm.shift(sends, pl.skip)
        bufs = [b.index_put(
                    (_rows(plan, table, (r - pl.skip) % p, b.device),), T)
                for b, T, r in zip(bufs, got, comm.ranks)]
    outs = []
    for b, r, shape in zip(bufs, comm.ranks, shapes):
        out = b[_rows(plan, a2a.out_rows, r, b.device)]
        keep = torch.arange(a2a.out_height, device=b.device) < \
            a2a.recv_total[r]
        out = torch.where(keep[:, None], out, torch.zeros_like(out))
        outs.append(out.reshape(a2a.out_height, *shape))
    return outs


# ---------------------------------------------------------------------------
# Baselines (one-shot backends; their folds are plain reduce_fn)
# ---------------------------------------------------------------------------

def _as_blocks(x: torch.Tensor, p: int) -> torch.Tensor:
    """The leading axis as ``(p, n/p, *rest)`` (n divisible by p)."""
    return BlockLayout.uniform(p, x.shape[0]).as_blocks(x)


def ring_reduce_scatter(xs: Tensors, comm, *, op: str | Callable = "add",
                        **_ignored) -> list[torch.Tensor]:
    """The classic p-1-round ring reduce-scatter [Patarasuk-Yuan; paper
    §1]: volume-optimal, one exchange to rank r+1 per round, latency
    linear in p.  In rotated coordinates (``R[i]`` = block of rank r+i)
    step t sends the running partial to r+1 and folds what arrived into
    ``R[p-2-t]``: ``reduce_fn(R[idx], got)``."""
    reduce_fn = resolve_op(op)
    p = comm.p
    if p == 1:
        return list(xs)
    R = [torch.roll(_as_blocks(x, p), -r, dims=0)
         for x, r in zip(xs, comm.ranks)]
    bufs = [Rr[p - 1] for Rr in R]
    for t in range(p - 1):
        got = comm.shift(bufs, 1)
        idx = p - 2 - t
        bufs = [reduce_fn(Rr[idx], g) for Rr, g in zip(R, got)]
    return bufs


def ring_allreduce(xs: Tensors, comm, *, op: str | Callable = "add",
                   **_ignored) -> list[torch.Tensor]:
    """Ring reduce-scatter + ring allgather: 2(p-1) exchanges,
    bandwidth-optimal; replicated bitwise."""
    p = comm.p
    if p == 1:
        return list(xs)
    w = ring_reduce_scatter(xs, comm, op=op)
    blocks = [[b] for b in w]
    cur = w
    for _ in range(p - 1):
        cur = comm.shift(cur, 1)
        for held, got in zip(blocks, cur):
            held.append(got)
    outs = []
    for held, r in zip(blocks, comm.ranks):
        # held[t] on rank r is block (r - t) mod p; stacked reversed,
        # row i is block (r + i + 1) mod p.
        stacked = torch.stack(held[::-1])
        out = torch.roll(stacked, r + 1, dims=0)
        outs.append(out.reshape(p * held[0].shape[0], *held[0].shape[1:]))
    return outs


def recursive_halving_reduce_scatter(xs: Tensors, comm, *,
                                     op: str | Callable = "add",
                                     **_ignored) -> list[torch.Tensor]:
    """Hypercube (butterfly) reduce-scatter, power-of-two p only (the
    classic algorithm whose awkwardness at other p motivates the paper):
    log2 p rounds, in round d every rank exchanges half its live blocks
    with partner ``r ^ d`` and folds ``reduce_fn(keep, got)``."""
    reduce_fn = resolve_op(op)
    p = comm.p
    if p == 1:
        return list(xs)
    if p & (p - 1):
        raise ValueError(f"recursive halving needs power-of-two p, got {p}")
    bufs = [_as_blocks(x, p) for x in xs]  # absolute block coordinates
    d = p // 2
    while d >= 1:
        sends, keeps = [], []
        for buf, r in zip(bufs, comm.ranks):
            half = buf.shape[0] // 2
            low, high = buf[:half], buf[half:]
            bit = (r // d) % 2  # which half this rank keeps
            sends.append(low if bit else high)
            keeps.append(high if bit else low)
        got = comm.permute(sends, [(i, i ^ d) for i in range(p)])
        bufs = [reduce_fn(k, g) for k, g in zip(keeps, got)]
        d //= 2
    return [b[0] for b in bufs]


def xla_reduce_scatter(xs: Tensors, comm, **_) -> list[torch.Tensor]:
    """The native reduce-scatter (``psum_scatter``'s counterpart; the
    same block-partition contract as :func:`circulant_reduce_scatter`).
    Like the reference's it sums whatever ``op`` says."""
    return comm.reduce_scatter_sum(xs)


def xla_allreduce(xs: Tensors, comm, **_) -> list[torch.Tensor]:
    """The native allreduce (``psum``'s counterpart; sums)."""
    return comm.all_reduce_sum(xs)


def xla_allgather(xs: Tensors, comm, **_) -> list[torch.Tensor]:
    """The native allgather along the leading axis, the layout
    :func:`circulant_allgather` produces."""
    return comm.all_gather(xs)


def xla_alltoall(xs: Tensors, comm, **_) -> list[torch.Tensor]:
    """The native all-to-all, the layout contract of
    :func:`circulant_alltoall`."""
    return comm.all_to_all(xs)


def _a2a_xla(plan: CollectivePlan, xs, comm) -> list[torch.Tensor]:
    return xla_alltoall(xs, comm)


_BASELINE_RS = {
    "ring": ring_reduce_scatter,
    "recursive_halving": recursive_halving_reduce_scatter,
    "xla": xla_reduce_scatter,
}
_BASELINE_AR = {"ring": ring_allreduce, "xla": xla_allreduce}
_BASELINE_AG = {"xla": xla_allgather}
#: alltoall backends (the reference's ``_A2A_IMPLS``).
_A2A_IMPLS = {
    "eager": _a2a_eager,
    "fused": _a2a_fused,
    "alltoallv": _a2a_v,
    "xla": _a2a_xla,
}

#: which collectives each backend implements (the reference's
#: ``BACKENDS``, its ``jnp`` backends named ``eager`` here; ``auto``
#: resolves to ``eager`` or ``fused`` per payload).
BACKENDS: dict[str, tuple[str, ...]] = {
    "eager": ("reduce_scatter", "allgather", "allreduce", "alltoall"),
    "fused": ("reduce_scatter", "allgather", "allreduce", "alltoall"),
    "eager+int8": ("reduce_scatter", "allgather", "allreduce"),
    "fused+int8": ("reduce_scatter", "allgather", "allreduce"),
    "nonuniform": ("reduce_scatter", "allgather", "allreduce"),
    "alltoallv": ("alltoall",),
    "broadcast": ("broadcast",),
    "ring": ("reduce_scatter", "allreduce"),
    "recursive_halving": ("reduce_scatter",),
    "xla": ("reduce_scatter", "allgather", "allreduce", "alltoall"),
}


# ---------------------------------------------------------------------------
# Non-uniform counts (paper Corollary 3) — gather/scatter over row tables
# ---------------------------------------------------------------------------

def _rs_nonuniform(plan: CollectivePlan, xs, comm) -> list[torch.Tensor]:
    """Corollary 3: reduce-scatter with per-rank block sizes (the
    reference's ``_rs_nonuniform``).

    Each buffer stays in ABSOLUTE column order (blocks differ in size, so
    the rotation lives in the row tables), with a sentinel row ``N``.
    Round k gathers a rank's rows for its rotated send window into one
    wire of fixed width ``W_k`` (the worst windowed count sum over ranks,
    padding rows included, so every rank ships the same shape), one
    ``comm.shift`` by ``+skip``, and the receiver ⊕-folds the rows in
    place through the SENDER's row of the same table: both store column
    c at the same absolute rows.  The fold is gather, ⊕ (own partial
    first, as the simulator folds), store, so each ⊕ rounds once in the
    payload's dtype.  Real rows are unique within a round; padding rows
    all land on the sentinel, which is never read back as data.

    Input: ``(sum(counts), *rest)`` per rank.  Output: ``(max(counts),
    *rest)``, rank r's block in rows ``[0, counts[r])``, zeros above.
    """
    layout, p = plan.layout, plan.p
    N, bmax = layout.total, layout.bmax
    op = resolve_op(plan.spec.op)
    bufs = []
    for x in xs:
        if x.shape[0] != N:
            raise ValueError(f"input has {x.shape[0]} rows, counts "
                             f"{layout.counts} need {N}")
        x2 = x.reshape(N, -1)
        buf = x2.new_empty((N + 1, x2.shape[1]))
        buf[:N] = x2
        buf[N] = 0
        bufs.append(buf)
    for k, pl in enumerate(plan.rs_rounds):
        table = plan.rs_row_tables[k]
        sends = [b.index_select(0, _rows(plan, table, r, b.device))
                 for b, r in zip(bufs, comm.ranks)]
        for b, T, r in zip(bufs, comm.shift(sends, pl.skip), comm.ranks):
            rows = _rows(plan, table, (r - pl.skip) % p, b.device)
            b.index_copy_(0, rows, op(b.index_select(0, rows), T))
    outs = []
    for b, x, r in zip(bufs, xs, comm.ranks):
        c, off = layout.counts[r], layout.offsets[r]
        out = b.new_zeros((bmax, b.shape[1]))
        out[:c] = b[off:off + c]
        outs.append(out.reshape(bmax, *x.shape[1:]))
    return outs


def _ag_nonuniform(plan: CollectivePlan, xs, comm) -> list[torch.Tensor]:
    """Allgather(v): the inverse layout of :func:`_rs_nonuniform` (the
    reference's ``_ag_nonuniform``).  Each rank's ``(max(counts),
    *rest)``, its block in rows ``[0, counts[r])``, seeds its rows of an
    absolute-order buffer; round k ships the rows of the table's window
    by ``-skip`` and the receiver stores them through the sender's row
    of the table.  Output ``(sum(counts), *rest)`` in rank order, the
    same bits on every rank (no ⊕)."""
    layout, p = plan.layout, plan.p
    N, bmax = layout.total, layout.bmax
    bufs = []
    for x, r in zip(xs, comm.ranks):
        if x.shape[0] != bmax:
            raise ValueError(f"input has {x.shape[0]} rows, counts "
                             f"{layout.counts} need max(counts) = {bmax}")
        x2 = x.reshape(bmax, -1)
        c, off = layout.counts[r], layout.offsets[r]
        buf = x2.new_zeros((N + 1, x2.shape[1]))
        buf[off:off + c] = x2[:c]
        bufs.append(buf)
    for k, pl in enumerate(plan.ag_rounds):
        table = plan.ag_row_tables[k]
        sends = [b.index_select(0, _rows(plan, table, r, b.device))
                 for b, r in zip(bufs, comm.ranks)]
        for b, T, r in zip(bufs, comm.shift(sends, -pl.skip), comm.ranks):
            rows = _rows(plan, table, (r + pl.skip) % p, b.device)
            b.index_copy_(0, rows, T)
    return [b[:N].reshape(N, *x.shape[1:]) for b, x in zip(bufs, xs)]
