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
(``resolve_fused``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from ..kernels import (fused_round, fused_round_dq, quantize_rows,
                       resolve_fused)
from ..kernels import ref as _kref
from ..kernels.quantize import MAX_GROUP, pack_wire, pad2d, unpack_wire
from .schedule import RoundPlan, allgather_plan, reduce_scatter_plan
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
# Block layout — the padding path
# ---------------------------------------------------------------------------

def as_blocks(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reshape the leading axis of ``x`` into ``(p, n/p, *rest)`` equal
    blocks: the reference's uniform ``BlockLayout`` (its non-uniform row
    tables are not ported)."""
    n = x.shape[0]
    if n % p:
        raise ValueError(
            f"leading dim {n} not divisible by axis size {p}; pad first")
    return x.reshape(p, n // p, *x.shape[1:])


# ---------------------------------------------------------------------------
# Round protocol state
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class RoundState:
    """State of one phase of a collective, across the local ranks.

    plan / comm: what runs it; phase: ``"rs"`` or ``"ag"``; backend: the
    resolved ops (``eager``/``fused``, ``eager+int8``/``fused+int8``);
    nrounds: rounds of the phase (0 for p == 1); k: rounds finished;
    started: an exchange is in flight; inflight: the received payloads of
    the started round, one per local rank; data: backend-private per-rank
    buffers, one dict per local rank (``data[i]["r"]`` is that rank's
    index).
    """

    plan: "CollectivePlan"
    comm: object
    phase: str
    backend: str
    nrounds: int
    k: int = 0
    started: bool = False
    inflight: list | None = None
    data: list = field(default_factory=list)

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
    ``{1, .., p-1}`` exactly (Theorem 1).  ``backend`` is ``"eager"``,
    ``"fused"``, ``"eager+int8"``, ``"fused+int8"`` or ``"auto"``
    (resolved from each payload's device).
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

    def backend_for(self, device: torch.device | str | None) -> str:
        """The backend that runs a payload on ``device``."""
        if self.backend != "auto":
            return self.backend
        return _resolve_backend(self.spec, device)

    # -- one-shot execution -------------------------------------------------

    def reduce_scatter(self, xs: Sequence[torch.Tensor], comm
                       ) -> list[torch.Tensor]:
        """Paper Algorithm 1: each rank's ``(n, *rest)`` input (n divisible
        by p) to its reduced ``(n/p, *rest)`` block; one exchange per
        round."""
        st = self.rs_begin(xs, comm)
        while not st.done:
            self.finish_round(self.start_round(st))
        return self.rs_end(st)

    def allgather(self, xs: Sequence[torch.Tensor], comm
                  ) -> list[torch.Tensor]:
        """Algorithm 2's second phase standalone: each rank's block
        ``(blk, *rest)`` to ``(p*blk, *rest)`` in rank order."""
        st = self.ag_begin(xs, comm)
        while not st.done:
            self.finish_round(self.start_round(st))
        return self.ag_end(st)

    def allreduce(self, xs: Sequence[torch.Tensor], comm
                  ) -> list[torch.Tensor]:
        """Paper Algorithm 2: reduce-scatter + reversed allgather."""
        return self.allgather(self.reduce_scatter(xs, comm), comm)

    # -- multi-call round protocol ------------------------------------------

    def rs_begin(self, xs: Sequence[torch.Tensor], comm) -> RoundState:
        """Open a reduce-scatter over the local ranks' ``xs``: rotate each
        into block coordinates and lay out round 0's send payload, without
        any exchange."""
        return self._begin(xs, comm, "rs")

    def ag_begin(self, xs: Sequence[torch.Tensor], comm) -> RoundState:
        """Open an allgather of the local ranks' blocks ``xs``."""
        return self._begin(xs, comm, "ag")

    def _begin(self, xs, comm, phase: str) -> RoundState:
        if comm.p != self.p:
            raise ValueError(
                f"plan compiled for p={self.p}, communicator has {comm.p}")
        if len(xs) != len(comm.ranks):
            raise ValueError(
                f"{len(comm.ranks)} local rank(s), got {len(xs)} payloads")
        _check_wire_payload(self, xs[0])
        backend = self.backend_for(xs[0].device)
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
        """Issue round ``st.k``'s single exchange: every local rank's send
        payload goes ``+skip`` (reduce-scatter) or ``-skip`` (allgather)
        in one ``comm.shift``.  Mutates and returns ``st``."""
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
        step = rnd.skip if st.phase == "rs" else -rnd.skip
        st.inflight = st.comm.shift(payloads, step)
        st.started = True
        return st

    def finish_round(self, st: RoundState) -> RoundState:
        """Fold round ``st.k``'s received payloads and lay out the next
        round's send buffers (exchange-free; the fused backend does both
        in one kernel launch per rank).  Mutates and returns ``st``."""
        self._check_state(st)
        if not st.started:
            raise ValueError(
                f"round {st.k} has no exchange in flight; call "
                f"start_round() first")
        ops = _ASYNC_IMPLS[(st.backend, st.phase)]
        for d, t in zip(st.data, st.inflight):
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


# ---------------------------------------------------------------------------
# plan(): spec -> CollectivePlan, memoized
# ---------------------------------------------------------------------------

def _check_wire_payload(plan: CollectivePlan, x: torch.Tensor) -> None:
    """The int8 wire needs float payloads (a quantization grid); checked
    at execution because the spec is payload-agnostic."""
    if plan.spec.wired and not x.dtype.is_floating_point:
        raise ValueError(
            f"wire_dtype='int8' needs a float payload, got {x.dtype}")


def _resolve_backend(spec: CollectiveSpec, device=None) -> str:
    """Backend for ``spec`` with a payload on ``device``."""
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
    _resolve_backend(spec)  # validates op x kernel choice up front
    backend = ("auto" if spec.use_fused_kernel is None
               else _resolve_backend(spec))
    rs = reduce_scatter_plan(p, spec.schedule, spec.group)
    ag = allgather_plan(p, spec.schedule, spec.group)
    return CollectivePlan(
        spec=spec, p=p, backend=backend,
        skips=tuple(pl.skip for pl in rs), rs_rounds=rs, ag_rounds=ag,
        rs_send_blocks=tuple(tuple(range(pl.lo, pl.hi)) for pl in rs),
        rs_recv_blocks=tuple(tuple(range(0, pl.nblocks)) for pl in rs),
        ag_send_blocks=tuple(tuple(range(0, pl.nblocks)) for pl in ag),
        ag_recv_blocks=tuple(tuple(range(pl.lo, pl.hi)) for pl in ag))


def plan(spec: CollectiveSpec | None = None, p: int | None = None,
         **kw) -> CollectivePlan:
    """Compile ``spec`` for ``p`` ranks (cached).  Bare kwargs build the
    spec in place: ``plan(p=8, schedule="power2")``."""
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
    return torch.roll(as_blocks(x, plan.p), -r, dims=0)


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
        d["live"], d["send"] = fused_round(
            d["live"], t, nb=st.round.nblocks, next_lo=_next_lo(plan, st),
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
}
