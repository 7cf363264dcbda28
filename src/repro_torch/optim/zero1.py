"""ZeRO-1 over the paper's collectives, ported from ``repro/optim/zero1.py``.

Every large gradient leaf is REDUCE-SCATTERED (Algorithm 1) along its
leading dimension, AdamW updates only the local 1/world shard (optimizer
state is never replicated), and the updated parameter shards are
ALLGATHERED back with the reversed schedule (Algorithm 2's second phase):
per step and leaf, 2*ceil(log2 p) exchanges — Theorem 2's optimum.  The
leading dim is zero-padded to a multiple of the world and sliced back
after the allgather.  Leaves too small to shard (norms, scalars) are
summed with a plain all-reduce and updated replicated.

Per-rank values are lists over the ranks the communicator holds in this
process (``comm.ranks``): p entries on a ``LocalComm``, one on a
``DistComm``.  The scalars the step folds over ranks (the grad norm's
shard sums, the reported loss) and the tiny leaves fold in rank order
(``comm.fold_sum``), so one rank per process gives the bits of the
in-process world; the ``xla`` and ``allreduce`` impls keep the native
sums for their leaves.  The reference's grad-sync implementations
(``GradSyncConfig.impl``):

  circulant   paper Algorithm 1/2, exact or with the reduce-scatter on
              the int8 wire (``wire_dtype="int8"``), whose quantization
              error an EF-SGD residual per rank and leaf carries into the
              next step (``error_feedback``, on by default);
  ring        the p-1-round ring reduce-scatter; the allgather runs on
              the circulant schedule (ring has none of its own);
  xla         the native one-call reduce-scatter and allgather;
  allreduce   the no-ZeRO memory baseline: every leaf all-reduced and
              updated replicated, with full ``m`` / ``v`` on every rank.

The allgather is never on the wire: parameter shards reassemble
exactly.  ``bucket_bytes`` (circulant only) syncs the zero leaves in
size-targeted buckets (:func:`plan_grad_buckets`), each one
reduce-scatter and one allgather on the cached plan, software-pipelined
across buckets (``reduce_scatter_pipelined``); exact, it is bitwise the
per-leaf sync.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from .. import tree as T
from ..core import collectives as C
from ..core.spec import CollectiveSpec
from ..kernels.ops import dequantize_blocks, quantize_blocks
from ..kernels.quantize import DEFAULT_GROUP
from . import adamw

_IMPLS = ("circulant", "ring", "xla", "allreduce")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class GradSyncConfig:
    """How zero1 synchronizes gradients and re-gathers parameter shards
    (the reference's ``repro.optim.zero1.GradSyncConfig``).  It compiles
    to :class:`CollectiveSpec` objects (:meth:`rs_spec` /
    :meth:`ag_spec`).

    ``impl``: ``'circulant'`` (paper Algorithm 1/2; the only impl with
    the wire and bucketing), ``'ring'`` (p-1-round baseline), ``'xla'``
    (the native collectives) or ``'allreduce'`` (replicated, full
    optimizer state: no ZeRO); ``schedule`` any Corollary-2 schedule.  ``wire_dtype`` ``None`` (exact) or ``'int8'``:
    every reduce-scatter round's send on the packed int8 wire (~4x fewer
    bytes, lossy); ``compress`` is its deprecated alias (warns).
    ``error_feedback``: the EF-SGD residual of the compressed sync (each
    rank keeps its local quantization error in ``Zero1State.ef`` and adds
    it to the next step's gradient before quantizing); it takes effect
    only where the sync is lossy (:attr:`uses_error_feedback`).
    ``quant_group``: elements per int8 scale group.  ``min_shard_numel``:
    the size below which a leaf stays replicated.  ``rs_dtype``: the
    reduce-scatter payload's dtype (``'bfloat16'`` halves an exact
    sync's bytes; the int8 wire quantizes float32 gradients, so it takes
    ``'float32'`` only).  ``use_fused_kernel``: route every reduce-scatter
    round through the ``fused_round`` kernel, or on the int8 wire the
    ``quantize`` and ``fused_round_dq`` kernels (``None`` = auto: on when
    the gradients lie on a card).  ``bucket_bytes``: ``None`` syncs each
    leaf in one shot; a positive int syncs the zero leaves in buckets of
    about that many bytes of full gradient, pipelined (circulant only).
    """

    impl: str = "circulant"
    schedule: str = "halving"
    wire_dtype: str | None = None
    compress: str | None = None   # deprecated alias for wire_dtype
    error_feedback: bool = True
    quant_group: int = DEFAULT_GROUP
    min_shard_numel: int = 1024
    rs_dtype: str = "float32"
    use_fused_kernel: bool | None = None
    bucket_bytes: int | None = None

    def __post_init__(self):
        if self.compress is not None:
            warnings.warn(
                "GradSyncConfig(compress=...) is deprecated; pass "
                "wire_dtype=... — it feeds the CollectiveSpec the grad "
                "sync plans are built from (see GradSyncConfig.rs_spec)",
                DeprecationWarning, stacklevel=3)
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown grad-sync impl {self.impl!r}; "
                             f"have {_IMPLS}")
        if self.rs_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"rs_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.rs_dtype!r}")
        if self.rs_dtype != "float32" and self.wire is not None:
            raise ValueError(
                f"rs_dtype={self.rs_dtype!r} with wire_dtype={self.wire!r}: "
                f"the int8 wire quantizes float32 gradients; a narrower "
                f"payload would only round them once more first")
        if self.bucket_bytes is not None:
            if self.bucket_bytes <= 0:
                raise ValueError(
                    f"bucket_bytes must be positive, got {self.bucket_bytes}")
            if self.impl != "circulant":
                raise ValueError(
                    "bucket_bytes requires impl='circulant' — the bucketed "
                    "path pipelines circulant plans "
                    f"(got impl={self.impl!r})")

    @property
    def wire(self) -> str | None:
        """Effective wire dtype (``wire_dtype`` wins over the legacy
        ``compress`` spelling)."""
        return self.wire_dtype or self.compress

    @property
    def uses_error_feedback(self) -> bool:
        """EF applies only where the sync is lossy: the circulant impl on
        the int8 wire."""
        return (self.error_feedback and self.wire == "int8"
                and self.impl == "circulant")

    @property
    def use_zero(self) -> bool:
        """False for the no-ZeRO ``allreduce`` baseline."""
        return self.impl != "allreduce"

    @property
    def native_sums(self) -> bool:
        """The ``xla`` and ``allreduce`` impls sum the tiny leaves with
        the native all-reduce; the others fold them in rank order."""
        return self.impl in ("xla", "allreduce")

    def rs_spec(self) -> CollectiveSpec:
        """The reduce-scatter :class:`CollectiveSpec` this config means
        (``allreduce`` shards nothing; its spec is the native one)."""
        kind = self.impl if self.impl != "allreduce" else "xla"
        if kind != "circulant":
            return CollectiveSpec(kind=kind)
        return CollectiveSpec(
            kind="circulant", schedule=self.schedule,
            use_fused_kernel=self.use_fused_kernel,
            wire_dtype=self.wire if self.wire == "int8" else None,
            wire_group=self.quant_group)

    def ag_spec(self) -> CollectiveSpec:
        """The allgather's spec: parameter shards must reassemble exactly,
        so the wire format never applies; ring has no allgather and runs
        the circulant schedule's."""
        if self.impl not in ("circulant", "ring"):
            return CollectiveSpec(kind="xla")
        return CollectiveSpec(kind="circulant", schedule=self.schedule,
                              use_fused_kernel=self.use_fused_kernel)


class Zero1State(NamedTuple):
    """One rank's ZeRO-1 optimizer state: AdamW moments holding only this
    rank's 1/world shard for zero leaves (full for tiny leaves), as
    trees mirroring the parameters, the number of steps taken, and the
    EF-SGD residuals of the compressed sync (``None`` when EF is off):
    this rank's own full-leaf float32 quantization error for zero
    leaves, a zero dummy for tiny leaves (synced exactly, never read)."""
    m: dict
    v: dict
    step: int
    ef: dict | None = None


def is_zero_leaf(shape, world: int, min_numel: int) -> bool:
    """Shard a leaf iff it is big enough and leading-dim padding waste is
    bounded (< 2x)."""
    numel = int(np.prod(shape)) if len(shape) else 0
    if numel < max(min_numel, world):
        return False
    ld = shape[0]
    pad_ld = ld + (-ld) % world
    return pad_ld <= 2 * ld or numel // max(ld, 1) * pad_ld >= min_numel


def padded_rows(ld: int, world: int) -> int:
    """A zero leaf's leading dim ``ld`` padded to a multiple of
    ``world``."""
    return ld + (-ld) % world


def zero_flags(shapes: Sequence[tuple], world: int,
               sync: GradSyncConfig) -> list[bool]:
    """Per leaf of ``shapes``: does a step shard it (the allreduce
    baseline shards none)?"""
    return [sync.use_zero and is_zero_leaf(s, world, sync.min_shard_numel)
            for s in shapes]


def _pad_lead(x: torch.Tensor, world: int, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` with its leading dim zero-padded to a
    multiple of ``world``, in one new tensor (at full width a cast and a
    pad as two copies would double the largest transient)."""
    ld = x.shape[0]
    out = x.new_zeros((padded_rows(ld, world), *x.shape[1:]), dtype=dtype)
    out[:ld] = x
    return out


def shard_offset(ld_pad: int, rank: int, world: int) -> tuple[int, int]:
    """(row offset, rows per shard) of ``rank``'s slice."""
    rows = ld_pad // world
    return rank * rows, rows


def local_rows(p: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """``rank``'s shard rows of ``p`` padded to a multiple of ``world``
    (the reference pads the whole leaf and slices; this slices first and
    pads only the rows past the end)."""
    ld = p.shape[0]
    off, rows = shard_offset(padded_rows(ld, world), rank, world)
    part = p[min(off, ld):min(off + rows, ld)]
    if part.shape[0] < rows:
        part = torch.cat(
            [part, p.new_zeros((rows - part.shape[0], *p.shape[1:]))])
    return part


def reduce_scatter_leaf(gs: Sequence[torch.Tensor], comm,
                        sync: GradSyncConfig, world: int
                        ) -> list[torch.Tensor]:
    """Cast to ``rs_dtype``, RS along dim 0 on the cached plan
    (``sync.rs_spec()``); returns each local rank's averaged shard in
    float32."""
    dt = _DTYPES[sync.rs_dtype]
    out = C.reduce_scatter([_pad_lead(g, world, dt) for g in gs], comm,
                           spec=sync.rs_spec())
    return [(o / world).to(torch.float32) for o in out]


def allgather_leaf(shards: Sequence[torch.Tensor], ld: int, comm,
                   sync: GradSyncConfig) -> list[torch.Tensor]:
    """Inverse: AG along dim 0 (``sync.ag_spec()``, never on the wire),
    then drop the padding rows."""
    out = C.allgather(shards, comm, spec=sync.ag_spec())
    return [o[:ld] for o in out]


def allreduce_leaf(gs: Sequence[torch.Tensor], comm, world: int,
                   native: bool = False) -> list[torch.Tensor]:
    """Tiny-leaf path: replicated mean over a rank-order fold
    (``comm.fold_sum``: a process world gives the in-process world's
    bits), or with ``native`` over the native all-reduce (NCCL's or
    gloo's own sum on a ``DistComm``; the ``xla`` and ``allreduce``
    impls)."""
    sums = comm.all_reduce_sum(gs) if native else comm.fold_sum(gs)
    return [s / world for s in sums]


def ef_quantize(g: torch.Tensor, residual: torch.Tensor, group: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """EF-SGD compensation (per rank, per leaf): add the carried residual
    to the raw gradient, round the sum onto the int8 grid the wire will
    use, and keep the new rounding error as the next step's residual.
    Returns ``(q, comp - q)``; ``q`` enters the compressed reduce-scatter.
    The requantization error of partial sums in later rounds mixes ranks
    and stays uncompensated (standard EF-SGD scope)."""
    comp = g.to(torch.float32) + residual
    q = dequantize_blocks(quantize_blocks(comp, group=group))
    return q, comp - q


# ---------------------------------------------------------------------------
# Bucketed, pipelined grad sync (GradSyncConfig.bucket_bytes)
# ---------------------------------------------------------------------------

def plan_grad_buckets(shapes: Sequence[tuple], world: int,
                      bucket_bytes: int, itemsize: int = 4
                      ) -> list[list[tuple[int, int, int]]]:
    """Partition the zero leaves' gradients into size-targeted buckets
    (the reference's ``plan_grad_buckets``).

    ``shapes`` are the zero leaves' shapes in leaf order.  Each leaf's
    padded leading dim splits into ``world`` blocks of ``R = ld_pad //
    world`` shard rows; the leaves are walked in order, filling buckets
    greedily to about ``bucket_bytes`` of full-gradient volume (one shard
    row stands for ``world`` gradient rows).  Returns the buckets, each a
    list of ``(leaf, lo, hi)`` segments: shard rows ``[lo, hi)`` of
    ``shapes[leaf]``.  A leaf's segments are disjoint, in increasing
    order and cover ``[0, R)``; a leaf larger than ``bucket_bytes`` is
    split; a row larger than ``bucket_bytes`` gets a bucket of its own
    (never an empty bucket)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    buckets: list[list[tuple[int, int, int]]] = []
    cur: list[tuple[int, int, int]] = []
    cur_bytes = 0
    for i, shape in enumerate(shapes):
        ld = shape[0]
        rest = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        R = (ld + (-ld) % world) // world
        row_bytes = rest * world * itemsize
        lo = 0
        while lo < R:
            room = bucket_bytes - cur_bytes
            if cur and room < row_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
                room = bucket_bytes
            take = min(R - lo, max(1, room // row_bytes))
            cur.append((i, lo, lo + take))
            cur_bytes += take * row_bytes
            lo += take
            if cur_bytes >= bucket_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def _row_numel(shape) -> int:
    return max(1, int(np.prod(shape[1:]))) if len(shape) > 1 else 1


def _last_use(buckets) -> dict[int, int]:
    """Zero-leaf index -> the last bucket holding a segment of it."""
    return {li: b for b, bucket in enumerate(buckets) for li, _, _ in bucket}


def grad_buckets(zero_shapes: Sequence[tuple], world: int,
                 sync: GradSyncConfig) -> list[list[tuple[int, int, int]]]:
    """The bucket partition the bucketed reduce and allgather both run
    on: :func:`plan_grad_buckets` of the zero leaves at ``rs_dtype``."""
    return plan_grad_buckets(zero_shapes, world, sync.bucket_bytes,
                             _DTYPES[sync.rs_dtype].itemsize)


def bucket_width(bucket, zero_shapes: Sequence[tuple]) -> int:
    """Elements of one rank's block of a bucket's vector."""
    return sum((hi - lo) * _row_numel(zero_shapes[li])
               for li, lo, hi in bucket)


def bucket_dtype(dtypes: Sequence[torch.dtype]) -> torch.dtype:
    """The bucketed allgather's payload dtype: the zero leaves' parameter
    dtypes promoted (each leaf casts back losslessly)."""
    dt = dtypes[0]
    for d in dtypes[1:]:
        dt = torch.promote_types(dt, d)
    return dt


class SyncCall(NamedTuple):
    """One collective call a rank makes in a step.  ``op``:
    ``"reduce_scatter"`` / ``"allgather"`` on the plan of ``spec``,
    ``"fold"`` (``comm.fold_sum``) or ``"all_reduce"`` (the native sum;
    ``spec`` is ``None`` for both).  ``numel``: the elements of the
    rank's payload, the whole padded vector of a reduce-scatter, the
    block of an allgather, the tensor of a fold or an all-reduce."""
    op: str
    spec: CollectiveSpec | None
    numel: int
    dtype: torch.dtype


def sync_schedule(shapes: Sequence[tuple], dtypes: Sequence[torch.dtype],
                  world: int, sync: GradSyncConfig,
                  model_axis: bool = False) -> list[SyncCall]:
    """The collective calls one rank makes in one :func:`zero1_step`
    over ``world`` ranks, for leaves of ``shapes`` and parameter
    ``dtypes`` (flatten order), in the step's order: each zero leaf's
    reduce-scatter (padded, at ``rs_dtype``) and each tiny leaf's float32
    fold or native all-reduce, in leaf order, the buckets'
    reduce-scatters after them; the fold of the grad norm's shard sums;
    each zero leaf's allgather (its parameter dtype), or each bucket's
    (:func:`bucket_dtype`); the fold of the loss.  The step lays its
    sync out with the same helpers (:func:`zero_flags`,
    :func:`padded_rows`, :func:`grad_buckets`, :func:`bucket_width`,
    :func:`bucket_dtype`, ``GradSyncConfig.native_sums``);
    ``roofline/analysis.sync_counts`` counts these calls' bytes on
    their plans.  With a ``model_axis`` (tensor parallelism: ``shapes``
    are one rank's blocks) the grad norm's fold carries two sums, the
    model-split leaves' and the replicated ones' (its model-axis fold is
    the model axis's call)."""
    flags = zero_flags(shapes, world, sync)
    zero = [i for i, f in enumerate(flags) if f]
    zshapes = [shapes[i] for i in zero]
    buckets = (grad_buckets(zshapes, world, sync)
               if sync.bucket_bytes is not None and zero else None)
    rs_dt, f32 = _DTYPES[sync.rs_dtype], torch.float32
    rs, ag = sync.rs_spec(), sync.ag_spec()
    tiny = "all_reduce" if sync.native_sums else "fold"
    calls = []
    for shape, flag in zip(shapes, flags):
        if not flag:
            calls.append(SyncCall(tiny, None, int(np.prod(shape)), f32))
        elif buckets is None:
            calls.append(SyncCall(
                "reduce_scatter", rs,
                padded_rows(shape[0], world) * _row_numel(shape), rs_dt))
    for bucket in buckets or ():
        calls.append(SyncCall("reduce_scatter", rs,
                              world * bucket_width(bucket, zshapes), rs_dt))
    calls.append(SyncCall("fold", None, 2 if model_axis else 1, f32))
    if buckets is None:
        calls += [SyncCall("allgather", ag, padded_rows(shapes[i][0], world)
                           // world * _row_numel(shapes[i]), dtypes[i])
                  for i in zero]
    else:
        dt = bucket_dtype([dtypes[i] for i in zero])
        calls += [SyncCall("allgather", ag, bucket_width(b, zshapes), dt)
                  for b in buckets]
    calls.append(SyncCall("fold", None, 1, f32))  # the loss
    return calls


def _bucketed_reduce(grads: list, zero_idx: list, items: list, comm,
                     sync: GradSyncConfig, world: int, ef_step=None) -> list:
    """Bucketed, pipelined reduce-scatter of the zero leaves' gradients
    (the reference's ``_bucketed_reduce``).  ``grads`` holds each local
    rank's leaf list; every consumed gradient is set to ``None``.
    ``ef_step(j, i, g)``, when given, returns the EF-compensated gradient
    of rank j's leaf i.  Returns each rank's ``{leaf: averaged float32
    shard}``.

    Each bucket's vector lays its segments block-major (block k holds
    rank k's shard rows of every segment, zero past the leaf's end): one
    buffer per bucket and rank, filled by copies (and casts to
    ``rs_dtype``) straight from the gradients, so no padded copy of a
    whole leaf is made; a leaf's gradient is dropped after its last
    segment.  The fold order of every element is its per-leaf one (it
    depends only on the block index), so the exact sync is bitwise the
    per-leaf sync; on the int8 wire the quantization groups differ.
    """
    dt = _DTYPES[sync.rs_dtype]
    shapes = [items[i][1] for i in zero_idx]
    buckets = grad_buckets(shapes, world, sync)
    last = _last_use(buckets)
    n = len(grads)
    sources: list[dict] = [{} for _ in range(n)]

    def vectors():
        for b, bucket in enumerate(buckets):
            width = bucket_width(bucket, shapes)
            vecs = []
            for j in range(n):
                vec, col = None, 0
                for li, lo, hi in bucket:
                    i = zero_idx[li]
                    src = sources[j].get(i)
                    if src is None:
                        g, grads[j][i] = grads[j][i], None
                        if ef_step is not None:
                            g = ef_step(j, i, g)
                        src = sources[j][i] = g.reshape(g.shape[0], -1)
                        del g
                    if vec is None:
                        vec = src.new_empty((world, width), dtype=dt)
                    ld, rn = src.shape
                    R = -(-ld // world)
                    dst = vec[:, col:col + (hi - lo) * rn].view(
                        world, hi - lo, rn)
                    for k in range(world):
                        rows = max(0, min(k * R + hi, ld) - (k * R + lo))
                        if rows:
                            dst[k, :rows].copy_(src[k * R + lo:
                                                    k * R + lo + rows])
                        if rows < hi - lo:
                            dst[k, rows:].zero_()  # the leaf's padding
                    col += (hi - lo) * rn
                vecs.append(vec.reshape(-1))
                del vec
                for li, _, _ in bucket:
                    if last[li] == b:
                        sources[j].pop(zero_idx[li], None)
            yield vecs
            del vecs

    outs = C.reduce_scatter_pipelined(vectors(), comm, spec=sync.rs_spec())
    red = []
    for j in range(n):
        own = torch.cat([o[j] for o in outs])
        for o in outs:
            o[j] = None  # this rank's bucket shards are in ``own`` now
        own = (own / world).to(torch.float32)
        per, off = {}, 0
        for li, i in enumerate(zero_idx):
            R = -(-shapes[li][0] // world)
            w = R * _row_numel(shapes[li])
            per[i] = own[off:off + w].reshape(R, *shapes[li][1:])
            off += w
        red.append(per)
    return red


def _bucketed_allgather(shards: list, zero_idx: list, items: list, comm,
                        sync: GradSyncConfig, world: int,
                        dtypes: list) -> Iterator[tuple[int, list]]:
    """Bucketed, pipelined allgather of the updated zero-leaf shards (the
    reference's ``_bucketed_allgather``), on the same bucket partition as
    the reduce.  ``shards`` holds each local rank's ``{leaf: shard}``
    (consumed: each shard is dropped once its last bucket is built);
    ``dtypes[i]`` is leaf i's parameter dtype.  Yields ``(leaf, [each
    rank's full leaf])`` in leaf order; each leaf is one ``torch.cat`` of
    its segments' columns of the gathered buckets, and a bucket is
    dropped after its last leaf.  Pure transport: bitwise the per-leaf
    allgather (mixed dtypes promote and cast back losslessly)."""
    shapes = [items[i][1] for i in zero_idx]
    buckets = grad_buckets(shapes, world, sync)
    last = _last_use(buckets)
    dt = bucket_dtype([dtypes[i] for i in zero_idx])
    n = len(shards)

    def vectors():
        for b, bucket in enumerate(buckets):
            vecs = []
            for j in range(n):
                parts = []
                for li, lo, hi in bucket:
                    rn = _row_numel(shapes[li])
                    flat = shards[j][zero_idx[li]].reshape(-1)
                    parts.append(flat[lo * rn:hi * rn].to(dt))
                vecs.append(torch.cat(parts))
                del parts
                for li, _, _ in bucket:
                    if last[li] == b:
                        shards[j].pop(zero_idx[li])
            yield vecs
            del vecs

    outs = C.allgather_pipelined(vectors(), comm, spec=sync.ag_spec())
    col = [0] * len(buckets)  # each bucket's next unread column
    for li, i in enumerate(zero_idx):
        rn = _row_numel(shapes[li])
        segs = [(b, lo, hi) for b, bucket in enumerate(buckets)
                for l2, lo, hi in bucket if l2 == li]
        full = []
        for j in range(n):
            cols = []
            for b, lo, hi in segs:
                w = (hi - lo) * rn
                cols.append(outs[b][j].reshape(world, -1)[
                    :, col[b]:col[b] + w])
            ld = shapes[li][0]
            leaf = torch.cat(cols, dim=1).reshape(-1, *shapes[li][1:])
            full.append(leaf[:ld].to(dtypes[i]))
        for b, lo, hi in segs:
            col[b] += (hi - lo) * rn
            if all(l2 <= li for l2, _, _ in buckets[b]):
                outs[b] = None
        yield i, full


def zero1_step(loss_and_grad: Callable, params: list, opt: list,
               batches: list, *, comm, opt_cfg: adamw.AdamWConfig,
               sync: GradSyncConfig, model_comm=None,
               model_split: Sequence[bool] | None = None):
    """One ZeRO-1 training step over the local ranks.

    ``params`` / ``opt`` / ``batches`` are per-local-rank lists (parameter
    trees, :class:`Zero1State`, batch dicts); ``loss_and_grad`` maps the
    lists of parameters and batches to the lists of losses and gradient
    trees (one backward per rank, or one over coupled ranks).  ``comm``
    is the data axis's: on a mesh it holds every rank, and each model
    column syncs over its own data-axis group.  Returns ``(params', opt',
    metrics)``.  Memory: at full width the old and new states of p ranks
    do not fit side by side, so the step rebinds the leaves of the
    parameter and moment trees it was given, leaf by leaf, and drops each
    gradient as soon as it is reduced.

    With tensor parallelism (``model_comm``, the model axis's, and
    ``model_split``, per leaf in flatten order whether its blocks are
    split over that axis) each rank's trees hold its blocks, and every
    model column syncs its blocks over its data-axis group:
    :func:`is_zero_leaf`, :func:`padded_rows` and the sync read the
    LOCAL block shapes (``embed``'s dim 0 is V / M rows on a rank).
    AdamW is elementwise, so the numbers are those of the global split.
    The grad norm is the global one: the split leaves' squares summed
    over the model axis too, the replicated ones (the same bits on every
    model rank) counted once.
    """
    world = comm.p
    losses, trees = loss_and_grad(params, batches)
    grads = [T.leaves(g) for g in trees]
    del trees  # the leaf lists alone hold the gradients now
    # paths, shapes and dtypes only: the old leaves must not outlive their
    # update
    flat = T.flatten(params[0])
    items = [(path, tuple(p.shape)) for path, p in flat]
    dtypes = [p.dtype for _, p in flat]
    del flat
    # the layout is :func:`sync_schedule`'s: the allreduce baseline
    # shards nothing, so every leaf takes the tiny path
    flags = zero_flags([shape for _, shape in items], world, sync)
    zero_idx = [i for i, f in enumerate(flags) if f]
    bucketed = sync.bucket_bytes is not None and bool(zero_idx)
    f32 = torch.float32
    use_ef = sync.uses_error_feedback and opt[0].ef is not None
    efs = [T.leaves(o.ef) for o in opt] if use_ef else None

    def ef_step(j, i, g):
        """Rank j's EF compensation of leaf i: keep the new rounding
        error, return the quantized gradient."""
        q, err = ef_quantize(g, efs[j][i], sync.quant_group)
        efs[j][i] = None
        T.assign(opt[j].ef, items[i][0], err)
        return q

    # --- reduce: shard big leaves (Algorithm 1), all-reduce tiny ones;
    # with EF, each rank compensates and quantizes its own gradient first
    # and keeps the new rounding error ---
    g_red = [[None] * len(items) for _ in params]
    for i, flag in enumerate(flags):
        if flag and bucketed:
            continue  # synced in buckets below
        gs = [g[i] for g in grads]
        for g in grads:
            g[i] = None  # free each leaf's gradients once reduced
        if flag:
            if use_ef:
                gs = [ef_step(j, i, g) for j, g in enumerate(gs)]
            out = reduce_scatter_leaf(gs, comm, sync, world)
        else:
            out = allreduce_leaf([g.to(f32) for g in gs], comm, world,
                                 native=sync.native_sums)
        del gs
        for j, o in enumerate(out):
            g_red[j][i] = o
    if bucketed:
        red = _bucketed_reduce(grads, zero_idx, items, comm, sync, world,
                               ef_step if use_ef else None)
        for j, per in enumerate(red):
            for i, o in per.items():
                g_red[j][i] = o
        del red

    # --- global grad norm: shards partition the reduced grad exactly, so
    # one all-reduce of the summed shard sq-norms plus the (replicated)
    # tiny-leaf sq-norms gives it ---
    if model_comm is None:
        shard_sq, tiny_sq = [], []
        for gr in g_red:
            dev = gr[0].device
            s = torch.zeros((), dtype=f32, device=dev)
            t = torch.zeros((), dtype=f32, device=dev)
            for g, flag in zip(gr, flags):
                if flag:
                    s = s + torch.sum(torch.square(g))
                else:
                    t = t + torch.sum(torch.square(g))
            shard_sq.append(s)
            tiny_sq.append(t)
        shard_sq = comm.fold_sum(shard_sq)
        gnorms = [torch.sqrt(s + t) for s, t in zip(shard_sq, tiny_sq)]
    else:
        gnorms = mesh_grad_norms(g_red, flags, model_split, comm,
                                 model_comm)

    # --- AdamW on shards, then allgather each updated leaf (bucketed:
    # every leaf's shard first, then the pipelined allgather) ---
    step = opt[0].step + 1
    dev = gnorms[0].device
    lr = adamw.lr_at(opt_cfg, step, dev)
    bc1, bc2 = adamw.bias_corrections(opt_cfg, step, dev)
    scales = [adamw.clip_scale_from_norm(opt_cfg, gn) for gn in gnorms]
    ms = [T.leaves(o.m) for o in opt]
    vs = [T.leaves(o.v) for o in opt]
    shards: list[dict] = [{} for _ in comm.ranks]
    for i, ((path, _), flag) in enumerate(zip(items, flags)):
        new_loc = []
        for j, rank in enumerate(comm.ranks):
            p = T.get(params[j], path)
            p_loc = local_rows(p, rank, world) if flag else p
            g = g_red[j][i] * scales[j]
            g_red[j][i] = None
            out, m2, v2 = adamw.adamw_update(opt_cfg, p_loc, g, ms[j][i],
                                             vs[j][i], lr=lr, bc1=bc1,
                                             bc2=bc2)
            ms[j][i] = vs[j][i] = None  # the old moments go with the leaf
            T.assign(opt[j].m, path, m2)
            T.assign(opt[j].v, path, v2)
            new_loc.append(out)
        if flag and bucketed:
            for j, val in enumerate(new_loc):
                shards[j][i] = val
            continue
        if flag:
            ld = items[i][1][0]
            new_loc = allgather_leaf(new_loc, ld, comm, sync)
        for j, val in enumerate(new_loc):
            T.assign(params[j], path, val)
    if bucketed:
        for i, full in _bucketed_allgather(shards, zero_idx, items, comm,
                                           sync, world, dtypes):
            for j, val in enumerate(full):
                T.assign(params[j], items[i][0], val)

    mloss = comm.fold_sum([l.detach().to(f32) for l in losses])
    metrics = {"loss": mloss[0] / world, "grad_norm": gnorms[0], "lr": lr}
    new_opt = [Zero1State(m=o.m, v=o.v, step=step, ef=o.ef) for o in opt]
    return params, new_opt, metrics


def mesh_grad_norms(grads: list, over_data: Sequence[bool],
                    over_model: Sequence[bool], comm, model_comm) -> list:
    """Every local rank's global grad norm on a ``D x M`` mesh from its
    gradient blocks (``grads``: per rank, per leaf): each leaf's squares
    summed over the axes it is split over (``over_data`` / ``over_model``,
    per leaf) and counted once over the others.  The data-split leaves'
    two sums (model-split or not) fold over the data axis in one call,
    the model-split total over the model axis in another: every rank
    gets the same bits."""
    f32 = torch.float32
    split_d, rest = [], []
    for g in grads:
        dev = g[0].device
        acc = [torch.zeros((), dtype=f32, device=dev) for _ in range(4)]
        for x, d, m in zip(g, over_data, over_model):
            k = (0 if d else 2) + (0 if m else 1)
            acc[k] = acc[k] + torch.sum(torch.square(x.to(f32)))
        split_d.append(torch.stack(acc[:2]))
        rest.append(acc[2:])
    split_d = comm.fold_sum(split_d)
    split_m = model_comm.fold_sum([a[0] + r[0]
                                   for a, r in zip(split_d, rest)])
    return [torch.sqrt(s + a[1] + r[1])
            for s, a, r in zip(split_m, split_d, rest)]


def init_zero1_state(params: dict, world: int, sync: GradSyncConfig
                     ) -> Zero1State:
    """One rank's zero optimizer state: zero leaves get their
    ``(ld_pad / world, *rest)`` fp32 shard, tiny leaves full fp32
    replicas (the reference's global state, cut to one rank's shard);
    the ``allreduce`` baseline (no ZeRO) gives every leaf full state.
    With the compressed sync and error feedback, every leaf also gets a
    zero fp32 EF residual of its own shape: this rank's full-leaf
    residual for zero leaves, a dummy for tiny ones (the reference's
    ``(world, *leaf)`` / ``(1, *leaf)`` state, cut to one rank's row)."""
    def mk(p):
        shape = tuple(p.shape)
        if sync.use_zero and is_zero_leaf(shape, world,
                                          sync.min_shard_numel):
            ld_pad = shape[0] + (-shape[0]) % world
            shape = (ld_pad // world, *shape[1:])
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def mk_ef(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    ef = T.map_leaves(mk_ef, params) if sync.uses_error_feedback else None
    return Zero1State(m=T.map_leaves(mk, params), v=T.map_leaves(mk, params),
                      step=0, ef=ef)


def resize_zero1_state(state: Zero1State, params: dict, new_world: int,
                       sync: GradSyncConfig) -> Zero1State:
    """Remap a GLOBAL (gathered) :class:`Zero1State` to a new data-parallel
    world size: the elastic reshard step (``ft.elastic``), the reference's
    ``resize_zero1_state``.

    The state is the checkpoint's host-side global view, numpy arrays:
    zero leaves' ``m`` / ``v`` are ``(ld_pad_old, *rest)`` (leading dim
    padded to the OLD world), tiny leaves full replicas, and ``ef`` holds
    ``(old_world, *leaf)`` residuals for zero leaves (one full-leaf
    residual per rank) and ``(1, *leaf)`` dummies for tiny ones.  Only
    each leaf's true shape (from ``params``: tensors or arrays) and the
    NEW world matter:

    * ``m`` / ``v``: drop the old padding rows (``[:ld]``: padded rows
      are zero by construction, because padded gradient rows are zero,
      so the moments never leave zero there) and re-pad to the new
      world's multiple.  A leaf whose :func:`is_zero_leaf` flag flips
      between worlds takes the same slice and pad (tiny leaves store
      exactly ``ld`` rows).  The round trip p→p′→p is lossless.
    * ``ef``: resized by MASS CONSERVATION: row 0 of the new ``(new_world,
      *leaf)`` state is the sum over all old rank rows, the other rows
      zero.  Each rank adds its residual into its local gradient before
      quantization and the reduce-scatter SUMS ranks, so only the total
      ``sum_r ef_r`` enters the reduced gradient; per-rank attribution
      carries no information across a resize (the rank set changed).
      Shrink and grow are the same operation, and the residual mass
      survives p→p′→p exactly.  State with residuals under a sync without
      error feedback raises rather than drop their mass.
    * ``step``: unchanged.
    """
    if new_world < 1:
        raise ValueError(f"new_world must be >= 1, got {new_world}")
    shapes = {path: tuple(p.shape) for path, p in T.flatten(params)}

    def zero(shape):
        return sync.use_zero and is_zero_leaf(shape, new_world,
                                              sync.min_shard_numel)

    def rs_mv(path, mv):
        shape = shapes[path]
        if not shape:
            return np.asarray(mv)  # scalar leaf: always replicated
        ld = shape[0]
        arr = np.asarray(mv)[:ld]
        if zero(shape):
            pad = (-ld) % new_world
            if pad:
                arr = np.concatenate(
                    [arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])
        return arr

    def rs_ef(path, e):
        shape = shapes[path]
        out = np.zeros((new_world if zero(shape) else 1, *shape), np.float32)
        out[0] = np.asarray(e, np.float32).sum(axis=0)
        return out

    def remap(fn, tree):
        return T.unflatten((path, fn(path, leaf))
                           for path, leaf in T.flatten(tree))

    new_ef = None
    if state.ef is not None:
        if not sync.uses_error_feedback:
            raise ValueError(
                "state carries EF residuals but sync does not use error "
                "feedback — resize would silently drop residual mass")
        new_ef = remap(rs_ef, state.ef)
    return Zero1State(m=remap(rs_mv, state.m), v=remap(rs_mv, state.v),
                      step=state.step, ef=new_ef)
