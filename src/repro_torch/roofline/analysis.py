"""Roofline terms of a cell on the H100, ported from
``repro/roofline/analysis.py``.

Three terms per cell, all in seconds per step per chip:

  compute    = flops_per_chip / PEAK_FLOPS              (989.4 TFLOP/s)
  memory     = hbm_bytes_per_chip / HBM_BW              (3.35 TB/s)
  collective = collective_bytes_per_chip / LINK_BW      (450 GB/s)

The constants are the H100 SXM's, from NVIDIA's H100 Tensor Core GPU
data sheet: the dense bf16 tensor-core peak (the sheet's 1,979 TFLOP/s
is with 2:4 sparsity), the HBM3 rate, and NVLink's 900 GB/s counted
both ways, 450 GB/s each way.

The reference reads its compute and memory terms from XLA's
``cost_analysis`` and its collective bytes from the compiled HLO; both
are JAX's and are not ported.  Here :func:`analyze` takes the compute
and memory terms from ``analytic.analytic_cell`` and the collective
term from the plans themselves: :func:`sync_counts` counts, from the
``core/plan.py`` plans of the calls ``optim/zero1.sync_schedule`` lays
out for a ZeRO-1 step, without running anything, the exchanges, bytes
and native calls of one step's gradient and parameter sync.  Its ``bytes``, ``exchanges`` and
``natives`` are what ``comm.bytes``, ``comm.exchanges`` and
``comm.natives`` add over that step.  :func:`tp_counts` does the same
for a tensor-parallel or fsdp_auto step on a ``D x M`` mesh, on both
axes: the data-axis sync laid out on each rank's blocks, and the
model-axis calls of the hooks (and fsdp_auto's data-axis gathers),
counted by running the model's own forward and backward on ``meta``
tensors of the blocks' shapes (no data, no device), remat's recompute
included.

The port's rule for where a rank runs (the reference's meshes had one
chip per rank):

* one rank per card (``DistComm`` over NCCL): the card's terms are one
  rank's (``CellSpec(n_chips=p, ...)``), and the sync's bytes, the
  exchanges' and the native calls' volume, cross NVLink: the
  collective term.
* ``p`` virtual ranks on one card (``LocalComm``): the card runs every
  rank's work, so its compute and memory terms are ``p`` times one
  rank's, and an exchange is a copy inside the card's HBM, not a link
  transfer: ``comm.bytes`` (with the native calls' volume) is charged to
  the memory term as one read and one write, and the collective term is
  0.

``MODEL_FLOPS`` = 6·N·D for training cells (N = total params dense /
active params MoE; D = tokens per chip per step) and 2·N·D for
inference cells: the useful-FLOPs yardstick.  A measured cell also
carries ``mfu``: (model FLOPs / peak) / measured seconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import tree as T
from ..core.plan import plan
from ..models import leaf_dtype, param_shapes
from ..optim.zero1 import sync_schedule
from .analytic import analytic_cell

PEAK_FLOPS = 989.4e12     # dense bf16 / chip (H100 SXM data sheet)
HBM_BW = 3.35e12          # B/s
LINK_BW = 450e9           # B/s per direction, NVLink 4

#: the HLO type names the reference's byte audit keys its dtypes by
_DTYPE_NAMES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
                "int8": "s8", "int32": "s32"}


@dataclass
class CollectiveStats:
    """Per-op counts and bytes of a step's sync (the reference's
    ``hlo_budget.CollectiveStats``): ``bytes_by_op`` the bytes a rank's
    link carries, ``raw_bytes_by_op`` / ``raw_bytes_by_dtype`` the
    payloads' own bytes (the int8 wire's codes as ``s8``, its scales as
    ``f32``)."""
    ops: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)
    raw_bytes_by_op: dict = field(default_factory=dict)
    raw_bytes_by_dtype: dict = field(default_factory=dict)

    def add(self, op: str, eff, raw: dict) -> None:
        """One call of ``op`` moving ``eff`` link bytes, its payload
        ``raw`` bytes by dtype name."""
        self.ops[op] = self.ops.get(op, 0) + 1
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + eff
        for dt, nb in raw.items():
            self.raw_bytes_by_op[op] = self.raw_bytes_by_op.get(op, 0) + nb
            self.raw_bytes_by_dtype[dt] = (
                self.raw_bytes_by_dtype.get(dt, 0) + nb)


@dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_per_chip: float
    collectives: CollectiveStats | None = None
    measured_s: float | None = None

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """The least time the chip could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return (self.model_flops_per_chip / self.flops_per_chip
                if self.flops_per_chip else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term-bound step time that is useful
        compute: (MODEL_FLOPS/peak) / max-term.  1.0 = perfectly
        compute-bound with zero waste."""
        t_star = max(self.t_compute, self.t_memory, self.t_collective)
        if t_star == 0:
            return 0.0
        return (self.model_flops_per_chip / PEAK_FLOPS) / t_star

    @property
    def mfu(self) -> float | None:
        """(MODEL_FLOPS/peak) / measured seconds; ``None`` unmeasured."""
        if self.measured_s is None:
            return None
        return (self.model_flops_per_chip / PEAK_FLOPS) / self.measured_s

    def as_dict(self) -> dict:
        d = {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "model_flops_per_chip": self.model_flops_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
        if self.collectives:
            d["collective_ops"] = self.collectives.ops
            d["collective_bytes_by_op"] = self.collectives.bytes_by_op
            d["collective_bytes_by_dtype"] = \
                self.collectives.raw_bytes_by_dtype
        if self.measured_s is not None:
            d["measured_s"] = self.measured_s
            d["bound_s"] = self.t_bound
            d["measured_over_bound"] = self.measured_s / self.t_bound
            d["mfu"] = self.mfu
        return d


def model_flops(cfg, tokens_per_chip: float, training: bool) -> float:
    """6·N·D (train) or 2·N·D (inference) with N = active params."""
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    return (6.0 if training else 2.0) * n * tokens_per_chip


# ---------------------------------------------------------------------------
# The sync's bytes, counted from the plans
# ---------------------------------------------------------------------------

@dataclass
class SyncCount:
    """One ZeRO-1 step's sync as the plans lay it out, for the ``ranks``
    ranks one process holds (``len(comm.ranks)``: p on a ``LocalComm``,
    1 on a ``DistComm``).  ``exchanges``, ``bytes`` and ``natives`` are
    what ``comm.exchanges``, ``comm.bytes`` and ``comm.natives`` add over
    the step; ``native_bytes`` is the volume the native calls move
    (``comm.bytes`` counts none of it); ``stats`` splits both by op and,
    for the payloads, by dtype."""
    exchanges: int
    natives: int
    bytes: int
    native_bytes: float
    stats: CollectiveStats

    @property
    def link_bytes(self) -> float:
        """Everything this process sends: the exchanges' and the native
        calls' bytes."""
        return self.bytes + self.native_bytes


def combined(*counts: SyncCount) -> SyncCount:
    """Several :class:`SyncCount` (a step's axes) as one: every field
    summed."""
    stats = CollectiveStats()
    for c in counts:
        for src, dst in ((c.stats.ops, stats.ops),
                         (c.stats.bytes_by_op, stats.bytes_by_op),
                         (c.stats.raw_bytes_by_op, stats.raw_bytes_by_op),
                         (c.stats.raw_bytes_by_dtype,
                          stats.raw_bytes_by_dtype)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
    return SyncCount(exchanges=sum(c.exchanges for c in counts),
                     natives=sum(c.natives for c in counts),
                     bytes=sum(c.bytes for c in counts),
                     native_bytes=sum(c.native_bytes for c in counts),
                     stats=stats)


def _dt(dtype) -> str:
    return _DTYPE_NAMES[str(dtype).removeprefix("torch.")]


def _rs_blocks(pl) -> list[int]:
    """Blocks one rank sends in each reduce-scatter round of ``pl``
    (empty for the native call)."""
    if pl.backend == "ring":
        return [1] * (pl.p - 1)
    if pl.backend == "recursive_halving":
        return [pl.p >> (k + 1) for k in range(pl.p.bit_length() - 1)]
    return [len(b) for b in pl.rs_send_blocks]


class _Tally:
    """Adds up a step's calls for one rank; ``count`` scales the bytes to
    the process's ranks."""

    def __init__(self, p: int):
        self.p = p
        self.exchanges = self.natives = 0
        self.bytes = 0
        self.native_bytes = 0.0
        self.stats = CollectiveStats()

    def exchange(self, raw: dict) -> None:
        self.exchanges += 1
        nb = sum(raw.values())
        self.bytes += nb
        self.stats.add("collective-permute", nb, raw)

    def native(self, op: str, eff: float, raw: dict) -> None:
        self.natives += 1
        self.native_bytes += eff
        self.stats.add(op, eff, raw)

    def reduce_scatter(self, pl, numel: int, itemsize: int, dtype: str,
                       wire_group: int | None) -> None:
        """One reduce-scatter of a ``numel``-element payload a rank
        (``p`` equal blocks) on plan ``pl``."""
        p = self.p
        cols = numel // p
        if pl.backend == "xla":
            self.native("reduce-scatter", (p - 1) * cols * itemsize,
                        {dtype: numel * itemsize})
            return
        if wire_group is None:
            for nb in _rs_blocks(pl):
                self.exchange({dtype: nb * cols * itemsize})
            return
        g = min(wire_group, cols)
        padded = -(-cols // g) * g
        for nb in _rs_blocks(pl):
            self.exchange({"s8": nb * padded, "f32": nb * 4 * (padded // g)})

    def allgather(self, pl, cols: int, itemsize: int, dtype: str) -> None:
        """One allgather of a ``cols``-element block a rank on ``pl``."""
        if pl.backend == "xla":
            self.native("all-gather", (self.p - 1) * cols * itemsize,
                        {dtype: cols * itemsize})
            return
        for k in range(len(pl.ag_rounds)):
            nb = len(pl.ag_send_blocks[k])
            self.exchange({dtype: nb * cols * itemsize})

    def all_reduce(self, nbytes: int, dtype: str) -> None:
        """The native all-reduce: a reduce-scatter and an allgather of
        p blocks, p - 1 of each a rank."""
        self.native("all-reduce", 2 * (self.p - 1) * nbytes / self.p,
                    {dtype: nbytes})

    def fold(self, nbytes: int, dtype: str) -> None:
        """``comm.fold_sum``: every rank's tensor gathered to every rank
        (``DistComm``), p - 1 copies of it a rank."""
        self.native("all-gather", (self.p - 1) * nbytes, {dtype: nbytes})

    def count(self, ranks: int) -> SyncCount:
        s = self.stats
        scaled = CollectiveStats(
            ops=dict(s.ops),
            bytes_by_op={k: v * ranks for k, v in s.bytes_by_op.items()},
            raw_bytes_by_op={k: v * ranks
                             for k, v in s.raw_bytes_by_op.items()},
            raw_bytes_by_dtype={k: v * ranks
                                for k, v in s.raw_bytes_by_dtype.items()})
        return SyncCount(exchanges=self.exchanges, natives=self.natives,
                         bytes=self.bytes * ranks,
                         native_bytes=self.native_bytes * ranks,
                         stats=scaled)


def sync_counts(cfg, sync, world: int, *, ranks: int = 1) -> SyncCount:
    """One ``optim/zero1.zero1_step``'s sync of ``cfg``'s parameters
    over ``world`` data ranks under ``sync`` (a ``GradSyncConfig``),
    counted from the plans alone: the step's calls as
    ``zero1.sync_schedule`` lays them out from the parameter shapes and
    dtypes, each reduce-scatter and allgather on ``core.plan.plan`` of
    its spec (the blocks each round sends).  Nothing is run.

    Every mode the launcher runs: the circulant sync exact or on the
    int8 wire (with or without EF: the residual changes what is sent,
    not its size; the wire sends ``[codes | scales]`` rows, counted as
    ``s8`` and ``f32``), per leaf or bucketed, and the ring, xla and
    allreduce baselines.

    Native calls add nothing to ``bytes``; their volume is the paper's
    count of ``p - 1`` blocks a rank: a reduce-scatter of n bytes moves
    (p-1)·n/p, an allgather of an n-byte block (p-1)·n, an all-reduce of
    n bytes 2·(p-1)·n/p, and a fold of n bytes, an allgather of the
    whole tensor, (p-1)·n."""
    tally = _Tally(world)
    shapes, dtypes = [], []
    for path, shape in T.flatten(param_shapes(cfg)):
        shapes.append(tuple(shape))
        dtypes.append(leaf_dtype(cfg, path))
    for c in sync_schedule(shapes, dtypes, world, sync):
        size, name = c.dtype.itemsize, _dt(c.dtype)
        if c.op == "fold":
            tally.fold(c.numel * size, name)
        elif c.op == "all_reduce":
            tally.all_reduce(c.numel * size, name)
        elif c.op == "reduce_scatter":
            group = c.spec.wire_group if c.spec.wire_dtype == "int8" else None
            tally.reduce_scatter(plan(c.spec, p=world), c.numel, size, name,
                                 group)
        else:
            tally.allgather(plan(c.spec, p=world), c.numel, size, name)
    return tally.count(ranks)


class _Recorder:
    """A mesh axis's communicator that notes every native call (op, one
    rank's elements, dtype) and passes it on."""

    def __init__(self, comm):
        self._comm, self.calls = comm, []
        self.p, self.ranks = comm.p, comm.ranks

    def _note(self, op, xs):
        self.calls.append((op, xs[0].numel(), xs[0].dtype))

    def all_reduce_sum(self, xs):
        self._note("all_reduce", xs)
        return self._comm.all_reduce_sum(xs)

    def all_gather(self, xs):
        self._note("allgather", xs)
        return self._comm.all_gather(xs)

    def reduce_scatter_sum(self, xs):
        self._note("native_rs", xs)
        return self._comm.reduce_scatter_sum(xs)

    def all_to_all(self, xs):
        self._note("all_to_all", xs)
        return self._comm.all_to_all(xs)

    def fold_sum(self, xs):
        self._note("fold", xs)
        return self._comm.fold_sum(xs)


def model_calls(cfg, layout, *, batch: int, seq: int,
                remat: bool = True, pooled: bool = False) -> dict:
    """The native calls one tensor-parallel step's forward and backward
    make on each axis (``"data"``: fsdp_auto's gathers of the leaves
    split over it and their reduce-scatters, and with ``pooled`` the MoE
    pool's; ``"model"``: the hooks'), as ``(op, elements a rank, dtype)``
    lists: the family's ``loss_fn_tp`` run on a ``LocalMesh`` of
    ``layout.mesh``'s shape with ``meta`` tensors of every rank's blocks
    and batch (``batch`` global rows of ``seq`` tokens, the VLM's image
    embeddings; the encoder-decoder's ``seq`` frames and
    ``min(dec_len, seq)`` tokens, as ``data.for_model`` draws them), then
    one backward of the ranks' losses."""
    from ..comm import LocalMesh
    from ..models import sharding as shd
    from ..models.layers import dtype_of
    from ..models.registry import family_module
    d, m = layout.mesh.axis_sizes
    mesh = LocalMesh((d, m), layout.mesh.axis_names)
    rec = {a: _Recorder(mesh.axis(a)) for a in layout.mesh.axis_names}
    tp = shd.TensorParallel(axis=shd.ModelAxis(rec["model"], layout.recipe),
                            data=rec["data"], layout=layout, pooled=pooled)
    meta = torch.device("meta")
    params = [T.unflatten((path, torch.empty(
        ll.block, dtype=leaf_dtype(cfg, path), device=meta,
        requires_grad=True)) for path, ll in T.flatten(layout.leaves))
        for _ in range(d * m)]
    n_tok = min(cfg.dec_len, seq) if cfg.family == "encdec" else seq
    tok = torch.empty((batch // d, n_tok), dtype=torch.long, device=meta)
    one = {"tokens": tok, "targets": tok}
    if cfg.family == "encdec":
        one["frames"] = torch.empty((batch // d, seq, cfg.d_model),
                                    dtype=torch.float32, device=meta)
    if cfg.family == "vlm":
        one["image_embeds"] = torch.empty(
            (batch // d, cfg.n_image_tokens, cfg.d_model),
            dtype=dtype_of(cfg), device=meta)
    losses = family_module(cfg).loss_fn_tp(params, cfg, [one] * (d * m),
                                           tp, remat)
    total = losses[0]
    for loss in losses[1:]:
        total = total + loss
    torch.autograd.grad(total, [x for p in params for x in T.leaves(p)])
    return {a: r.calls for a, r in rec.items()}


def tp_counts(cfg, layout, *, mode: str, batch: int, seq: int, sync=None,
              ranks: int = 1) -> dict:
    """One tensor-parallel step's calls on each axis of ``layout``'s mesh
    (``models.sharding.TPLayout``) as ``{"data": SyncCount, "model":
    SyncCount}``, what ``comm.bytes`` / ``exchanges`` / ``natives`` of
    each axis's communicator add over the step, for a process holding
    ``ranks`` ranks.  Each has :func:`model_calls`'s, and ``mode``'s own:
    zero1's data-axis sync of every rank's blocks (``sync_schedule`` on
    their shapes, the grad norm's fold of two sums, on the plans of
    ``sync``) and the norm's model-axis fold; fsdp_auto's all-reduce of
    every leaf not split over the data axes (its gradient, in the
    parameter's dtype), the norm's folds on both axes and the loss's."""
    d, m = layout.mesh.axis_sizes
    tally = {"data": _Tally(d), "model": _Tally(m)}
    calls = model_calls(cfg, layout, batch=batch, seq=seq,
                        pooled=mode == "fsdp_auto")
    leaves = T.flatten(layout.leaves)
    f32 = torch.float32
    if mode == "zero1":
        shapes = [ll.block for _, ll in leaves]
        dtypes = [leaf_dtype(cfg, path) for path, _ in leaves]
        for c in sync_schedule(shapes, dtypes, d, sync, model_axis=True):
            calls["data"].append(
                (c.op, c.numel, c.dtype) if c.spec is None else
                (c.op, c.numel, c.dtype, c.spec))
        calls["model"].append(("fold", 1, f32))
    elif mode == "fsdp_auto":
        for path, ll in leaves:
            if ll.data is None:
                n = 1
                for x in ll.block:
                    n *= x
                calls["data"].append(("all_reduce", n,
                                      leaf_dtype(cfg, path)))
        calls["data"] += [("fold", 2, f32), ("fold", 1, f32)]
        calls["model"].append(("fold", 1, f32))
    else:
        raise ValueError(f"mode {mode!r} has no tensor-parallel step")
    for axis, t in tally.items():
        for call in calls[axis]:
            op, numel, dtype = call[:3]
            size, name = dtype.itemsize, _dt(dtype)
            if op == "fold":
                t.fold(numel * size, name)
            elif op == "all_reduce":
                t.all_reduce(numel * size, name)
            elif op == "native_rs":
                t.native("reduce-scatter", (t.p - 1) * numel * size / t.p,
                         {name: numel * size})
            elif op == "all_to_all":
                t.native("all-to-all", (t.p - 1) * numel * size / t.p,
                         {name: numel * size})
            elif op == "allgather" and len(call) == 3:
                t.native("all-gather", (t.p - 1) * numel * size,
                         {name: numel * size})
            elif op == "reduce_scatter":
                group = (call[3].wire_group
                         if call[3].wire_dtype == "int8" else None)
                t.reduce_scatter(plan(call[3], p=t.p), numel, size, name,
                                 group)
            else:
                t.allgather(plan(call[3], p=t.p), numel, size, name)
    return {axis: t.count(ranks) for axis, t in tally.items()}


# ---------------------------------------------------------------------------
# A cell's roofline
# ---------------------------------------------------------------------------

def tokens_global(cfg, cell) -> int:
    """Tokens the cell's step processes, all chips: ``batch · seq``
    (train, prefill; an encoder-decoder's decoder tokens), ``batch`` for
    a decode step (one new token per sequence), as the reference's dry
    run counts them."""
    if cell.kind == "decode":
        return cell.batch
    if cfg.family == "encdec":
        return cell.batch * min(cfg.dec_len, cell.seq)
    return cell.batch * cell.seq


def analyze(cfg, cell, *, sync: SyncCount | None = None,
            local: bool = False, measured_s: float | None = None
            ) -> Roofline:
    """The :class:`Roofline` of one chip running ``cell``.

    ``local=False``: one rank per chip (the reference's meshes, and
    ``DistComm`` worlds): the analytic per-chip terms, and the
    collective term from ``sync`` (one rank's :class:`SyncCount`,
    ``ranks=1``; its exchanges' and native calls' bytes).  ``local=True``:
    the ``cell.n_chips`` ranks are virtual ranks of one card (a
    ``LocalComm``): the card's compute and memory terms are
    ``n_chips`` times one rank's, ``sync`` (counted with ``ranks=p``:
    ``comm.bytes`` of the whole process, and the native calls' volume)
    is charged to the memory term as one read and one write, and the
    collective term is 0.
    ``measured_s``: the step's measured seconds (gives ``mfu``)."""
    ana = analytic_cell(cfg, cell)
    training = cell.kind == "train"
    n = cell.n_chips if local else 1
    tokens = tokens_global(cfg, cell) / cell.n_chips * n
    hbm = ana["hbm_bytes_per_chip"] * n
    coll = 0.0
    if sync is not None:
        if local:
            hbm += 2 * sync.link_bytes
        else:
            coll = float(sync.link_bytes)
    return Roofline(
        flops_per_chip=ana["flops_per_chip"] * n,
        hbm_bytes_per_chip=hbm,
        collective_bytes_per_chip=coll,
        model_flops_per_chip=model_flops(cfg, tokens, training),
        collectives=sync.stats if sync is not None else None,
        measured_s=measured_s)
