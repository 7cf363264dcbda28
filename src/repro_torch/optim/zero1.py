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
``DistComm``.  Ported: the per-leaf branches of the reference's
``zero1_step`` with the circulant impl, exact or with the reduce-scatter
on the int8 wire (``wire_dtype="int8"``), whose quantization error an
EF-SGD residual per rank and leaf carries into the next step
(``error_feedback``, on by default).  The allgather is never on the
wire: parameter shards reassemble exactly.  Not ported yet (ROADMAP.md
queue 1 items 9 and 14): the bucketed, pipelined sync and the ring /
xla / allreduce impls, which raise when asked for.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import tree as T
from ..core import collectives as C
from ..core.spec import CollectiveSpec
from ..kernels.ops import dequantize_blocks, quantize_blocks
from ..kernels.quantize import DEFAULT_GROUP
from . import adamw

_IMPLS = ("circulant", "ring", "xla", "allreduce")


@dataclass(frozen=True)
class GradSyncConfig:
    """How zero1 synchronizes gradients and re-gathers parameter shards
    (the reference's ``repro.optim.zero1.GradSyncConfig``, as far as it
    is ported).  It compiles to :class:`CollectiveSpec` objects
    (:meth:`rs_spec` / :meth:`ag_spec`).

    ``impl`` must be ``'circulant'`` (the others raise); ``schedule`` any
    Corollary-2 schedule.  ``wire_dtype`` ``None`` (exact) or ``'int8'``:
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
    the gradients lie on a card).  ``bucket_bytes`` is not ported and
    raises when set (ROADMAP.md queue 1 item 9).
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
        if self.impl != "circulant":
            raise NotImplementedError(
                f"grad-sync impl {self.impl!r} is not ported yet (ROADMAP.md "
                f"queue 1 item 14); use 'circulant'")
        if self.rs_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"rs_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.rs_dtype!r}")
        if self.rs_dtype != "float32" and self.wire is not None:
            raise ValueError(
                f"rs_dtype={self.rs_dtype!r} with wire_dtype={self.wire!r}: "
                f"the int8 wire quantizes float32 gradients; a narrower "
                f"payload would only round them once more first")
        if self.bucket_bytes is not None:
            raise NotImplementedError(
                "bucketed, pipelined grad sync is not ported yet "
                "(ROADMAP.md queue 1 item 9)")

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

    def rs_spec(self) -> CollectiveSpec:
        """The reduce-scatter :class:`CollectiveSpec` this config means."""
        return CollectiveSpec(
            kind="circulant", schedule=self.schedule,
            use_fused_kernel=self.use_fused_kernel,
            wire_dtype=self.wire if self.wire == "int8" else None,
            wire_group=self.quant_group)

    def ag_spec(self) -> CollectiveSpec:
        """The allgather's spec: parameter shards must reassemble exactly,
        so the wire format never applies."""
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


def _pad_lead(x: torch.Tensor, world: int, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` with its leading dim zero-padded to a
    multiple of ``world``, in one new tensor (at full width a cast and a
    pad as two copies would double the largest transient)."""
    ld = x.shape[0]
    out = x.new_zeros((ld + (-ld) % world, *x.shape[1:]), dtype=dtype)
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
    off, rows = shard_offset(ld + (-ld) % world, rank, world)
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
    dt = getattr(torch, sync.rs_dtype)
    out = C.reduce_scatter([_pad_lead(g, world, dt) for g in gs], comm,
                           spec=sync.rs_spec())
    return [(o / world).to(torch.float32) for o in out]


def allgather_leaf(shards: Sequence[torch.Tensor], ld: int, comm,
                   sync: GradSyncConfig) -> list[torch.Tensor]:
    """Inverse: AG along dim 0 (``sync.ag_spec()``, never on the wire),
    then drop the padding rows."""
    out = C.allgather(shards, comm, spec=sync.ag_spec())
    return [o[:ld] for o in out]


def allreduce_leaf(gs: Sequence[torch.Tensor], comm, world: int
                   ) -> list[torch.Tensor]:
    """Tiny-leaf path: replicated mean over a plain all-reduce."""
    return [s / world for s in comm.all_reduce_sum(gs)]


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


def zero1_step(loss_and_grad: Callable, params: list, opt: list,
               batches: list, *, comm, opt_cfg: adamw.AdamWConfig,
               sync: GradSyncConfig):
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
    """
    world = comm.p
    losses, trees = loss_and_grad(params, batches)
    grads = [T.leaves(g) for g in trees]
    del trees  # the leaf lists alone hold the gradients now
    # paths and shapes only: the old leaves must not outlive their update
    items = [(path, tuple(p.shape)) for path, p in T.flatten(params[0])]
    flags = [is_zero_leaf(shape, world, sync.min_shard_numel)
             for _, shape in items]
    f32 = torch.float32
    use_ef = sync.uses_error_feedback and opt[0].ef is not None
    efs = [T.leaves(o.ef) for o in opt] if use_ef else None

    # --- reduce: shard big leaves (Algorithm 1), all-reduce tiny ones;
    # with EF, each rank compensates and quantizes its own gradient first
    # and keeps the new rounding error ---
    g_red = [[None] * len(items) for _ in params]
    for i, flag in enumerate(flags):
        gs = [g[i] for g in grads]
        for g in grads:
            g[i] = None  # free each leaf's gradients once reduced
        if flag:
            if use_ef:
                for j in range(len(gs)):
                    gs[j], err = ef_quantize(gs[j], efs[j][i],
                                             sync.quant_group)
                    efs[j][i] = None
                    T.assign(opt[j].ef, items[i][0], err)
            out = reduce_scatter_leaf(gs, comm, sync, world)
        else:
            out = allreduce_leaf([g.to(f32) for g in gs], comm, world)
        del gs
        for j, o in enumerate(out):
            g_red[j][i] = o

    # --- global grad norm: shards partition the reduced grad exactly, so
    # one all-reduce of the summed shard sq-norms plus the (replicated)
    # tiny-leaf sq-norms gives it ---
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
    shard_sq = comm.all_reduce_sum(shard_sq)
    gnorms = [torch.sqrt(s + t) for s, t in zip(shard_sq, tiny_sq)]

    # --- AdamW on shards, then allgather each updated leaf ---
    step = opt[0].step + 1
    dev = gnorms[0].device
    lr = adamw.lr_at(opt_cfg, step, dev)
    bc1, bc2 = adamw.bias_corrections(opt_cfg, step, dev)
    scales = [adamw.clip_scale_from_norm(opt_cfg, gn) for gn in gnorms]
    ms = [T.leaves(o.m) for o in opt]
    vs = [T.leaves(o.v) for o in opt]
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
        if flag:
            ld = items[i][1][0]
            new_loc = allgather_leaf(new_loc, ld, comm, sync)
        for j, val in enumerate(new_loc):
            T.assign(params[j], path, val)

    mloss = comm.all_reduce_sum([l.detach().to(f32) for l in losses])
    metrics = {"loss": mloss[0] / world, "grad_norm": gnorms[0], "lr": lr}
    new_opt = [Zero1State(m=o.m, v=o.v, step=step, ef=o.ef) for o in opt]
    return params, new_opt, metrics


def init_zero1_state(params: dict, world: int, sync: GradSyncConfig
                     ) -> Zero1State:
    """One rank's zero optimizer state: zero leaves get their
    ``(ld_pad / world, *rest)`` fp32 shard, tiny leaves full fp32
    replicas (the reference's global state, cut to one rank's shard).
    With the compressed sync and error feedback, every leaf also gets a
    zero fp32 EF residual of its own shape: this rank's full-leaf
    residual for zero leaves, a dummy for tiny ones (the reference's
    ``(world, *leaf)`` / ``(1, *leaf)`` state, cut to one rank's row)."""
    def mk(p):
        shape = tuple(p.shape)
        if is_zero_leaf(shape, world, sync.min_shard_numel):
            ld_pad = shape[0] + (-shape[0]) % world
            shape = (ld_pad // world, *shape[1:])
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def mk_ef(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    ef = T.map_leaves(mk_ef, params) if sync.uses_error_feedback else None
    return Zero1State(m=T.map_leaves(mk, params), v=T.map_leaves(mk, params),
                      step=0, ef=ef)
