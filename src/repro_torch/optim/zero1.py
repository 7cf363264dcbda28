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
``DistComm``.  Ported: the per-leaf, uncompressed branch of the
reference's ``zero1_step`` with ``impl="circulant"``.  Not ported yet
(ROADMAP.md queue 1 items 6 and 9): the int8 wire with EF-SGD residuals
and the bucketed, pipelined sync — their fields raise when set.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import tree as T
from ..core import collectives as C
from ..core.spec import CollectiveSpec
from . import adamw

_IMPLS = ("circulant", "ring", "xla", "allreduce")


@dataclass(frozen=True)
class GradSyncConfig:
    """How zero1 synchronizes gradients and re-gathers parameter shards
    (the reference's ``repro.optim.zero1.GradSyncConfig``, as far as it
    is ported).

    ``impl`` must be ``'circulant'`` (the others raise); ``schedule`` any
    Corollary-2 schedule; ``min_shard_numel`` the size below which a leaf
    stays replicated; ``use_fused_kernel`` routes every reduce-scatter
    round through the ``fused_round`` kernel (``None`` = auto: on when
    the gradients lie on a card).  The reduce-scatter payload is float32
    (the reference's default ``rs_dtype``).  ``wire_dtype`` (int8 wire)
    and ``bucket_bytes`` are not ported and raise when set; the wire's
    ``compress`` / ``error_feedback`` / ``quant_group`` fields come with
    it (ROADMAP.md queue 1 item 6).
    """

    impl: str = "circulant"
    schedule: str = "halving"
    wire_dtype: str | None = None
    min_shard_numel: int = 1024
    use_fused_kernel: bool | None = None
    bucket_bytes: int | None = None

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown grad-sync impl {self.impl!r}; "
                             f"have {_IMPLS}")
        if self.impl != "circulant":
            raise NotImplementedError(
                f"grad-sync impl {self.impl!r} is not ported yet (ROADMAP.md "
                f"queue 1 item 14); use 'circulant'")
        if self.wire_dtype is not None:
            raise NotImplementedError(
                "the int8 wire with EF-SGD residuals is not ported yet "
                "(ROADMAP.md queue 1 item 6)")
        if self.bucket_bytes is not None:
            raise NotImplementedError(
                "bucketed, pipelined grad sync is not ported yet "
                "(ROADMAP.md queue 1 item 9)")

    def spec(self) -> CollectiveSpec:
        """The :class:`CollectiveSpec` of both phases: the reduce-scatter
        and the allgather share one plan until the int8 wire, whose fields
        set them apart, is ported."""
        return CollectiveSpec(kind="circulant", schedule=self.schedule,
                              use_fused_kernel=self.use_fused_kernel)


class Zero1State(NamedTuple):
    """One rank's ZeRO-1 optimizer state: AdamW moments holding only this
    rank's 1/world shard for zero leaves (full for tiny leaves), as
    trees mirroring the parameters, and the number of steps taken."""
    m: dict
    v: dict
    step: int


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
    """Cast to float32, RS along dim 0 on the cached plan; returns each
    local rank's averaged shard."""
    out = C.reduce_scatter([_pad_lead(g, world, torch.float32) for g in gs],
                           comm, spec=sync.spec())
    return [o / world for o in out]


def allgather_leaf(shards: Sequence[torch.Tensor], ld: int, comm,
                   sync: GradSyncConfig) -> list[torch.Tensor]:
    """Inverse: AG along dim 0, then drop the padding rows."""
    out = C.allgather(shards, comm, spec=sync.spec())
    return [o[:ld] for o in out]


def allreduce_leaf(gs: Sequence[torch.Tensor], comm, world: int
                   ) -> list[torch.Tensor]:
    """Tiny-leaf path: replicated mean over a plain all-reduce."""
    return [s / world for s in comm.all_reduce_sum(gs)]


def zero1_step(loss_and_grad: Callable, params: list, opt: list,
               batches: list, *, comm, opt_cfg: adamw.AdamWConfig,
               sync: GradSyncConfig):
    """One ZeRO-1 training step over the local ranks.

    ``params`` / ``opt`` / ``batches`` are per-local-rank lists (parameter
    trees, :class:`Zero1State`, batch dicts).  Returns
    ``(params', opt', metrics)``.  Memory: at full width the old and new
    states of p ranks do not fit side by side, so the step rebinds the
    leaves of the parameter and moment trees it was given, leaf by leaf,
    and drops each gradient as soon as it is reduced.
    """
    world = comm.p
    losses, grads = [], []
    for prm, batch in zip(params, batches):
        loss, g = loss_and_grad(prm, batch)
        losses.append(loss)
        grads.append(T.leaves(g))
    items = T.flatten(params[0])
    flags = [is_zero_leaf(tuple(p.shape), world, sync.min_shard_numel)
             for _, p in items]
    f32 = torch.float32

    # --- reduce: shard big leaves (Algorithm 1), all-reduce tiny ones ---
    g_red = [[None] * len(items) for _ in params]
    for i, flag in enumerate(flags):
        gs = [g[i] for g in grads]
        for g in grads:
            g[i] = None  # free each leaf's gradients once reduced
        if flag:
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
            T.assign(opt[j].m, path, m2)
            T.assign(opt[j].v, path, v2)
            new_loc.append(out)
        if flag:
            ld = items[i][1].shape[0]
            new_loc = allgather_leaf(new_loc, ld, comm, sync)
        for j, val in enumerate(new_loc):
            T.assign(params[j], path, val)

    mloss = comm.all_reduce_sum([l.detach().to(f32) for l in losses])
    metrics = {"loss": mloss[0] / world, "grad_norm": gnorms[0], "lr": lr}
    new_opt = [Zero1State(m=o.m, v=o.v, step=step) for o in opt]
    return params, new_opt, metrics


def init_zero1_state(params: dict, world: int, sync: GradSyncConfig
                     ) -> Zero1State:
    """One rank's zero optimizer state: zero leaves get their
    ``(ld_pad / world, *rest)`` fp32 shard, tiny leaves full fp32
    replicas (the reference's global state, cut to one rank's shard)."""
    def mk(p):
        shape = tuple(p.shape)
        if is_zero_leaf(shape, world, sync.min_shard_numel):
            ld_pad = shape[0] + (-shape[0]) % world
            shape = (ld_pad // world, *shape[1:])
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return Zero1State(m=T.map_leaves(mk, params), v=T.map_leaves(mk, params),
                      step=0)
