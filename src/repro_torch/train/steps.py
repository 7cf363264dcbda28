"""Train-step builders, ported from ``repro/train/steps.py``.

  zero1      the paper's circulant collectives drive the gradient
             reduce-scatter and the parameter allgather over a
             communicator (``repro_torch.comm``); optimizer state sharded
             1/p.  On a ``D x M`` mesh with tensor parallelism over the
             model axis (the reference's partial-manual step: data axes
             manual, the model axis GSPMD's), each model column syncs its
             ranks' blocks over its data-axis group.
  fsdp_auto  the reference's pure-GSPMD mode: parameters and AdamW state
             split over the model axis and, under the recipe's
             ``tp_fsdp``, over the data axes on each leaf's FSDP dim;
             every layer's blocks gathered over the data axis just before
             use (``all_gather``), the gradients brought back by its
             backward (``reduce_scatter_sum``), the leaves not split over
             data summed by ``all_reduce_sum``, all divided by D as the
             global batch mean divides, and AdamW on the blocks with the
             global grad norm.  The native calls are the counterparts of
             the collectives XLA inserts: no circulant plan runs here.
  single     one rank, AdamW over whole parameter trees.

Each returns a :class:`BuiltStep` whose ``step_fn`` maps
``(params, opt, batch) -> (params, opt, metrics)``.  For zero1 and
fsdp_auto each of the three is a list over the local ranks.

An expert-parallel MoE model (``moe_dispatch="ep"``) couples its ranks
through the alltoall: zero1 then takes ONE backward of the sum of all
ranks' losses (``value_and_grad_ranks``), as the reference's gradient
inside ``shard_map`` transposes the exchanges, and syncs each model
column over its data-axis group.  A tensor-parallel model (the dense
and MoE families' ``transformer.loss_fn_tp``, the VLM's
``vlm.loss_fn_tp``) couples its model ranks the same way, but
every rank takes the backward of its own loss copy (``models/
sharding.py``): the sum of all local ranks' losses, each term reaching
only its own rank's leaves but through the model-axis calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from .. import tree as T
from ..analysis.verify import assert_verified
from ..core.plan import plan
from ..models import (ModelApi, is_ep, param_shapes, value_and_grad,
                      value_and_grad_ranks)
import torch

from ..optim.adamw import AdamWConfig, init_tree_state, lr_at, update_tree
from ..optim.zero1 import (GradSyncConfig, init_zero1_state, is_zero_leaf,
                           mesh_grad_norms, plan_grad_buckets, tp_sync_layout,
                           zero1_step)


@dataclass
class BuiltStep:
    step_fn: Callable   # (params, opt, batch) -> (params, opt, metrics)
    init_opt: Callable  # (params) -> opt state


def build_single(model: ModelApi, opt_cfg: AdamWConfig) -> BuiltStep:
    """Plain single-rank AdamW training."""
    loss_and_grad = value_and_grad(model.loss)

    def step_fn(params, opt, batch):
        loss, grads = loss_and_grad(params, batch)
        new_params, new_opt, gnorm = update_tree(opt_cfg, opt, grads, params)
        return new_params, new_opt, {
            "loss": loss, "grad_norm": gnorm,
            "lr": lr_at(opt_cfg, new_opt.step, gnorm.device)}

    return BuiltStep(step_fn=step_fn, init_opt=init_tree_state)


def collective_specs(sync: GradSyncConfig, model_cfg=None,
                     ep_world: int | None = None
                     ) -> tuple[tuple[str, Any], ...]:
    """Every :class:`CollectiveSpec` a zero1 step executes, as ``(role,
    spec)`` pairs: ``"data"`` for the grad sync's reduce-scatter and
    allgather, and ``"ep"`` for the MoE dispatch's alltoall and
    alltoallv when ``model_cfg`` is expert-parallel (``ep_world`` is that
    axis's size)."""
    out: list[tuple[str, Any]] = [("data", sync.rs_spec()),
                                  ("data", sync.ag_spec())]
    if model_cfg is not None and is_ep(model_cfg):
        if ep_world is None:
            raise ValueError("moe_dispatch='ep' config needs ep_world to "
                             "enumerate its dispatch specs")
        from ..models.dispatch import ep_collective_specs
        out += [("ep", sp) for sp in ep_collective_specs(
            model_cfg, ep_world, sync.use_fused_kernel)]
    return tuple(out)


def check_bucket_partition(model_cfg, world: int, sync: GradSyncConfig,
                           shapes=None) -> None:
    """Check the bucketed sync's partition of ``model_cfg``'s zero leaves
    at ``world`` ranks (the reference's build-time checks): raises unless
    every bucket is non-empty, every segment ``(leaf, lo, hi)`` has ``0
    <= lo < hi``, and each leaf's segments add up to its shard rows.
    ``shapes``: the leaves one rank holds (tensor parallelism: its
    blocks), flatten order; the whole leaves by default."""
    if shapes is None:
        shapes = [s for _, s in T.flatten(param_shapes(model_cfg))]
    zshapes = [s for s in shapes
               if is_zero_leaf(s, world, sync.min_shard_numel)]
    itemsize = 4 if sync.rs_dtype == "float32" else 2
    buckets = plan_grad_buckets(zshapes, world, sync.bucket_bytes, itemsize)
    covered: dict[int, int] = {}
    for b in buckets:
        if not b:
            raise ValueError("bucket partitioner produced empty bucket")
        for li, lo, hi in b:
            if not 0 <= lo < hi:
                raise ValueError(f"bad segment ({li}, {lo}, {hi})")
            covered[li] = covered.get(li, 0) + (hi - lo)
    for li, shape in enumerate(zshapes):
        rows = (shape[0] + (-shape[0]) % world) // world
        if covered.get(li, 0) != rows:
            raise ValueError(
                f"bucket partition covers {covered.get(li, 0)}/{rows} "
                f"shard rows of leaf {li} {shape}")


def build_zero1(model: ModelApi, comm, opt_cfg: AdamWConfig,
                sync: GradSyncConfig, device=None,
                ep_world: int | None = None, tp=None) -> BuiltStep:
    """ZeRO-1 over ``comm`` (the data axis's): per-leaf circulant RS →
    AdamW on the shard → circulant AG.  Every plan of the step (the
    reduce-scatter's, which may be on the int8 wire, the allgather's and,
    for an expert-parallel model over ``ep_world`` ranks, the dispatch's
    alltoall(v)) is compiled here, its backend resolved for tensors on
    ``device`` and the plan put through the static verifier
    (``assert_verified``), so a bad config or a corrupted plan fails at
    build time rather than mid-step.  With ``sync.bucket_bytes`` the
    bucket partition of the model's zero leaves is checked too: no empty
    bucket, well-formed segments, and every leaf's shard rows covered
    exactly.  With ``tp`` (the ``sharding.TensorParallel`` the model
    was built with) every rank holds its blocks, the sync runs on them
    (on the int8 wire, the leaves :func:`tp_sync_layout` names whole)
    and the grad norm also sums over the model axis."""
    for role, spec in collective_specs(sync, model.cfg, ep_world):
        pl = plan(spec, p=comm.p if role == "data" else ep_world)
        pl.backend_for(device)
        assert_verified(pl)
    if sync.bucket_bytes is not None:
        check_bucket_partition(model.cfg, comm.p, sync,
                               tp.layout.local_shapes() if tp else None)
    model_comm = model_split = whole_dims = shapes = None
    if tp is not None:
        model_comm = tp.axis.comm
        model_split = [ll.model is not None
                       for ll in T.leaves(tp.layout.leaves)]
        whole_dims, shapes = tp_sync_layout(tp.layout, comm.p, sync)
    if model.loss_ranks is not None:
        loss_and_grad = value_and_grad_ranks(model.loss_ranks)
    else:
        one = value_and_grad(model.loss)

        def loss_and_grad(params, batches):
            pairs = [one(p, b) for p, b in zip(params, batches)]
            return [p[0] for p in pairs], [p[1] for p in pairs]

    def step_fn(params, opt, batches):
        return zero1_step(loss_and_grad, params, opt, batches, comm=comm,
                          opt_cfg=opt_cfg, sync=sync, model_comm=model_comm,
                          model_split=model_split, whole_dims=whole_dims)

    def init_opt(params):
        return [init_zero1_state(p, comm.p, sync, shapes) for p in params]

    return BuiltStep(step_fn=step_fn, init_opt=init_opt)


def build_fsdp_auto(model: ModelApi, tp, opt_cfg: AdamWConfig) -> BuiltStep:
    """The reference's ``fsdp_auto`` on a tensor-parallel model (``tp``:
    its ``sharding.TensorParallel``): every rank holds its blocks and
    their AdamW state (``TreeAdamState`` per local rank).  A step is the
    reference's ``single`` step on the global batch: the per-rank losses
    and the gradients of the blocks (those split over the data axes
    already summed over them by the gathers' backward, the others summed
    here by ``all_reduce_sum``), divided by D, then ``update_tree`` on
    the blocks with the global grad norm, in place (the old leaves freed
    as the new ones come)."""
    data, mcomm = tp.data, tp.axis.comm
    lls = T.leaves(tp.layout.leaves)
    loss_and_grad = value_and_grad_ranks(model.loss_ranks)
    f32 = torch.float32

    def step_fn(params, opt, batches):
        losses, trees = loss_and_grad(params, batches)
        paths = [path for path, _ in T.flatten(trees[0])]
        grads = [T.leaves(t) for t in trees]
        del trees
        for i, ll in enumerate(lls):
            if ll.data is None:
                summed = data.all_reduce_sum([g[i] for g in grads])
                for g, x in zip(grads, summed):
                    g[i] = x
        for g in grads:  # the batch mean, in the gradients' dtype (as
            for x in g:  # the reference's are): no float32 copy of them all
                x.div_(data.p)
        gnorms = mesh_grad_norms(grads, [ll.data is not None for ll in lls],
                                 [ll.model is not None for ll in lls],
                                 data, mcomm)
        new_p, new_o = [], []
        for p, o, g, gn in zip(params, opt, grads, gnorms):
            np_, no, _ = update_tree(opt_cfg, o, T.unflatten(zip(paths, g)),
                                     p, gnorm=gn, in_place=True)
            new_p.append(np_)
            new_o.append(no)
        mloss = data.fold_sum([l.detach().to(f32) for l in losses])
        return new_p, new_o, {
            "loss": mloss[0] / data.p, "grad_norm": gnorms[0],
            "lr": lr_at(opt_cfg, new_o[0].step, gnorms[0].device)}

    return BuiltStep(step_fn=step_fn,
                     init_opt=lambda params: [init_tree_state(p)
                                              for p in params])
