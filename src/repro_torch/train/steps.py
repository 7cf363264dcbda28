"""Train-step builders, ported from ``repro/train/steps.py``.

  zero1   the paper's circulant collectives drive the gradient
          reduce-scatter and the parameter allgather over a communicator
          (``repro_torch.comm``); optimizer state sharded 1/p.
  single  one rank, AdamW over whole parameter trees.

Both return a :class:`BuiltStep` whose ``step_fn`` maps
``(params, opt, batch) -> (params, opt, metrics)``.  For zero1 each of
the three is a list over the communicator's local ranks.  The
reference's ``fsdp_auto`` mode (GSPMD) has no counterpart yet.

An expert-parallel MoE model (``moe_dispatch="ep"``) couples its ranks
through the alltoall: zero1 then takes ONE backward of the sum of all
ranks' losses (``value_and_grad_ranks``), as the reference's gradient
inside ``shard_map`` transposes the exchanges, and syncs each model
column over its data-axis group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from .. import tree as T
from ..analysis.verify import assert_verified
from ..core.plan import plan
from ..models import ModelApi, is_ep, value_and_grad, value_and_grad_ranks
from ..models.transformer import param_shapes
from ..optim.adamw import AdamWConfig, init_tree_state, lr_at, update_tree
from ..optim.zero1 import (GradSyncConfig, init_zero1_state, is_zero_leaf,
                           plan_grad_buckets, zero1_step)


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


def check_bucket_partition(model_cfg, world: int, sync: GradSyncConfig
                           ) -> None:
    """Check the bucketed sync's partition of ``model_cfg``'s zero leaves
    at ``world`` ranks (the reference's build-time checks): raises unless
    every bucket is non-empty, every segment ``(leaf, lo, hi)`` has ``0
    <= lo < hi``, and each leaf's segments add up to its shard rows."""
    zshapes = [s for _, s in T.flatten(param_shapes(model_cfg))
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
                ep_world: int | None = None) -> BuiltStep:
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
    exactly."""
    for role, spec in collective_specs(sync, model.cfg, ep_world):
        pl = plan(spec, p=comm.p if role == "data" else ep_world)
        pl.backend_for(device)
        assert_verified(pl)
    if sync.bucket_bytes is not None:
        check_bucket_partition(model.cfg, comm.p, sync)
    if model.loss_ranks is not None:
        loss_and_grad = value_and_grad_ranks(model.loss_ranks)
    else:
        one = value_and_grad(model.loss)

        def loss_and_grad(params, batches):
            pairs = [one(p, b) for p, b in zip(params, batches)]
            return [p[0] for p in pairs], [p[1] for p in pairs]

    def step_fn(params, opt, batches):
        return zero1_step(loss_and_grad, params, opt, batches, comm=comm,
                          opt_cfg=opt_cfg, sync=sync)

    def init_opt(params):
        return [init_zero1_state(p, comm.p, sync) for p in params]

    return BuiltStep(step_fn=step_fn, init_opt=init_opt)
