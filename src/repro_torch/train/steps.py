"""Train-step builders, ported from ``repro/train/steps.py``.

  zero1   the paper's circulant collectives drive the gradient
          reduce-scatter and the parameter allgather over a communicator
          (``repro_torch.comm``); optimizer state sharded 1/p.
  single  one rank, AdamW over whole parameter trees.

Both return a :class:`BuiltStep` whose ``step_fn`` maps
``(params, opt, batch) -> (params, opt, metrics)``.  For zero1 each of
the three is a list over the communicator's local ranks.  The
reference's ``fsdp_auto`` mode (GSPMD) has no counterpart yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..core.plan import plan
from ..models import ModelApi, value_and_grad
from ..optim.adamw import AdamWConfig, init_tree_state, lr_at, update_tree
from ..optim.zero1 import GradSyncConfig, init_zero1_state, zero1_step


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


def build_zero1(model: ModelApi, comm, opt_cfg: AdamWConfig,
                sync: GradSyncConfig, device=None) -> BuiltStep:
    """ZeRO-1 over ``comm``: per-leaf circulant RS → AdamW on the shard →
    circulant AG.  Both grad-sync plans (the reduce-scatter's, which may
    be on the int8 wire, and the allgather's) are compiled here and their
    backends resolved for gradients on ``device``, so a bad sync config
    fails at build time rather than mid-step."""
    for spec in (sync.rs_spec(), sync.ag_spec()):
        plan(spec, p=comm.p).backend_for(device)
    loss_and_grad = value_and_grad(model.loss)

    def step_fn(params, opt, batches):
        return zero1_step(loss_and_grad, params, opt, batches, comm=comm,
                          opt_cfg=opt_cfg, sync=sync)

    def init_opt(params):
        return [init_zero1_state(p, comm.p, sync) for p in params]

    return BuiltStep(step_fn=step_fn, init_opt=init_opt)
