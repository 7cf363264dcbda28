"""Model registry, ported from ``repro/models/registry.py``: one API over
the architecture families (the dense family so far)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import tree as T
from . import transformer
from .config import ModelConfig

_FAMILY_MODULES = {"dense": transformer}


class ModelApi(NamedTuple):
    """What a training step needs from a model."""
    cfg: ModelConfig
    init: Callable            # (generator, device) -> params
    loss: Callable            # (params, batch) -> scalar


def build(cfg: ModelConfig, remat: bool = True) -> ModelApi:
    """The :class:`ModelApi` of ``cfg``'s family."""
    try:
        mod = _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1 "
            f"item 13)") from None
    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None: mod.init_params(cfg, gen, device),
        loss=lambda params, batch: mod.loss_fn(params, cfg, batch, remat),
    )


def value_and_grad(loss: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)`` with ``grads`` a tree like
    ``params`` (the reference's ``jax.value_and_grad``).  The parameter
    tensors are used through detached aliases, so nothing is copied and
    the caller's tensors keep no graph."""
    def f(params, batch):
        items = T.flatten(params)
        leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
        val = loss(T.unflatten(zip((p for p, _ in items), leaves)), batch)
        grads = torch.autograd.grad(val, leaves)
        return val.detach(), T.unflatten(zip((p for p, _ in items), grads))

    return f
