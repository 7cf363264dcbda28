"""AdamW + LR schedule, ported from ``repro/optim/adamw.py``.

fp32 moments whatever the parameter dtype.  Scalars (learning rate, bias
corrections, clip scale) are float32 tensors, as the reference computes
them in float32.  Used by the ``single`` step over whole parameter trees
and, per shard, by ZeRO-1 (``optim/zero1.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import tree as T


@dataclass(frozen=True)
class AdamWConfig:
    """AdamW + LR-schedule hyperparameters (cosine decay to
    ``min_lr_ratio`` after ``warmup_steps`` of linear warmup; global-norm
    clip at ``clip_norm``)."""
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """Learning rate at ``step`` (float32): linear warmup then cosine
    decay to ``cfg.min_lr_ratio * cfg.lr``."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def clip_scale_from_norm(cfg: AdamWConfig, gnorm: torch.Tensor
                         ) -> torch.Tensor:
    """Gradient scale factor implementing global-norm clipping."""
    return torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)


def bias_corrections(cfg: AdamWConfig, step: int, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(1 - beta1**t, 1 - beta2**t)`` in float32 at ``t = step``."""
    t = torch.tensor(float(step), dtype=torch.float32, device=device)
    b1 = torch.tensor(cfg.beta1, dtype=torch.float32, device=device)
    b2 = torch.tensor(cfg.beta2, dtype=torch.float32, device=device)
    return 1 - b1 ** t, 1 - b2 ** t


def adamw_update(cfg: AdamWConfig, p, g, m, v, *, lr, bc1, bc2):
    """One AdamW step on one tensor (or shard): ``g`` already clip-scaled
    float32.  Returns ``(new_p, m2, v2)``, ``new_p`` in ``p``'s dtype."""
    m2 = cfg.beta1 * m + (1 - cfg.beta1) * g
    v2 = cfg.beta2 * v + (1 - cfg.beta2) * g * g
    p32 = p.to(torch.float32)
    delta = -lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
                   + cfg.weight_decay * p32)
    return (p32 + delta).to(p.dtype), m2, v2


def global_norm(tree: dict) -> torch.Tensor:
    """L2 norm over every leaf of ``tree`` (fp32 accumulation, leaf
    order as the reference)."""
    acc = None
    for leaf in T.leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        acc = sq if acc is None else acc + sq
    return torch.sqrt(acc)


class TreeAdamState(NamedTuple):
    """Pytree optimizer state: m/v mirror the param tree; ``step`` is the
    number of updates taken."""
    m: dict
    v: dict
    step: int


def init_tree_state(params: dict) -> TreeAdamState:
    """Zero-initialized :class:`TreeAdamState` mirroring ``params``."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return TreeAdamState(m=T.map_leaves(zeros, params),
                         v=T.map_leaves(zeros, params), step=0)


#: elements of one slice of an in-place update (512 MB of float32): the
#: step's float32 temporaries stay this small whatever the leaf
IN_PLACE_CHUNK = 1 << 27


def update_tree(cfg: AdamWConfig, state: TreeAdamState, grads: dict,
                params: dict, gnorm: torch.Tensor | None = None,
                in_place: bool = False):
    """One AdamW step on whole trees (the ``single`` mode), or on one
    rank's blocks with the global ``gnorm`` given (fsdp_auto).  Returns
    ``(new_params, new_state, grad_norm)``.  ``in_place``: the new values
    are written into the leaves of ``params``, ``state.m`` and
    ``state.v`` (contiguous), ``IN_PLACE_CHUNK`` elements of the
    flattened leaf at a time: the same values, the float32 temporaries
    of a slice only, where a full-width rank cannot hold a stacked leaf's
    twice."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = clip_scale_from_norm(cfg, gnorm)
    step = state.step + 1
    dev = gnorm.device
    lr = lr_at(cfg, step, dev)
    bc1, bc2 = bias_corrections(cfg, step, dev)
    paths = [path for path, _ in T.flatten(params)]
    if in_place:
        for path, g in zip(paths, T.leaves(grads)):
            # flat views (the blocks and moments are contiguous): a slice
            # is IN_PLACE_CHUNK elements even where one row of a stacked
            # leaf is more (grok-1's expert blocks: 4e8 elements a layer)
            leaves = [T.get(t, path).view(-1)
                      for t in (params, state.m, state.v)]
            g = g.reshape(-1)
            for lo in range(0, g.numel(), IN_PLACE_CHUNK):
                part = slice(lo, lo + IN_PLACE_CHUNK)
                out = adamw_update(cfg, leaves[0][part],
                                   g[part].to(torch.float32) * scale,
                                   leaves[1][part], leaves[2][part], lr=lr,
                                   bc1=bc1, bc2=bc2)
                for dst, val in zip(leaves, out):
                    dst[part] = val
        return params, TreeAdamState(m=state.m, v=state.v, step=step), gnorm
    new_p, new_m, new_v = {}, {}, {}
    for path, g in zip(paths, T.leaves(grads)):
        g = g.to(torch.float32) * scale
        out = adamw_update(cfg, T.get(params, path), g, T.get(state.m, path),
                           T.get(state.v, path), lr=lr, bc1=bc1, bc2=bc2)
        for tree, val in zip((new_p, new_m, new_v), out):
            T.assign(tree, path, val)
    return new_p, TreeAdamState(m=new_m, v=new_v, step=step), gnorm
