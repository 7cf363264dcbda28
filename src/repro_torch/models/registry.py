"""Model registry, ported from ``repro/models/registry.py``: one API over
every architecture family, for training and serving, the family's
parameter shapes and leaf dtypes, and the tensor-parallel parameter
specs (``make_param_specs``)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import tree as T
from ..sharding import PartitionSpec as P
from . import encdec, transformer, vlm, xlstm
from .config import ModelConfig, ShardingRecipe

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "hybrid": transformer,
    "ssm_xlstm": xlstm,
    "encdec": encdec,
    "vlm": vlm,
}


def family_module(cfg: ModelConfig):
    """The module that builds ``cfg``'s family."""
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}; have "
                         f"{sorted(_FAMILY_MODULES)}") from None


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's leaves) of ``cfg``'s
    family."""
    return family_module(cfg).param_shapes(cfg)


def leaf_dtype(cfg: ModelConfig, path) -> torch.dtype:
    """The dtype of the leaf at ``path`` as the reference keeps it."""
    return family_module(cfg).leaf_dtype(cfg, path)


class ModelApi(NamedTuple):
    """What training and serving need from a model.  ``loss_ranks`` is set
    for a model whose ranks are coupled (expert-parallel MoE, or a model
    with tensor parallelism): it maps
    per-rank parameter trees and batches to per-rank losses in one
    forward over all of them; ``loss`` and ``forward_logits`` then raise.
    ``forward_logits`` and ``prefill`` take the family's extras as
    keywords, as the reference's do: ``frames=`` (encoder-decoder) and
    ``image_embeds=`` (VLM).
    ``prefill`` and ``decode_step`` of such a model run every rank of its
    communicator on the same tokens with the one parameter tree (the
    reference's ``shard_map`` with every spec ``P()``): the cache is then
    a list of ``ep_ranks`` caches, one per rank the communicator holds in
    this process (every rank of a ``LocalComm``, one of a ``DistComm``),
    and the logits are this process's first rank's (every rank's are
    the same bits).  ``ep_ranks`` is 0 for any other model (one cache,
    no list)."""
    cfg: ModelConfig
    init: Callable            # (generator, device) -> params
    loss: Callable            # (params, batch) -> scalar
    forward_logits: Callable  # (params, tokens, **ex) -> logits | (lg, aux)
    prefill: Callable         # (params, tokens, max_len, **ex) -> (cache, lg)
    decode_step: Callable     # (params, cache, token, pos) -> (cache, logits)
    loss_ranks: Callable | None = None  # ([params], [batch]) -> [scalar]
    ep_ranks: int = 0


def is_ep(cfg: ModelConfig) -> bool:
    """True for an expert-parallel MoE config."""
    return cfg.is_moe and cfg.moe_dispatch == "ep"


def build(cfg: ModelConfig, remat: bool = True, ep_comm=None,
          use_fused_kernel: bool | None = None, tp=None) -> ModelApi:
    """The :class:`ModelApi` of ``cfg``'s family.  An expert-parallel MoE
    config exchanges over ``ep_comm`` (the model axis's communicator;
    ``use_fused_kernel`` picks its alltoall backend, ``None`` = the
    ``permute_rows`` kernel when the buffer lies on a card).  With ``tp``
    (a ``sharding.TensorParallel``) a model of any family (the MoE under
    its global or rowwise dispatch) runs tensor parallel: ``loss_ranks``
    over each rank's blocks, ``init`` drawing each leaf whole and giving
    every local rank its blocks; the expert-parallel MoE raises
    ``NotImplementedError`` (its own path)."""
    mod = family_module(cfg)

    def init(gen, device=None):
        return mod.init_params(cfg, gen, device)

    if tp is not None:
        transformer.check_tp(cfg)
        return _build_tp(cfg, remat, tp)
    if not is_ep(cfg):
        return ModelApi(
            cfg=cfg, init=init,
            loss=lambda params, batch: mod.loss_fn(params, cfg, batch,
                                                   remat),
            forward_logits=lambda params, tokens, **ex: mod.forward_logits(
                params, cfg, tokens, remat, **ex),
            prefill=lambda params, tokens, max_len, **ex: mod.prefill(
                params, cfg, tokens, max_len, **ex),
            decode_step=lambda params, cache, token, pos: mod.decode_step(
                params, cfg, cache, token, pos))
    if ep_comm is None:
        raise ValueError(f"{cfg.name}: moe_dispatch='ep' needs ep_comm, the "
                         f"communicator of the expert-parallel axis")

    def coupled(*args):
        raise ValueError("an expert-parallel model's ranks are coupled: "
                         "use loss_ranks over all local ranks")

    n = len(ep_comm.ranks)

    def prefill(params, tokens, max_len):
        caches, logits = mod.prefill_ep([params] * n, cfg, [tokens] * n,
                                        max_len, ep_comm, use_fused_kernel)
        return caches, logits[0]

    def decode_step(params, caches, token, pos):
        caches, logits = mod.decode_step_ep([params] * n, cfg, caches,
                                            [token] * n, pos, ep_comm,
                                            use_fused_kernel)
        return caches, logits[0]

    return ModelApi(cfg=cfg, init=init, loss=coupled, forward_logits=coupled,
                    prefill=prefill, decode_step=decode_step,
                    loss_ranks=lambda ps, bs: mod.loss_fn_ep(
                        ps, cfg, bs, ep_comm, remat, use_fused_kernel),
                    ep_ranks=n)


def _build_tp(cfg: ModelConfig, remat: bool, tp) -> ModelApi:
    def coupled(*args):
        raise ValueError("a tensor-parallel model's ranks are coupled: use "
                         "loss_ranks over all local ranks")

    mod = family_module(cfg)
    return ModelApi(
        cfg=cfg, init=lambda gen, device=None: mod.init_params(
            cfg, gen, device, split=tp.blocks),
        loss=coupled, forward_logits=coupled, prefill=coupled,
        decode_step=coupled,
        loss_ranks=lambda ps, bs: mod.loss_fn_tp(ps, cfg, bs, tp, remat))


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


def value_and_grad_ranks(loss_ranks: Callable) -> Callable:
    """``([params], [batch]) -> ([loss], [grads])`` for coupled ranks: one
    forward over every local rank, then ONE backward of the sum of their
    losses, each rank's gradient taken from its own leaves — rank r gets
    ``d(sum_s L_s) / d params_r``, what the reference's gradient inside
    ``shard_map`` gives each device through the transposed exchanges.
    Over a ``DistComm`` (one rank per process) each process takes the
    backward of its own loss, and the other ranks' terms arrive through
    the reverse exchanges, run by every rank in the same order."""
    def f(params, batches):
        items = [T.flatten(p) for p in params]
        leaves = [[leaf.detach().requires_grad_(True) for _, leaf in it]
                  for it in items]
        trees = [T.unflatten(zip((p for p, _ in it), lv))
                 for it, lv in zip(items, leaves)]
        losses = loss_ranks(trees, batches)
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        flat = torch.autograd.grad(total, [x for lv in leaves for x in lv],
                                   allow_unused=True, materialize_grads=True)
        grads, i = [], 0
        for it in items:
            grads.append(T.unflatten(zip((p for p, _ in it),
                                         flat[i:i + len(it)])))
            i += len(it)
        return [loss.detach() for loss in losses], grads

    return f


# ---------------------------------------------------------------------------
# Sharding rules (leaf-name based; stacked layer dims padded with None)
# ---------------------------------------------------------------------------

def _rules(fsdp):
    """name -> base spec (innermost dims).  fsdp is an axis tuple or None."""
    f = fsdp
    return {
        # embeddings / heads
        "embed": (("model", f)),
        "lm_head": ((f, "model")),
        # attention
        "wq": (f, "model", None), "wk": (f, "model", None),
        "wv": (f, "model", None), "wo": ("model", None, f),
        "wo_gate": (f, "model", None),
        "bq": ("model", None), "bk": ("model", None), "bv": ("model", None),
        # dense ffn
        "w_gate": (f, "model"), "w_up": (f, "model"), "w_down": ("model", f),
        # moe (expert-parallel over 'model')
        "moe.w_gate": ("model", f, None), "moe.w_up": ("model", f, None),
        "moe.w_down": ("model", None, f), "router": (None, None),
        # mamba
        "w_in": (f, "model"), "w_out": ("model", f),
        "w_dt": ("model", None), "w_B": ("model", None), "w_C": ("model", None),
        "A_log": ("model", None), "D": ("model",), "conv_w": (None, "model"),
        "dt_bias": ("model",),
        # mlstm / slstm
        "wi": (f, "model"), "wf": (f, "model"),
        "w_x": (f, None, "model", None), "r_h": (None, "model", None, None),
    }


def _leaf_name(path) -> tuple[str, str]:
    """(name, qualified) — qualified includes the parent dict key (a
    path's ``str`` keys; list indices are skipped)."""
    names = [k for k in path if isinstance(k, str)]
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    return name, f"{parent}.{name}"


def make_param_specs(params, recipe: ShardingRecipe | None):
    """``PartitionSpec`` tree matching ``params`` (tensors, or shape
    tuples as ``param_shapes`` gives them).

    TP rule set above; when recipe.mode == 'tp_fsdp' the designated weight
    dim is additionally sharded over the data axes (FSDP).  Leading stacked
    dims (scan layers / vlm groups) are padded with None.  Unknown leaves
    replicate.  ``launch.mesh.sanitize_specs`` then drops what a mesh
    does not divide.
    """
    items = T.flatten(params)
    if recipe is None:
        return T.unflatten((path, P()) for path, _ in items)
    fsdp = tuple(recipe.fsdp_axes) if recipe.fsdp_axes else None
    rules = _rules(fsdp)

    def spec_for(path, leaf):
        name, qual = _leaf_name(path)
        base = rules.get(qual, rules.get(name))
        ndim = len(getattr(leaf, "shape", leaf))
        if base is None:
            return P(*([None] * ndim))
        base = tuple(base)
        if ndim < len(base):  # scalar-ish leaf (smoke config edge): replicate
            return P(*([None] * ndim))
        pad = ndim - len(base)
        spec = (None,) * pad + base
        # Replace 'model' with the recipe's model axis name.
        spec = tuple(recipe.model_axis if s == "model" else s for s in spec)
        return P(*spec)

    return T.unflatten((path, spec_for(path, leaf)) for path, leaf in items)
