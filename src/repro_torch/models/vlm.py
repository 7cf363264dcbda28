"""Llama-3.2-Vision-style decoder, ported from ``repro/models/vlm.py``:
groups of 4 self-attention layers and 1 gated cross-attention layer.

The vision tower is a stub, as in the reference: ``image_embeds`` holds
precomputed patch embeddings ``(B, n_image_tokens, d_model)``, the
cross layers' memory.  A cross layer's residuals are ``tanh``-gated with
gates initialized to zero, so the model starts as a pure LM.  The
parameters are stacked as the reference's: ``self_layers.*`` ``(G, 4,
...)`` and ``cross_layers.*`` ``(G, ...)``; the forward loops over the
groups, each group one recomputed unit with ``remat`` (the reference's
``jax.checkpoint`` around its scan body).  The cache holds every self
layer's k/v, ``(G, 4, B, max_len, Hkv, dh)``, and each cross layer's
projected image ``img_k``/``img_v`` ``(G, B, T_img, Hkv, dh)``.
The tensor-parallel form (:func:`loss_fn_tp`) runs every local rank of
a ``D x M`` mesh together, as the dense family's does: the self layers
are the dense TP layer, a cross layer projects the image K/V on each
rank's heads and gates the summed attention and FFN outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import tree as T
from . import attention as attn
from . import sharding as shd
from . import transformer as tfm
from .config import ModelConfig
from .layers import (cross_entropy_loss, dtype_of, ffn, init_leaf,
                     layer_slices, rmsnorm, run_layer)

SELF_PER_GROUP = 4


def _n_groups(cfg) -> int:
    if cfg.n_layers % (SELF_PER_GROUP + 1):
        raise ValueError(f"vlm needs n_layers % {SELF_PER_GROUP + 1} == 0, "
                         f"got {cfg.n_layers}")
    return cfg.n_layers // (SELF_PER_GROUP + 1)


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's leaves)."""
    d, ff, G = cfg.d_model, cfg.d_ff, _n_groups(cfg)
    ffn_s = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}

    def stack(lead, shapes):
        return {k: (stack(lead, v) if isinstance(v, dict) else (*lead, *v))
                for k, v in shapes.items()}

    selfs = {"norm1": (d,), "norm2": (d,),
             "attn": attn.attention_shapes(cfg), "ffn": ffn_s}
    cross = {"norm1": (d,), "norm2": (d,),
             "xattn": attn.attention_shapes(cfg, cross=True), "ffn": ffn_s,
             "gate_attn": (), "gate_ffn": ()}
    return {"embed": (cfg.vocab_size, d),
            "self_layers": stack((G, SELF_PER_GROUP), selfs),
            "cross_layers": stack((G,), cross),
            "final_norm": (d,), "lm_head": (d, cfg.vocab_size)}


def leaf_dtype(cfg: ModelConfig, path) -> torch.dtype:
    return dtype_of(cfg)


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None,
                split=None) -> dict | list:
    """Random parameters from ``gen``, each leaf by the reference's
    initializer for its name (:func:`layers.init_leaf`; fan-in of the
    per-layer shape).  With ``split(path, leaf)``, one tree of blocks per
    rank (``transformer.split_draws``)."""
    dtype = dtype_of(cfg)
    lead = {"self_layers": 2, "cross_layers": 1}
    draws = ((path, init_leaf(gen, path[-1], shape, lead.get(path[0], 0),
                              dtype, device))
             for path, shape in T.flatten(param_shapes(cfg)))
    if split is None:
        return T.unflatten(draws)
    return tfm.split_draws(draws, split)


def _self_layer(cfg, lp, x, positions):
    """``(x, (k, v))``."""
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    a, kv = attn.self_attention(lp["attn"], cfg, h, positions)
    x = x + a
    return x + ffn(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps)), kv


def _cross_layer(cfg, lp, x, img_kv):
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    a = attn.cross_attention(lp["xattn"], cfg, h, img_kv)
    x = x + torch.tanh(lp["gate_attn"]) * a
    y = ffn(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    return x + torch.tanh(lp["gate_ffn"]) * y


def _group(cfg, self_paths, cross_paths, x, positions, image_embeds,
           *leaves):
    """One group: 4 self layers, then the gated cross layer over the
    image embeddings.  ``leaves``: the group's self leaves ``(4, ...)``
    in ``self_paths`` order, then its cross leaves.  Returns ``x`` and
    the self layers' k and v, each ``(4, B, S, Hkv, dh)``."""
    n = len(self_paths)
    per_layer = zip(*(leaf.unbind(0) for leaf in leaves[:n]))
    ks, vs = [], []
    for layer_leaves in per_layer:
        lp = T.unflatten(zip(self_paths, layer_leaves))
        x, (k, v) = _self_layer(cfg, lp, x, positions)
        ks.append(k)
        vs.append(v)
    cp = T.unflatten(zip(cross_paths, leaves[n:]))
    img_kv = attn.project_memory(cp["xattn"], cfg, image_embeds)
    return _cross_layer(cfg, cp, x, img_kv), torch.stack(ks), torch.stack(vs)


def _group_x(*args):
    return _group(*args)[0]


def _stack(params, cfg, tokens, image_embeds, remat, want_cache=False):
    b, s = tokens.shape
    x = F.embedding(tokens.long(), params["embed"]).to(dtype_of(cfg))
    positions = torch.arange(s, device=x.device).expand(b, s)
    img = image_embeds.to(dtype_of(cfg))
    self_paths, self_groups = layer_slices(params, "self_layers")
    cross_paths, cross_groups = layer_slices(params, "cross_layers")
    caches = []
    for sl, cl in zip(self_groups, cross_groups):
        args = (cfg, self_paths, cross_paths, x, positions, img, *sl, *cl)
        if want_cache:
            x, k, v = _group(*args)
            caches.append((k, v))
        else:
            x = run_layer(_group_x, remat, *args)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), caches


def forward_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = True, image_embeds=None):
    """(B, S) tokens over ``image_embeds`` to (B, S, V) logits."""
    x, _ = _stack(params, cfg, tokens, image_embeds, remat)
    return x @ params["lm_head"].to(x.dtype)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            remat: bool = True) -> torch.Tensor:
    logits = forward_logits(params, cfg, batch["tokens"], remat,
                            image_embeds=batch["image_embeds"])
    return cross_entropy_loss(logits, batch["targets"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Tensor parallelism over the local ranks of a D x M mesh
# ---------------------------------------------------------------------------

def _gated(ax, gate, a):
    """``tanh(gate) * a`` of every rank (``gate`` a replicated scalar
    ``Act``)."""
    return shd.Act([torch.tanh(g) * x for g, x in zip(ax.like(gate, a),
                                                       a.xs)],
                   a.dims, a.layout)


def _group_tp(cfg, tp, paths, lls, positions, nr: int, *args):
    """One group for all local ranks: ``args`` is the ranks' streams, their
    image embeddings, then every rank's self leaves ``(4, ...)`` and
    every rank's cross leaves, in ``paths`` = ``(self, cross)`` order.
    Returns the ranks' streams."""
    ax = tp.axis
    xs, imgs, leaves = args[:nr], args[nr:2 * nr], args[2 * nr:]
    groups = []
    for part, (ps, ls) in enumerate(zip(paths, lls)):
        n = len(ps)
        lo = 0 if part == 0 else nr * len(paths[0])
        groups.append(tfm._leaf_acts(
            tp, ps, ls, [leaves[lo + r * n:lo + (r + 1) * n]
                         for r in range(nr)], 1))
    sp, cp = groups
    x = shd.Act(xs, "btd", tfm._stream(tp))
    for i in range(SELF_PER_GROUP):
        lp = T.unflatten((path, shd.Act([t[i] for t in a.xs], a.dims,
                                        a.layout))
                         for path, a in T.flatten(sp))
        x, _ = tfm._dense_layer_tp(cfg, tp, lp, x, positions)
    mem = attn.project_memory_tp(ax, cp["xattn"], cfg,
                                 shd.Act(imgs, "btd"))
    h = attn._norm_tp(ax, x, cp["norm1"], cfg.norm_eps)
    a = shd.act_btd(attn.cross_attention_tp(ax, cp["xattn"], cfg, h, mem),
                    ax)
    x = tfm._add(x, _gated(ax, cp["gate_attn"], a))
    h = attn._norm_tp(ax, x, cp["norm2"], cfg.norm_eps)
    y = shd.act_btd(tfm._ffn_tp(ax, cp["ffn"], h), ax)
    return tuple(tfm._add(x, _gated(ax, cp["gate_ffn"], y)).xs)


def loss_fn_tp(params: list, cfg: ModelConfig, batches: list, tp,
               remat: bool = True) -> list:
    """Per-rank losses of the VLM over the local ranks of a
    tensor-parallel mesh (``transformer.loss_fn_tp``'s contract): the
    self layers are the dense TP layer, each cross layer projects the
    image K/V on every rank's heads, and its attention and FFN outputs
    are summed over the model axis before their ``tanh`` gates (the
    reference's ``_cross_layer``).  Each data rank's image embeddings
    are shared by its model ranks.  With ``remat`` each group is one
    checkpoint around all ranks (the reference checkpoints
    ``group_body``)."""
    nr = len(params)
    top = tfm._top_tp(tp, params)
    x, positions = tfm._embed_stream_tp(cfg, tp, top, batches)
    imgs = [b["image_embeds"].to(dtype_of(cfg)) for b in batches]
    parts = ("self_layers", "cross_layers")
    slices = [[layer_slices(p, part) for p in params] for part in parts]
    paths = tuple(sl[0][0] for sl in slices)
    lls = tuple([T.get(tp.layout.leaves[part], path) for path in ps]
                for part, ps in zip(parts, paths))
    for g in range(_n_groups(cfg)):
        leaves = [leaf for sl in slices for _, per_group in sl
                  for leaf in per_group[g]]
        out = run_layer(_group_tp, remat, cfg, tp, paths, lls, positions,
                        nr, *x.xs, *imgs, *leaves)
        x = shd.Act(out, "btd", x.layout)
    return tfm._loss_head_tp(cfg, tp, top, x, batches)


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, image_embeds=None):
    """``(cache, logits (B, V))`` of the prompt's last token; the image
    k/v are projected once here and reused by every decode step."""
    b, s = tokens.shape
    x, caches = _stack(params, cfg, tokens, image_embeds, False,
                       want_cache=True)
    logits = x[:, -1] @ params["lm_head"].to(x.dtype)
    dtype = dtype_of(cfg)
    shape = (_n_groups(cfg), SELF_PER_GROUP, b, max_len, cfg.n_kv_heads,
             cfg.head_dim)
    full = {"k": torch.zeros(shape, dtype=dtype, device=x.device),
            "v": torch.zeros(shape, dtype=dtype, device=x.device)}
    for g, (k, v) in enumerate(caches):
        full["k"][g, :, :, :s] = k
        full["v"][g, :, :, :s] = v
    img = image_embeds.to(dtype)
    cross_paths, cross_groups = layer_slices(params, "cross_layers")
    mem = [attn.project_memory(T.unflatten(zip(cross_paths, cl))["xattn"],
                               cfg, img) for cl in cross_groups]
    full["img_k"] = torch.stack([k for k, _ in mem])
    full["img_v"] = torch.stack([v for _, v in mem])
    return full, logits


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict, token, pos):
    """One token per row at ``pos`` (scalar or ``(B,)``), its k/v written
    into ``cache`` in place: ``(cache, logits (B, V))``."""
    dev = params["embed"].device
    x = F.embedding(torch.as_tensor(token, device=dev).long(),
                    params["embed"])[:, None].to(dtype_of(cfg))
    pos = torch.as_tensor(pos, device=dev).long()
    self_paths, self_groups = layer_slices(params, "self_layers")
    cross_paths, cross_groups = layer_slices(params, "cross_layers")
    for g, (sl, cl) in enumerate(zip(self_groups, cross_groups)):
        for i, layer_leaves in enumerate(zip(*(t.unbind(0) for t in sl))):
            lp = T.unflatten(zip(self_paths, layer_leaves))
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            a, _ = attn.decode_self_attention(
                lp["attn"], cfg, h,
                attn.KVCache(cache["k"][g, i], cache["v"][g, i]), pos)
            x = x + a
            x = x + ffn(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
        x = _cross_layer(cfg, T.unflatten(zip(cross_paths, cl)), x,
                         (cache["img_k"][g], cache["img_v"][g]))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return cache, x[:, 0] @ params["lm_head"].to(x.dtype)
