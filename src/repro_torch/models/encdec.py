"""Whisper-style encoder-decoder, ported from ``repro/models/encdec.py``.

The conv frontend is a stub, as in the reference: ``frames`` holds
precomputed frame embeddings ``(B, S_enc, d_model)``.  The encoder is a
non-causal self-attention stack; the decoder runs causal self
attention, cross attention to the encoded frames and a SwiGLU FFN over
the text tokens.  Layer weights are stacked along a leading axis
(``enc_layers.*`` ``(E, ...)``, ``dec_layers.*`` ``(L, ...)``) and run
in a loop, each layer recomputed in the backward pass with ``remat``.
The cache holds each decoder layer's self-attention k/v, padded to
``max_len`` decoder positions, and the memory's projected
``mem_k``/``mem_v`` (computed once at prefill).  The tensor-parallel
form (:func:`encode_tp`, :func:`loss_fn_tp`) runs every local rank of a
``D x M`` mesh together, as the dense family's does, each decoder layer
projecting its heads of the memory.
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


def _ffn_shapes(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's leaves)."""
    d, E, L = cfg.d_model, cfg.enc_layers, cfg.n_layers

    def stack(n, shapes):
        return {k: (stack(n, v) if isinstance(v, dict) else (n, *v))
                for k, v in shapes.items()}

    enc = {"norm1": (d,), "norm2": (d,), "attn": attn.attention_shapes(cfg),
           "ffn": _ffn_shapes(cfg)}
    dec = {"norm1": (d,), "norm_x": (d,), "norm2": (d,),
           "attn": attn.attention_shapes(cfg),
           "xattn": attn.attention_shapes(cfg, cross=True),
           "ffn": _ffn_shapes(cfg)}
    return {"enc_layers": stack(E, enc), "enc_norm": (d,),
            "dec_layers": stack(L, dec), "embed": (cfg.vocab_size, d),
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
    draws = ((path, init_leaf(gen, path[-1], shape,
                              int(path[0] in ("enc_layers", "dec_layers")),
                              dtype, device))
             for path, shape in T.flatten(param_shapes(cfg)))
    if split is None:
        return T.unflatten(draws)
    return tfm.split_draws(draws, split)


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _enc_layer(cfg, paths, x, *leaves):
    lp = T.unflatten(zip(paths, leaves))
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    a, _ = attn.self_attention(lp["attn"], cfg, h, _positions(x),
                               causal=False)
    x = x + a
    return x + ffn(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))


def encode(params: dict, cfg: ModelConfig, frames, remat: bool = True):
    """frames: (B, S_enc, d_model) stub embeddings -> encoded memory."""
    x = frames.to(dtype_of(cfg))
    paths, per_layer = layer_slices(params, "enc_layers")
    for leaves in per_layer:
        x = run_layer(_enc_layer, remat, cfg, paths, x, *leaves)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(cfg, paths, x, memory, *leaves):
    """One decoder layer: ``(x, k, v, mem_k, mem_v)``."""
    lp = T.unflatten(zip(paths, leaves))
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    a, (k, v) = attn.self_attention(lp["attn"], cfg, h, _positions(x))
    x = x + a
    mem_k, mem_v = attn.project_memory(lp["xattn"], cfg, memory)
    x = x + attn.cross_attention(
        lp["xattn"], cfg, rmsnorm(x, lp["norm_x"], cfg.norm_eps),
        (mem_k, mem_v))
    x = x + ffn(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    return x, k, v, mem_k, mem_v


def _decoder(params, cfg, tokens, memory, remat: bool, want_cache=False):
    x = F.embedding(tokens.long(), params["embed"]).to(dtype_of(cfg))
    paths, per_layer = layer_slices(params, "dec_layers")
    caches = []
    for leaves in per_layer:
        if want_cache:
            x, *kv = _dec_layer(cfg, paths, x, memory, *leaves)
            caches.append(kv)
        else:
            x = run_layer(_dec_layer_x, remat, cfg, paths, x, memory,
                          *leaves)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), caches


def _dec_layer_x(cfg, paths, x, memory, *leaves):
    return _dec_layer(cfg, paths, x, memory, *leaves)[0]


def forward_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = True, frames=None):
    """(B, S) decoder tokens over ``frames`` to (B, S, V) logits."""
    memory = encode(params, cfg, frames, remat)
    x, _ = _decoder(params, cfg, tokens, memory, remat)
    return x @ params["lm_head"].to(x.dtype)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            remat: bool = True) -> torch.Tensor:
    logits = forward_logits(params, cfg, batch["tokens"], remat,
                            frames=batch["frames"])
    return cross_entropy_loss(logits, batch["targets"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Tensor parallelism over the local ranks of a D x M mesh
# ---------------------------------------------------------------------------

def _layer_acts(tp, paths, lls, nr: int, leaves) -> dict:
    n = len(paths)
    return tfm._leaf_acts(tp, paths, lls, [leaves[r * n:(r + 1) * n]
                                           for r in range(nr)], 1)


def _enc_layer_tp(cfg, tp, paths, lls, positions, nr: int, *args):
    """One encoder layer for all local ranks (the dense family's layer,
    non-causal): ``args`` is the ranks' streams, then each rank's layer
    leaves in ``paths`` order."""
    lp = _layer_acts(tp, paths, lls, nr, args[nr:])
    x, _ = tfm._dense_layer_tp(cfg, tp, lp, shd.Act(args[:nr], "btd",
                                                     tfm._stream(tp)),
                               positions, causal=False)
    return tuple(x.xs)


def _dec_layer_tp(cfg, tp, paths, lls, positions, nr: int, mem_layout,
                  *args):
    """One decoder layer for all local ranks: ``args`` is the ranks'
    streams, their memories (laid out ``mem_layout``), then each rank's
    layer leaves in ``paths`` order."""
    ax = tp.axis
    lp = _layer_acts(tp, paths, lls, nr, args[2 * nr:])
    x = shd.Act(args[:nr], "btd", tfm._stream(tp))
    h = attn._norm_tp(ax, x, lp["norm1"], cfg.norm_eps)
    x = tfm._add(x, tfm._mixer_tp(cfg, ax, lp, h, positions))
    mem = attn.project_memory_tp(ax, lp["xattn"], cfg,
                                 shd.Act(args[nr:2 * nr], "btd", mem_layout))
    h = attn._norm_tp(ax, x, lp["norm_x"], cfg.norm_eps)
    x = tfm._add(x, shd.act_btd(attn.cross_attention_tp(
        ax, lp["xattn"], cfg, h, mem), ax))
    h = attn._norm_tp(ax, x, lp["norm2"], cfg.norm_eps)
    return tuple(tfm._add(x, shd.act_btd(tfm._ffn_tp(ax, lp["ffn"], h),
                                         ax)).xs)


def _stack_tp(tp, params: list, part: str):
    """``part``'s per-layer leaves of every rank, their paths and
    layouts."""
    slices = [layer_slices(p, part) for p in params]
    paths = slices[0][0]
    lls = [T.get(tp.layout.leaves[part], path) for path in paths]
    return paths, lls, [[leaf for _, per in slices for leaf in per[i]]
                        for i in range(len(slices[0][1]))]


def encode_tp(params: list, cfg: ModelConfig, frames: list, tp,
              remat: bool = True):
    """:func:`encode` of every local rank of a tensor-parallel mesh
    (``frames``: each rank's, the model ranks of a data rank sharing
    theirs): non-causal self attention and the FFN over the layouts, each
    layer one checkpoint around all ranks with ``remat``.  Returns the
    memory as an ``Act`` (split on the frames when sequence-parallel)."""
    nr = len(params)
    x = shd.act_btd(shd.Act([f.to(dtype_of(cfg)) for f in frames], "btd"),
                    tp.axis)
    b, s = frames[0].shape[:2]
    positions = torch.arange(s, device=frames[0].device).expand(b, s)
    paths, lls, per_layer = _stack_tp(tp, params, "enc_layers")
    for leaves in per_layer:
        x = shd.Act(run_layer(_enc_layer_tp, remat, cfg, tp, paths, lls,
                              positions, nr, *x.xs, *leaves), "btd",
                    x.layout)
    norm = tfm._leaf_acts(tp, [("enc_norm",)], [tp.layout.leaves["enc_norm"]],
                          [[p["enc_norm"]] for p in params], 0)
    return attn._norm_tp(tp.axis, x, norm["enc_norm"], cfg.norm_eps)


def loss_fn_tp(params: list, cfg: ModelConfig, batches: list, tp,
               remat: bool = True) -> list:
    """Per-rank losses of the encoder-decoder over the local ranks of a
    tensor-parallel mesh (``transformer.loss_fn_tp``'s contract): the
    frames encoded by :func:`encode_tp`, then every decoder layer's causal
    self attention, cross attention over the memory (each rank projecting
    its heads of ``mem_k`` / ``mem_v``, ``attention.project_memory_tp``)
    and FFN, each layer one checkpoint around all ranks with ``remat``;
    the embedding, head and loss as the dense family's."""
    nr = len(params)
    memory = encode_tp(params, cfg, [b["frames"] for b in batches], tp,
                       remat)
    top = tfm._top_tp(tp, params)
    x, positions = tfm._embed_stream_tp(cfg, tp, top, batches)
    paths, lls, per_layer = _stack_tp(tp, params, "dec_layers")
    for leaves in per_layer:
        x = shd.Act(run_layer(_dec_layer_tp, remat, cfg, tp, paths, lls,
                              positions, nr, memory.layout, *x.xs,
                              *memory.xs, *leaves), "btd", x.layout)
    return tfm._loss_head_tp(cfg, tp, top, x, batches)


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int, frames=None):
    """Encode ``frames`` and run the decoder prompt: ``(cache, logits (B,
    V))``, the cache's ``k``/``v`` ``(L, B, max(max_len, S), Hkv, dh)``
    with the prompt in rows ``[0, S)``, and ``mem_k``/``mem_v`` ``(L, B,
    S_enc, Hkv, dh)``."""
    b, s = tokens.shape
    memory = encode(params, cfg, frames, remat=False)
    x, caches = _decoder(params, cfg, tokens, memory, False, want_cache=True)
    logits = x[:, -1] @ params["lm_head"].to(x.dtype)
    dtype = dtype_of(cfg)
    shape = (cfg.n_layers, b, max(max_len, s), cfg.n_kv_heads, cfg.head_dim)
    full = {"k": torch.zeros(shape, dtype=dtype, device=x.device),
            "v": torch.zeros(shape, dtype=dtype, device=x.device)}
    for i, (k, v, _, _) in enumerate(caches):
        full["k"][i, :, :s] = k
        full["v"][i, :, :s] = v
    full["mem_k"] = torch.stack([c[2] for c in caches])
    full["mem_v"] = torch.stack([c[3] for c in caches])
    return full, logits


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict, token, pos):
    """One decoder token per row at ``pos`` (scalar or ``(B,)``), its k/v
    written into ``cache`` in place: ``(cache, logits (B, V))``."""
    dev = params["embed"].device
    x = F.embedding(torch.as_tensor(token, device=dev).long(),
                    params["embed"])[:, None].to(dtype_of(cfg))
    pos = torch.as_tensor(pos, device=dev).long()
    paths, per_layer = layer_slices(params, "dec_layers")
    for i, leaves in enumerate(per_layer):
        lp = T.unflatten(zip(paths, leaves))
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        a, _ = attn.decode_self_attention(
            lp["attn"], cfg, h, attn.KVCache(cache["k"][i], cache["v"][i]),
            pos)
        x = x + a
        x = x + attn.cross_attention(
            lp["xattn"], cfg, rmsnorm(x, lp["norm_x"], cfg.norm_eps),
            (cache["mem_k"][i], cache["mem_v"][i]))
        x = x + ffn(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return cache, x[:, 0] @ params["lm_head"].to(x.dtype)
