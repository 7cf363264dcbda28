"""Decoder-only LM, dense family, ported from ``repro/models/transformer.py``.

Parameters keep the reference's layout: a nested dict whose layer
weights are STACKED along a leading ``n_layers`` axis (``layers.attn.wq``
is ``(L, d, H, dh)``, ``layers.ffn.w_gate`` is ``(L, d, d_ff)``), because
ZeRO-1 shards each leaf along dim 0 and must pad, shard and hand the
kernel the same shapes as the reference.  The forward pass loops over
the layer index (the reference's ``lax.scan``) and, with ``remat``,
recomputes each layer in the backward pass (``torch.utils.checkpoint``
in place of ``jax.checkpoint``).  MoE, hybrid and the cache paths
(prefill / decode) are not ported yet (ROADMAP.md queue 1 items 8, 12,
13).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import tree as T
from . import attention as attn
from .config import ModelConfig
from .layers import (cross_entropy_loss, dense_init, dtype_of, embed_init, ffn,
                     rmsnorm)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_moe or cfg.qkv_bias:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family without QKV bias is ported "
            f"yet (ROADMAP.md queue 1 item 13)")


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's leaves)."""
    _check_dense(cfg)
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    attn_p = {"wq": (L, d, h, dh), "wk": (L, d, hkv, dh),
              "wv": (L, d, hkv, dh), "wo": (L, h, dh, d)}
    if cfg.qk_norm:
        attn_p.update(q_norm=(L, dh), k_norm=(L, dh))
    shapes = {
        "embed": (cfg.vocab_size, d),
        "layers": {"norm1": (L, d), "norm2": (L, d), "attn": attn_p,
                   "ffn": {"w_gate": (L, d, cfg.d_ff), "w_up": (L, d, cfg.d_ff),
                           "w_down": (L, cfg.d_ff, d)}},
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters from ``gen`` (on ``gen``'s device): truncated-normal
    fan-in weights (fan-in of the per-layer shape), ``normal(0.02)``
    embedding, ones for norm gains — the reference's initializers."""
    dtype = dtype_of(cfg)
    out: dict = {}
    for path, shape in T.flatten(param_shapes(cfg)):
        name = path[-1]
        if name == "embed":
            val = embed_init(gen, shape, dtype, device)
        elif name.startswith("norm") or name.endswith("norm"):
            val = torch.ones(shape, dtype=dtype, device=device)
        else:
            per_layer = shape[1:] if path[0] == "layers" else shape
            val = dense_init(gen, shape, dtype, fan_in=per_layer[0],
                             device=device)
        T.assign(out, path, val)
    return out


def _layer_forward(cfg: ModelConfig, paths, x, positions, *leaves):
    lp = T.unflatten(zip(paths, leaves))
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    x = x + attn.self_attention(lp["attn"], cfg, h, positions,
                                window=cfg.sliding_window)
    return x + ffn(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))


def forward_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = True) -> torch.Tensor:
    """(B, S) token ids to (B, S, V) logits in the parameter dtype."""
    _check_dense(cfg)
    b, s = tokens.shape
    x = F.embedding(tokens.long(), params["embed"]).to(dtype_of(cfg))
    positions = torch.arange(s, device=x.device).expand(b, s)
    layer_items = T.flatten(params["layers"])
    paths = [p for p, _ in layer_items]
    # unbind, not leaf[i]: its backward stacks the L slice gradients once,
    # where indexing would zero-fill and accumulate a full (L, ...) tensor
    # per layer.
    per_layer = list(zip(*(leaf.unbind(0) for _, leaf in layer_items)))
    for i in range(cfg.n_layers):
        leaves = per_layer[i]
        if remat:
            x = checkpoint(_layer_forward, cfg, paths, x, positions, *leaves,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_forward(cfg, paths, x, positions, *leaves)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            remat: bool = True) -> torch.Tensor:
    """Causal-LM loss: mean token cross-entropy (float32)."""
    logits = forward_logits(params, cfg, batch["tokens"], remat)
    return cross_entropy_loss(logits, batch["targets"], batch.get("mask"))
