"""GQA attention for training, prefill and decode, ported from
``repro/models/attention.py``: full, sliding-window, non-causal
(encoder) and cross attention.

qk-norm (qwen3), QKV bias (qwen1.5), RoPE, the ``FLASH_THRESHOLD``
switch between the plain score-matrix path and chunked flash attention,
the KV cache's one-token decode (:func:`decode_self_attention`, one
offset for the whole batch or one per row), and cross attention over a
memory projected once (:func:`project_memory`: the encoder's output or
image embeddings, no RoPE, no mask, no bias).  Weights keep the
reference's layout: ``wq`` (d, H, dh), ``wk``/``wv`` (d, Hkv, dh),
``wo`` (H, dh, d), biases ``bq`` (H, dh), ``bk``/``bv`` (Hkv, dh).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ModelConfig
from .flash import flash_attention
from .layers import apply_rope, head_rmsnorm

NEG_INF = -1e30
FLASH_THRESHOLD = 1024  # use chunked online-softmax above this seq length


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, Hkv, dh)
    v: torch.Tensor


def causal_mask(s: int, window: int = 0, device=None) -> torch.Tensor:
    """(s, s) additive float32 mask: 0 where key <= query (and inside the
    window), -1e30 elsewhere."""
    q = torch.arange(s, device=device)[:, None]
    k = torch.arange(s, device=device)[None, :]
    ok = k <= q
    if window > 0:
        ok &= k > q - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def decode_mask(s_max: int, pos: torch.Tensor, window: int = 0
                ) -> torch.Tensor:
    """Additive float32 mask over a cache of length ``s_max`` for the one
    query at ``pos``: a 0-dim ``pos`` gives ``(1, s_max)``; a ``(B,)``
    ``pos`` (every row at its own offset) gives ``(B, 1, 1, 1, s_max)``,
    which broadcasts against :func:`sdpa`'s ``(b, k, g, s, t)`` scores."""
    k = torch.arange(s_max, device=pos.device)
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    neg = torch.full_like(zero, NEG_INF)
    if pos.ndim == 0:
        ok = k <= pos
        if window > 0:
            ok &= k > pos - window
        return torch.where(ok, zero, neg)[None, :]
    ok = k[None, :] <= pos[:, None]
    if window > 0:
        ok &= k[None, :] > (pos - window)[:, None]
    return torch.where(ok, zero, neg)[:, None, None, None, :]


def attention_shapes(cfg: ModelConfig, *, cross: bool = False) -> dict:
    """Shapes of one attention block's leaves (the reference's
    ``init_attention``): a cross-attention block has no QKV bias."""
    d, dh, h, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": (d, h, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh),
         "wo": (h, dh, d)}
    if cfg.qkv_bias and not cross:
        p.update(bq=(h, dh), bk=(hkv, dh), bv=(hkv, dh))
    if cfg.qk_norm:
        p.update(q_norm=(dh,), k_norm=(dh,))
    return p


def _project_q(p: dict, cfg: ModelConfig, x, positions):
    """Queries; RoPE unless ``positions`` is ``None`` (cross attention)."""
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if positions is None:
        return q
    return apply_rope(q, positions, cfg.rope_theta)


def _project_kv(p: dict, cfg: ModelConfig, x, positions):
    """Keys and values; RoPE on the keys unless ``positions`` is
    ``None`` (a cross-attention memory)."""
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is None:
        return k, v
    return apply_rope(k, positions, cfg.rope_theta), v


def sdpa(q, k, v, mask):
    """q: (B,S,H,dh), k/v: (B,T,Hkv,dh), mask broadcastable to (S,T) or,
    per row, (B,1,1,S,T).  GQA: H = G*Hkv.  Scores and softmax in
    float32."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, dh)
    scale = dh ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(b, s, h, dh).to(q.dtype)


def self_attention(p: dict, cfg: ModelConfig, x, positions, *,
                   causal: bool = True, window: int = 0):
    """Full-sequence self attention, causal unless ``causal=False`` (the
    encoder): ``(out, (k, v))``, the projected (roped) compact GQA
    ``k``/``v`` seeding a prefill's cache.  Chunked flash attention above
    ``FLASH_THRESHOLD`` tokens."""
    s = x.shape[1]
    q = _project_q(p, cfg, x, positions)
    k, v = _project_kv(p, cfg, x, positions)
    if s > FLASH_THRESHOLD:
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        mask = (causal_mask(s, window, x.device) if causal else
                torch.zeros((), dtype=torch.float32, device=x.device))
        out = sdpa(q, k, v, mask)
    return torch.einsum("bthk,hkd->btd", out, p["wo"]), (k, v)


def cross_attention(p: dict, cfg: ModelConfig, x, memory_kv):
    """``x`` (B, S, d) queries over ``memory_kv``, the ``(k, v)`` of
    :func:`project_memory` (no RoPE, no mask)."""
    q = _project_q(p, cfg, x, None)
    k, v = memory_kv
    mask = torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.einsum("bthk,hkd->btd", sdpa(q, k, v, mask), p["wo"])


def project_memory(p: dict, cfg: ModelConfig, memory):
    """Cross-attention ``(k, v)`` of an encoder output or image
    embeddings, projected once (no RoPE)."""
    return _project_kv(p, cfg, memory, None)


def decode_self_attention(p: dict, cfg: ModelConfig, x, cache: KVCache,
                          pos: torch.Tensor, window: int = 0):
    """One-token decode: ``x`` (B, 1, d) against ``cache`` (B, S_max, Hkv,
    dh).  ``pos`` is 0-dim (the whole batch at one offset: one-shot
    generation) or ``(B,)`` (each row at its own offset: continuous
    batching).  The token's projected k/v are written at ``pos`` IN
    PLACE (the reference returns a new cache; the values are the same)
    and attention runs over the whole cache under :func:`decode_mask`, so
    rows past ``pos`` get exactly zero probability.  Returns ``(out,
    cache)``."""
    b = x.shape[0]
    positions = pos.reshape(1, 1) if pos.ndim == 0 else pos[:, None]
    q = _project_q(p, cfg, x, positions)
    k_new, v_new = _project_kv(p, cfg, x, positions)
    if pos.ndim == 0:
        idx = pos.reshape(1)
        cache.k.index_copy_(1, idx, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, idx, v_new.to(cache.v.dtype))
    else:
        rows = torch.arange(b, device=pos.device)
        cache.k.index_put_((rows, pos), k_new[:, 0].to(cache.k.dtype))
        cache.v.index_put_((rows, pos), v_new[:, 0].to(cache.v.dtype))
    mask = decode_mask(cache.k.shape[1], pos, window)
    out = sdpa(q, cache.k, cache.v, mask)
    return torch.einsum("bthk,hkd->btd", out, p["wo"]), cache
