"""GQA self-attention for training, ported from ``repro/models/attention.py``.

qk-norm (qwen3), RoPE, and the ``FLASH_THRESHOLD`` switch between the
plain score-matrix path and chunked flash attention.
Weights keep the reference's layout: ``wq`` (d, H, dh), ``wk``/``wv``
(d, Hkv, dh), ``wo`` (H, dh, d).  QKV bias (qwen1.5), the KV cache,
cross-attention and decode belong to later slices (ROADMAP.md queue 1
items 12-13).
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .flash import flash_attention
from .layers import apply_rope, head_rmsnorm

NEG_INF = -1e30
FLASH_THRESHOLD = 1024  # use chunked online-softmax above this seq length


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


def _project_q(p: dict, cfg: ModelConfig, x, positions):
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta)


def _project_kv(p: dict, cfg: ModelConfig, x, positions):
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if cfg.qk_norm:
        k = head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_theta), v


def sdpa(q, k, v, mask):
    """q: (B,S,H,dh), k/v: (B,T,Hkv,dh), mask broadcastable to (S,T).
    GQA: H = G*Hkv.  Scores and softmax in float32."""
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
                   window: int = 0):
    """Full-sequence causal self attention (the reference's also returns
    k/v to seed a cache; no cache here).  Chunked flash attention above
    ``FLASH_THRESHOLD`` tokens."""
    s = x.shape[1]
    q = _project_q(p, cfg, x, positions)
    k, v = _project_kv(p, cfg, x, positions)
    if s > FLASH_THRESHOLD:
        out = flash_attention(q, k, v, causal=True, window=window)
    else:
        out = sdpa(q, k, v, causal_mask(s, window, x.device))
    return torch.einsum("bthk,hkd->btd", out, p["wo"])
