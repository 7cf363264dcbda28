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

:func:`self_attention_tp` is the tensor-parallel form (``models/
sharding.py``): every local rank of a mesh at once, each with its blocks
of the leaves, the reference's hooks (``act_bthd``) where its
``self_attention`` has them, and :func:`_maybe_expand_gqa` (the
reference's §Perf B) where kv heads do not divide the model axis;
:func:`cross_attention_tp` and :func:`project_memory_tp` are those of
cross attention (the VLM's image layers).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import sharding as shd
from .config import ModelConfig
from .flash import flash_attention
from .layers import apply_rope, head_rmsnorm, rmsnorm

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


def _expands_gqa(cfg: ModelConfig, recipe) -> bool:
    """The reference's condition for expanding kv heads: asked for, the
    model axis's size known, kv heads not dividing it but query heads
    doing so."""
    if recipe is None or not getattr(recipe, "expand_gqa", False):
        return False
    tp = getattr(recipe, "tp_size", 0)
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    return bool(tp) and hkv % tp != 0 and h % tp == 0 and h != hkv


def _maybe_expand_gqa(k, v, cfg: ModelConfig, recipe):
    """§Perf B: when kv heads do not divide the model axis but full heads
    do, repeat every kv head over its query group, so that every
    attention tensor keeps one head sharding (H/tp).  ``k``/``v``:
    ``(B, T, Hkv, dh)`` whole."""
    if not _expands_gqa(cfg, recipe):
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    return (torch.repeat_interleave(k, g, dim=2),
            torch.repeat_interleave(v, g, dim=2))


def _attend(q, k, v, causal: bool, window: int):
    s = q.shape[1]
    if s > FLASH_THRESHOLD:
        return flash_attention(q, k, v, causal=causal, window=window)
    mask = (causal_mask(s, window, q.device) if causal else
            torch.zeros((), dtype=torch.float32, device=q.device))
    return sdpa(q, k, v, mask)


def _kv_for_heads(kv: torch.Tensor, lo: int, hq: int, g: int):
    """The kv heads query heads ``[lo, lo + hq)`` map to (group size
    ``g``): a contiguous run when the local heads group evenly, else one
    kv head per query head."""
    idx = [(lo + i) // g for i in range(hq)]
    n = idx[-1] - idx[0] + 1
    if hq % n == 0 and idx == [idx[0] + i // (hq // n) for i in range(hq)]:
        return kv.narrow(2, idx[0], n)
    return kv.index_select(2, torch.tensor(idx, device=kv.device))


def _core_tp(tp, cfg: ModelConfig, q, k, v, attend):
    """``attend(q, k, v)`` of every rank by the layouts the hooks left:
    local query heads over local kv heads; local query heads over whole
    kv, each rank taking the kv heads its own query heads map to; or
    whole heads on every rank."""
    if q.layout != "h":
        q, k, v = tp.whole(q), tp.whole(k), tp.whole(v)
        return q, [attend(a, b, c) for a, b, c in zip(q.xs, k.xs, v.xs)]
    if k.layout == "h" and v.layout == "h":
        ks, vs = k.xs, v.xs
    else:
        k, v = tp.whole(k), tp.whole(v)
        hq = q.xs[0].shape[2]
        g = cfg.n_heads // k.xs[0].shape[2]
        ks, vs = [], []
        for kk, vv, c in zip(tp.entering(k), tp.entering(v), tp.comm.ranks):
            ks.append(_kv_for_heads(kk, c * hq, hq, g))
            vs.append(_kv_for_heads(vv, c * hq, hq, g))
    return q, [attend(a, b, c) for a, b, c in zip(q.xs, ks, vs)]


def _norm_tp(tp, x, gamma, eps: float):
    """RMS norm over ``x``'s last dim, which must be whole on a rank."""
    if x.layout in (shd.PARTIAL, x.dims[-1]):
        x = tp.whole(x)
    return shd.Act([rmsnorm(a, w, eps) for a, w in
                    zip(x.xs, tp.like(gamma, x))], x.dims, x.layout)


def _project_tp(tp, p: dict, cfg: ModelConfig, x, positions, w: str,
                b: str, norm: str | None):
    """``_project_q`` / ``_project_kv``'s steps for one of q, k, v: the
    projection, its bias, its qk-norm, RoPE (not with ``positions``
    ``None``: the values)."""
    y = shd.project(tp, x, p[w], "btd,dhk->bthk")
    if b in p:
        if y.layout == shd.PARTIAL:
            y = tp.whole(y)
        y = shd.Act([a + c for a, c in zip(y.xs, tp.like(p[b], y))],
                    y.dims, y.layout)
    if norm is not None and cfg.qk_norm:
        y = _norm_tp(tp, y, p[norm], cfg.norm_eps)
    if positions is None:
        return y
    if y.layout in (shd.PARTIAL, "t", "k"):
        y = tp.whole(y)
    return shd.Act([apply_rope(a, positions, cfg.rope_theta)
                    for a in y.xs], y.dims, y.layout)


def self_attention_tp(tp, p: dict, cfg: ModelConfig, x, positions, *,
                      causal: bool = True, window: int = 0):
    """:func:`self_attention` of every local rank of a tensor-parallel
    mesh: ``p`` maps each leaf name to its per-rank blocks
    (``sharding.Act``), ``x`` is the normed stream (an ``Act``).  Returns
    the output projection's ``Act`` (partial sums where ``wo``'s
    contracted heads are split; the caller's ``act_btd`` sums them) and
    the compact ``(k, v)`` Acts."""
    q = _project_tp(tp, p, cfg, x, positions, "wq", "bq", "q_norm")
    k = _project_tp(tp, p, cfg, x, positions, "wk", "bk", "k_norm")
    v = _project_tp(tp, p, cfg, x, None, "wv", "bv", None)
    k_c, v_c = k, v
    if _expands_gqa(cfg, tp.recipe):
        k_c, v_c = tp.whole(k), tp.whole(v)
        pairs = [_maybe_expand_gqa(a, b, cfg, tp.recipe)
                 for a, b in zip(k_c.xs, v_c.xs)]
        k_c = shd.Act([a for a, _ in pairs], "bthk")
        v_c = shd.Act([b for _, b in pairs], "bthk")
    q = shd.act_bthd(q, tp)
    k_c = shd.act_bthd(k_c, tp)
    v_c = shd.act_bthd(v_c, tp)
    q, outs = _core_tp(tp, cfg, q, k_c, v_c,
                       lambda a, b, c: _attend(a, b, c, causal, window))
    out = shd.act_bthd(shd.Act(outs, "bthk", q.layout), tp)
    return shd.project(tp, out, p["wo"], "bthk,hkd->btd"), (k, v)


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


def project_memory_tp(tp, p: dict, cfg: ModelConfig, memory):
    """:func:`project_memory` of every local rank of a tensor-parallel
    mesh (``memory`` an ``Act``, whole on every model rank): each rank
    projects the heads of its ``wk`` / ``wv`` blocks, no RoPE.  Returns
    the ``(k, v)`` Acts."""
    return (_project_tp(tp, p, cfg, memory, None, "wk", "bk", "k_norm"),
            _project_tp(tp, p, cfg, memory, None, "wv", "bv", None))


def cross_attention_tp(tp, p: dict, cfg: ModelConfig, x, memory_kv):
    """:func:`cross_attention` of every local rank: queries of the normed
    stream ``x`` (an ``Act``) over the ``(k, v)`` Acts of
    :func:`project_memory_tp`, no RoPE and no mask, each rank its own
    heads where ``wq`` is split on them.  Returns the output
    projection's ``Act`` (partial sums where ``wo``'s heads are split;
    the caller's ``act_btd`` sums them)."""
    q = _project_tp(tp, p, cfg, x, None, "wq", "bq", "q_norm")
    k, v = memory_kv
    zero = torch.zeros((), dtype=torch.float32, device=q.xs[0].device)
    q, outs = _core_tp(tp, cfg, q, k, v, lambda a, b, c: sdpa(a, b, c, zero))
    return shd.project(tp, shd.Act(outs, "bthk", q.layout), p["wo"],
                       "bthk,hkd->btd")


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
