"""Chunked online-softmax attention (flash-style) in plain PyTorch.

Ported from ``repro/models/flash.py`` (plain JAX there too: it is not a
Pallas kernel, so no kernel is owed).  Attention runs over
(q_chunk × k_chunk) tiles with the running-max / running-sum rescaling,
so no S×S score tensor exists; GQA grouping, causal masking and sliding
windows come from position arithmetic per tile.  The arithmetic is the
reference's, in float32, tile by tile and in the same order; it does not
call ``scaled_dot_product_attention``.

The reference also wraps each q-chunk body in ``jax.checkpoint``; here
the whole layer is recomputed in the backward pass (``transformer.py``),
which bounds the saved tiles to one layer's.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _tile_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(cq, ck) boolean mask from absolute positions."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= kp > qp - window
    return ok


def _divisor_at_most(n: int, c: int) -> int:
    c = min(c, n)
    while n % c:
        c -= 1
    return c


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    chunk_q: int = 512, chunk_k: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Sk, Hkv, dh).  H = G * Hkv.
    q token i has position q_offset + i, k token j has position j.
    Returns (B, Sq, H, dh)."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    cq = _divisor_at_most(sq, chunk_q)
    ck = _divisor_at_most(sk, chunk_k)
    nq, nk = sq // cq, sk // ck
    scale = dh ** -0.5
    f32 = torch.float32
    qg = q.reshape(b, nq, cq, hkv, g, dh).to(f32) * scale
    kc = k.reshape(b, nk, ck, hkv, dh).to(f32)
    vc = v.reshape(b, nk, ck, hkv, dh).to(f32)
    dev = q.device
    tiles = []
    for qi in range(nq):
        q_tile = qg[:, qi]                              # (B, cq, Hkv, G, dh)
        q_pos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=f32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, dh), dtype=f32, device=dev)
        for kj in range(nk):
            k_pos = kj * ck + torch.arange(ck, device=dev)
            s = torch.einsum("bqkgd,bckd->bkgqc", q_tile, kc[:, kj])
            mask = _tile_mask(q_pos, k_pos, causal, window)
            s = torch.where(mask[None, None, None], s,
                            torch.tensor(NEG_INF, dtype=f32, device=dev))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(s - m_new[..., None])
            l = l * alpha + pr.sum(-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("bkgqc,bckd->bkgqd", pr, vc[:, kj]))
            m = m_new
        tiles.append(acc / torch.clamp(l, min=1e-30)[..., None])
    # tiles: nq x (B, Hkv, G, cq, dh) -> (B, Sq, H, dh)
    out = torch.stack(tiles, dim=1).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(b, sq, h, dh).to(q.dtype)
