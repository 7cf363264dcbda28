"""Shared neural building blocks, ported from ``repro/models/layers.py``.

Same expressions in the same order as the reference (float32 norms and
RoPE, SwiGLU, float32 cross-entropy).  Initializers take an explicit
``torch.Generator``: they do not reproduce ``jax.random``'s bits, so
tests that compare the two packages carry the reference's weights across
with ``repro_torch.convert``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import tree as T

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The parameter dtype named by ``cfg.dtype``."""
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}") from None


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, *, fan_in: int,
               std: float | None = None, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish): ``fan_in**-0.5 * N(0,1)``
    cut at ±2 (stacked layer weights pass the per-layer fan-in), or
    ``std * N(0, 1)`` cut at ±2 when ``std`` is given."""
    std = fan_in ** -0.5 if std is None else std
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: a stacked leaf at full width holds one float32
    # temporary, not two
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None
               ) -> torch.Tensor:
    """``0.02 * N(0, 1)``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


#: leaves the reference initializes to a constant, by name.
_CONSTANT_INIT = {"bq": 0.0, "bk": 0.0, "bv": 0.0, "dt_bias": 0.0,
                  "i_bias": 0.0, "bias": 0.0, "gate_attn": 0.0,
                  "gate_ffn": 0.0, "D": 1.0, "f_bias": 3.0,
                  "f_bias_extra": 3.0}
#: leaves whose truncated normal has a fixed std, not the fan-in's.
_FIXED_STD = {"conv_w": 0.5, "r_h": 0.05}


def init_leaf(gen: torch.Generator, name: str, shape, n_lead: int, dtype,
              device=None) -> torch.Tensor:
    """One parameter leaf by the reference's initializer for its ``name``
    (the last key of its path); ``n_lead`` leading dims stack layers (or
    groups), so the fan-in is that of ``shape[n_lead:]``.  Norm gains are
    ones, biases and VLM gates zeros, Mamba's ``A_log`` is ``log(1..n)``
    per channel, the embedding ``normal(0.02)``; every other weight is a
    truncated normal (:func:`dense_init`)."""
    if name == "embed":
        return embed_init(gen, shape, dtype, device)
    if name.startswith("norm") or name.endswith("norm"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name in _CONSTANT_INIT:
        return torch.full(shape, _CONSTANT_INIT[name], dtype=dtype,
                          device=device)
    if name == "A_log":
        n = shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                     device=device))
        return row.expand(shape).to(dtype).contiguous()
    per_layer = shape[n_lead:]
    return dense_init(gen, shape, dtype, fan_in=per_layer[0],
                      std=_FIXED_STD.get(name), device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def head_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    """Per-head qk-norm (qwen3): x (..., H, dh), gamma (dh,)."""
    return rmsnorm(x, gamma, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies, in float64 as the reference computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = torch.tensor(rope_frequencies(dh, theta), dtype=torch.float32,
                         device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN (SwiGLU)
# ---------------------------------------------------------------------------

def ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * (x W_up)) W_down``."""
    gate = F.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits (..., V), targets (...)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Layer stacks
# ---------------------------------------------------------------------------

def run_layer(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward pass with ``remat`` (the
    reference's ``jax.checkpoint`` around a layer)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def layer_slices(params: dict, key: str = "layers"):
    """The paths of ``params[key]``'s stacked leaves and, per layer, its
    leaves.  ``unbind``, not ``leaf[i]``: its backward stacks the L slice
    gradients once, where indexing would zero-fill and accumulate a full
    (L, ...) tensor per layer."""
    layer_items = T.flatten(params[key])
    paths = [p for p, _ in layer_items]
    return paths, list(zip(*(leaf.unbind(0) for _, leaf in layer_items)))
