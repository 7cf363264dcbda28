"""Public wrappers around the port's elementwise kernels, ported from
``repro/kernels/ops.py``.

They take payloads of any rank (flattened to 2-D ``(leading, rest)`` as
the reference's ``_to2d`` does) and any shape: the kernels bound the
ragged edge themselves, so nothing is padded here.  A tensor on a card
runs the kernel, a tensor on the CPU its plain version.
:func:`make_compressors` builds the plan's per-round ``compress=`` /
``decompress=`` hooks from :func:`quantize_blocks` and
:func:`dequantize_blocks`.
"""
from __future__ import annotations

import collections

import torch

from . import ref as _ref
from .block_reduce import block_reduce
from .quantize import DEFAULT_GROUP, dequant_add, quantize


def _to2d(x: torch.Tensor) -> tuple[torch.Tensor, torch.Size]:
    """Flatten anything to 2-D ``(leading, rest)``; 0-D and 1-D inputs
    become one row."""
    if x.ndim == 2:
        return x.contiguous(), x.shape
    if x.ndim < 2:
        return x.reshape(1, -1).contiguous(), x.shape
    return x.reshape(x.shape[0], -1).contiguous(), x.shape


def fused_block_reduce(a: torch.Tensor, b: torch.Tensor, *,
                       op: str = "add") -> torch.Tensor:
    """``a ⊕ b`` (any shape, any rank) through the ``block_reduce``
    kernel."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    a2, shape = _to2d(a)
    b2, _ = _to2d(b)
    return block_reduce(a2, b2, op=op).reshape(shape)


def quantize_blocks(x: torch.Tensor, *, group: int = DEFAULT_GROUP) -> dict:
    """int8-quantize a payload of any rank: ``{"codes", "scales",
    "meta"}``, ``codes`` of the flattened 2-D shape and ``meta`` the
    ``(shape, cols, g)`` that :func:`dequantize_blocks` needs."""
    x2, shape = _to2d(x)
    cols = x2.shape[1]
    g = min(group, cols)
    codes, scales = quantize(x2, group=g)
    return {"codes": codes, "scales": scales, "meta": (shape, cols, g)}


def dequantize_blocks(payload: dict) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: ``codes * scale`` in float32,
    in the original shape (the plain version on every device, as in the
    reference)."""
    shape, _, g = payload["meta"]
    x = _ref.dequant_ref(payload["codes"], payload["scales"], group=g)
    return x.reshape(shape)


def dequant_accumulate(acc: torch.Tensor, payload: dict) -> torch.Tensor:
    """Fused ``acc + dequant(payload)`` (the compressed ⊕) through the
    ``dequant_add`` kernel, in ``acc``'s dtype and shape."""
    shape, _, g = payload["meta"]
    acc2, _ = _to2d(acc)
    out = dequant_add(acc2, payload["codes"], payload["scales"], group=g)
    return out.reshape(shape)


def make_compressors(group: int = DEFAULT_GROUP):
    """``(compress, decompress)`` for the circulant reduce-scatter's
    per-round hooks (``CollectivePlan.reduce_scatter(..., compress=,
    decompress=)``): ``compress`` int8-quantizes a round's send payload
    (the ``quantize`` kernel on a card) to ``{"codes", "scales"}``, each
    tensor one exchange, and ``decompress`` turns what arrived back into
    float32 (:func:`dequantize_blocks`).  The static ``meta`` must not
    travel, so it waits in a queue between the two: payloads are
    decompressed in the order they were compressed, one-shot (every
    local rank's send, then every rank's receive) and pipelined (payload
    b's sends are compressed before payload b-1's receives are
    decompressed, so the queue holds both, in order; the reference's
    one-slot cell would hand b-1 the meta of b)."""
    metas: collections.deque = collections.deque()

    def compress(x: torch.Tensor) -> dict:
        payload = quantize_blocks(x, group=group)
        metas.append(payload.pop("meta"))
        return payload

    def decompress(payload: dict) -> torch.Tensor:
        return dequantize_blocks(dict(payload, meta=metas.popleft()))

    return compress, decompress
