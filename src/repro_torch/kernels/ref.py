"""Plain PyTorch versions of the ported kernels (the oracles).

Each follows the expression order of the JAX package's
``repro/kernels/ref.py`` so that, on the same inputs, the results are
bitwise equal to the reference: one ⊕ per element, no reassociation.
A kernel wrapper takes its plain version only for tensors on the CPU;
``chip_smoke.py`` calls these directly on the card to hold each kernel
against them.

The int8 quantizer's constants are the reference's Python floats; each
enters the float32 arithmetic as its float32 rounding, as it does in
JAX: ``_INV127`` = 0x3c010204 (7.874015719e-03), ``_EPS`` = 0x0da24260
(1.000000003e-30).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: explicit reciprocal, as in ``repro/kernels/quantize.py``: one multiply
#: (not ``amax / 127``) is the same single IEEE op on every backend.
_INV127 = 1.0 / 127.0
_EPS = 1e-30

_OPS = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}


def block_reduce_ref(a: torch.Tensor, b: torch.Tensor, *, op: str = "add"
                     ) -> torch.Tensor:
    """Elementwise ``a ⊕ b`` (``repro.kernels.ref.block_reduce_ref``)."""
    try:
        fn = _OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}; have {sorted(_OPS)}"
                         ) from None
    return fn(a, b)


def fused_round_ref(live: torch.Tensor, received: torch.Tensor, *, nb: int,
                    next_lo: int, op: str = "add"
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One circulant reduce-scatter round: fold + keep/send split
    (``repro.kernels.ref.fused_round_ref``).  Returns ``(keep, send)``,
    ``send`` being ``None`` on the final round (``next_lo == lo``)."""
    lo = live.shape[0]
    head = block_reduce_ref(live[:nb], received, op=op)
    new = torch.cat([head, live[nb:lo]], dim=0)
    if next_lo == lo:
        return new, None
    return new[:next_lo], new[next_lo:lo]


def permute_rows_ref(x: torch.Tensor, perm) -> torch.Tensor:
    """Static row permutation ``out[i] = x[perm[i]]``
    (``repro.kernels.ref.permute_rows_ref``)."""
    idx = torch.tensor([int(i) for i in perm], dtype=torch.long,
                       device=x.device)
    return x[idx]


def _pad_cols(x: torch.Tensor, g: int) -> torch.Tensor:
    pc = (-x.shape[1]) % g
    return F.pad(x, (0, pc)) if pc else x


def quantize_ref(x: torch.Tensor, *, group: int = 512
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(row, group) quantization
    (``repro.kernels.ref.quantize_ref``): ``scale = amax * _INV127 +
    _EPS``, ``codes = clip(round(x / scale), ±127)``, rounding half to
    even.  Returns ``codes`` of ``x.shape`` and ``scales`` of ``(rows,
    ceil(cols / g))``, ``g = min(group, cols)``; the ragged last group is
    zero-padded (zeros never raise an amax)."""
    rows, cols = x.shape
    g = min(group, cols)
    xp = _pad_cols(x.to(torch.float32), g)
    xg = xp.reshape(rows, -1, g)
    amax = torch.amax(torch.abs(xg), dim=2)                  # (rows, ng)
    scale = amax * _INV127 + _EPS
    q = torch.clamp(torch.round(xg / scale[..., None]), -127, 127)
    codes = q.reshape(rows, xp.shape[1]).to(torch.int8)
    return codes[:, :cols], scale


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor, *,
                group: int = 512) -> torch.Tensor:
    """``codes * scale`` in float32 (``repro.kernels.ref.dequant_ref``)."""
    rows, cols = codes.shape
    g = min(group, cols)
    qp = _pad_cols(codes.to(torch.float32), g)
    qg = qp.reshape(rows, -1, g)
    return (qg * scales[..., None]).reshape(rows, qp.shape[1])[:, :cols]


def dequant_add_ref(acc: torch.Tensor, codes: torch.Tensor,
                    scales: torch.Tensor, *, group: int = 512
                    ) -> torch.Tensor:
    """``(acc.f32 + codes * scale).astype(acc.dtype)``: two roundings,
    the product's and the sum's (``repro.kernels.ref.dequant_add_ref``)."""
    return (acc.to(torch.float32)
            + dequant_ref(codes, scales, group=group)).to(acc.dtype)


def fused_round_dq_ref(live: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, *, nb: int, next_lo: int,
                       op: str = "add", group: int = 512
                       ) -> tuple[torch.Tensor,
                                  tuple[torch.Tensor, torch.Tensor] | None]:
    """One compressed circulant round (``repro.kernels.ref.
    fused_round_dq_ref``): dequantize the received ``(codes, scales)``,
    ⊕-fold them into the float32 head ``live[:nb]``, keep rows
    ``[0, next_lo)`` and requantize rows ``[next_lo, lo)`` as the next
    send.  Returns ``(keep, (send_codes, send_scales))``, the pair
    ``None`` on the final round (``next_lo == lo``)."""
    lo = live.shape[0]
    deq = dequant_ref(codes, scales, group=group)
    head = block_reduce_ref(live[:nb].to(torch.float32), deq, op=op)
    new = torch.cat([head, live[nb:lo].to(torch.float32)], dim=0)
    if next_lo == lo:
        return new, None
    send_codes, send_scales = quantize_ref(new[next_lo:lo], group=group)
    return new[:next_lo], (send_codes, send_scales)
