"""Plain PyTorch versions of the ported kernels (the oracles).

Each follows the expression order of the JAX package's
``repro/kernels/ref.py`` so that, on the same inputs, the results are
bitwise equal to the reference: one ⊕ per element, no reassociation.
A kernel wrapper takes its plain version only for tensors on the CPU;
``chip_smoke.py`` calls these directly on the card to hold each kernel
against them.
"""
from __future__ import annotations

import torch

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
