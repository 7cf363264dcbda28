"""Elementwise ``a ⊕ b`` on the card: the ⊕ of Algorithm 1 as one pass.

CUDA kernel ``csrc/block_reduce.cu``; replaces the Pallas TPU kernel
``repro/kernels/block_reduce.py:block_reduce``.  Bound by bytes (``a``
and ``b`` read once, the result written once, one ⊕ per element): each
thread folds one or two 8-byte vectors of a contiguous chunk, loaded and
stored past the caches.  The ⊕ is ``fused_round``'s
(``csrc/reduce_ops.cuh``: NaN operands returned as they are, bf16 added
in float and rounded once, int32 wrapping), so it is bitwise
``torch.add`` / ``maximum`` / ``minimum``.  The TPU kernel's tile grid,
and the padding to whole tiles it needs, are not carried over.

:func:`block_reduce` launches the kernel for tensors on a card and
counts the launch in ``block_reduce.launches``; for tensors on the CPU it
runs ``ref.block_reduce_ref``.  A CUDA tensor the kernel does not take
raises.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .build import launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OPS = {"add": 0, "max": 1, "min": 2}


def block_reduce(a: torch.Tensor, b: torch.Tensor, *, op: str = "add"
                 ) -> torch.Tensor:
    """``a ⊕ b`` for equal 2-D shapes and dtypes (float32, bfloat16,
    int32; ⊕ add / max / min)."""
    code = _OPS.get(op)
    if code is None:
        raise ValueError(f"unknown reduce op {op!r}; have {sorted(_OPS)}")
    if a.shape != b.shape or a.dim() != 2:
        raise ValueError(f"need equal 2-D shapes, got {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if not a.is_cuda:
        if a.device != b.device:
            raise ValueError(f"a on {a.device}, b on {b.device}")
        if a.device.type != "cpu":
            raise ValueError(f"block_reduce runs on cuda or cpu, got "
                             f"{a.device}")
        return _ref.block_reduce_ref(a, b, op=op)
    if a.get_device() != b.get_device():
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"block_reduce kernel takes float32/bfloat16/int32 "
                        f"pairs, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_reduce kernel needs contiguous operands")
    out = torch.empty_like(a)
    n = out.numel()
    if n:
        launch("block_reduce", "repro_block_reduce", "ppplii", a,
               a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
               _DTYPES[a.dtype], code)
        block_reduce.launches += 1
    return out


block_reduce.launches = 0


def block_reduce_bytes(numel: int, itemsize: int) -> int:
    """Bytes one launch must move: two operands read, one result
    written."""
    return 3 * numel * itemsize
