"""The fused circulant round — Algorithm 1's hot loop — on the card.

Each reduce-scatter round folds the received blocks into the live buffer
head and lays out the next round's send blocks contiguously.  Done with
plain ops that is a reduce, a concatenate and a slice; the CUDA kernel
in ``csrc/fused_round.cu`` does both in one pass, reading every input
element once and writing every output element once.  It replaces the
Pallas TPU kernel ``repro/kernels/fused_round.py:fused_round``; its
bound is bytes, ``(lo + nb + lo) * cols * itemsize`` per launch (see the
source for what its design does about that).

:func:`fused_round` launches the kernel for tensors on a card and counts
the launch in ``fused_round.launches``; for tensors on the CPU it runs
the plain version ``ref.fused_round_ref`` (and counts nothing).  There is
no fallback from the card to the plain version: a kernel that does not
build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OPS = {"add": 0, "max": 1, "min": 2}


def resolve_fused(use_fused_kernel: bool | None,
                  device: torch.device | str | None = None) -> bool:
    """Auto-selection rule for ``use_fused_kernel``: ``True``/``False``
    are explicit; ``None`` (auto) picks the kernel when the payload lies
    on a card — the counterpart of the reference's "on TPU" rule."""
    if use_fused_kernel is None:
        return device is not None and torch.device(device).type == "cuda"
    return bool(use_fused_kernel)


def fused_round(live: torch.Tensor, received: torch.Tensor, *, nb: int,
                next_lo: int, op: str = "add"
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One fused circulant round over 2-D ``(blocks, block_numel)``
    buffers.

    ``live``: the ``(lo, cols)`` live buffer; ``received``: the
    ``(nb, cols)`` exchanged payload.  Returns ``(keep, send)``: rows
    ``[0, next_lo)`` of the new live buffer and rows ``[next_lo, lo)``
    (the next round's contiguous payload), or ``None`` when
    ``next_lo == lo`` (final round).  Requires ``1 <= nb <= lo`` and
    ``1 <= next_lo <= lo``.
    """
    if live.ndim != 2 or received.ndim != 2:
        raise ValueError(
            f"need 2-D buffers, got {tuple(live.shape)} and "
            f"{tuple(received.shape)}")
    lo, cols = live.shape
    if tuple(received.shape) != (nb, cols):
        raise ValueError(
            f"received shape {tuple(received.shape)} != ({nb}, {cols})")
    if not (1 <= nb <= lo and 1 <= next_lo <= lo):
        raise ValueError(f"invalid round: nb={nb}, next_lo={next_lo}, lo={lo}")
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op!r}; have {sorted(_OPS)}")
    if live.device != received.device:
        raise ValueError(
            f"live on {live.device}, received on {received.device}")
    if live.device.type == "cpu":
        return _ref.fused_round_ref(live, received, nb=nb, next_lo=next_lo,
                                    op=op)
    if live.device.type != "cuda":
        raise ValueError(f"fused_round runs on cuda or cpu, got {live.device}")
    return _launch(live, received, nb=nb, next_lo=next_lo, op=op)


fused_round.launches = 0


def _launch(live, received, *, nb, next_lo, op):
    if live.dtype != received.dtype or live.dtype not in _DTYPES:
        raise TypeError(
            f"fused_round kernel takes float32/bfloat16/int32 pairs, got "
            f"{live.dtype} and {received.dtype}")
    if not (live.is_contiguous() and received.is_contiguous()):
        raise ValueError("fused_round kernel needs contiguous buffers")
    lo, cols = live.shape
    keep = torch.empty((next_lo, cols), dtype=live.dtype, device=live.device)
    send = (None if next_lo == lo else
            torch.empty((lo - next_lo, cols), dtype=live.dtype,
                        device=live.device))
    fn = _entry()
    with torch.cuda.device(live.device):
        stream = torch.cuda.current_stream(live.device).cuda_stream
        err = fn(live.data_ptr(), received.data_ptr(), keep.data_ptr(),
                 None if send is None else send.data_ptr(),
                 lo, nb, next_lo, cols, _DTYPES[live.dtype], _OPS[op], stream)
    if err != 0:
        raise RuntimeError(f"fused_round kernel launch failed: CUDA error {err}")
    fused_round.launches += 1
    return keep, send


def _entry():
    from .build import load
    fn = load("fused_round").repro_fused_round
    if fn.argtypes is None:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def round_bytes(lo: int, nb: int, cols: int, itemsize: int) -> int:
    """Bytes one launch must move: ``live`` and ``received`` read once,
    ``keep`` + ``send`` (``lo`` rows) written once."""
    return (lo + nb + lo) * cols * itemsize
