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

:func:`fused_round_dq` is the same round on the int8 wire (CUDA kernel
``csrc/fused_round_dq.cu``, replacing the Pallas TPU kernel
``repro/kernels/fused_round.py:fused_round_dq``): the received payload
arrives as int8 codes and float32 group scales, is dequantized and
⊕-folded into the float32 head, and the next round's send rows leave
requantized.  :func:`quantize_rows` is the round-0 send quantization of
the compressed collectives (the ``quantize`` kernel).

:func:`permute_rows` is the static row permutation of the fused alltoall
(CUDA kernel ``csrc/permute_rows.cu``, replacing the Pallas TPU kernel
``repro/kernels/fused_round.py:permute_rows``), differentiable: its
backward is the inverse permutation, another launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref as _ref
from .build import launch
from .quantize import DEFAULT_GROUP, MAX_GROUP, quantize, wire_ngroups

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
    launch("fused_round", "repro_fused_round", "ppppllllii", live,
           live.data_ptr(), received.data_ptr(), keep.data_ptr(),
           None if send is None else send.data_ptr(), lo, nb, next_lo, cols,
           _DTYPES[live.dtype], _OPS[op])
    fused_round.launches += 1
    return keep, send


def round_bytes(lo: int, nb: int, cols: int, itemsize: int) -> int:
    """Bytes one launch must move: ``live`` and ``received`` read once,
    ``keep`` + ``send`` (``lo`` rows) written once."""
    return (lo + nb + lo) * cols * itemsize


def fused_round_dq(live: torch.Tensor, codes: torch.Tensor,
                   scales: torch.Tensor, *, nb: int, next_lo: int,
                   op: str = "add", group: int = DEFAULT_GROUP
                   ) -> tuple[torch.Tensor,
                              tuple[torch.Tensor, torch.Tensor] | None]:
    """One fused compressed circulant round over 2-D buffers.

    ``live``: the ``(lo, cols)`` float32 accumulation buffer, ``cols``
    divisible by the quantization group ``g = min(group, cols)``;
    ``codes`` ``(nb, cols)`` int8 and ``scales`` ``(nb, cols / g)``
    float32: the received payload.  In one pass: dequantize, ⊕-fold into
    ``live[:nb]``, emit ``keep`` (rows ``[0, next_lo)``, float32) and
    requantize rows ``[next_lo, lo)`` as the next round's ``(codes,
    scales)``, ``None`` on the final round (``next_lo == lo``).
    """
    if live.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"need 2-D buffers, got {tuple(live.shape)} and "
                         f"{tuple(codes.shape)}")
    lo, cols = live.shape
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    g = min(group, cols)
    if cols % g:
        raise ValueError(f"cols {cols} not divisible by group {g}")
    ng = cols // g
    if tuple(codes.shape) != (nb, cols):
        raise ValueError(f"codes shape {tuple(codes.shape)} != ({nb}, {cols})")
    if tuple(scales.shape) != (nb, ng):
        raise ValueError(f"scales shape {tuple(scales.shape)} != ({nb}, {ng})")
    if not (1 <= nb <= lo and 1 <= next_lo <= lo):
        raise ValueError(f"invalid round: nb={nb}, next_lo={next_lo}, lo={lo}")
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op!r}; have {sorted(_OPS)}")
    if not (live.device == codes.device == scales.device):
        raise ValueError("live, codes and scales lie on different devices")
    if live.device.type == "cpu":
        return _ref.fused_round_dq_ref(live, codes, scales, nb=nb,
                                       next_lo=next_lo, op=op, group=g)
    if live.device.type != "cuda":
        raise ValueError(f"fused_round_dq runs on cuda or cpu, got "
                         f"{live.device}")
    if (live.dtype != torch.float32 or codes.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise TypeError(
            f"fused_round_dq kernel takes a float32 live buffer, int8 codes "
            f"and float32 scales, got {live.dtype}, {codes.dtype}, "
            f"{scales.dtype}")
    if not (live.is_contiguous() and codes.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("fused_round_dq kernel needs contiguous buffers")
    if g > MAX_GROUP:
        raise ValueError(f"fused_round_dq kernel takes groups up to "
                         f"{MAX_GROUP}, got {g}")
    dev = live.device
    keep = torch.empty((next_lo, cols), dtype=torch.float32, device=dev)
    ns = lo - next_lo
    send = None
    if ns:
        send = (torch.empty((ns, cols), dtype=torch.int8, device=dev),
                torch.empty((ns, ng), dtype=torch.float32, device=dev))
    if cols:
        launch("fused_round_dq", "repro_fused_round_dq", "ppppppllllli", live,
               live.data_ptr(), codes.data_ptr(), scales.data_ptr(),
               keep.data_ptr(), None if send is None else send[0].data_ptr(),
               None if send is None else send[1].data_ptr(), lo, nb, next_lo,
               cols, g, _OPS[op])
        fused_round_dq.launches += 1
    return keep, send


fused_round_dq.launches = 0


def dq_round_bytes(lo: int, nb: int, next_lo: int, cols: int,
                   group: int = DEFAULT_GROUP) -> int:
    """Bytes one :func:`fused_round_dq` launch must move: ``live`` (f32)
    and the received codes and scales read once, ``keep`` (f32) and the
    send codes and scales written once."""
    ng = wire_ngroups(cols, group)
    return (4 * lo * cols + nb * (cols + 4 * ng) + 4 * next_lo * cols
            + (lo - next_lo) * (cols + 4 * ng))


def quantize_rows(x: torch.Tensor, *, group: int = DEFAULT_GROUP
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-quantize the rows of ``x``: the round-0 send quantization of
    the compressed collectives (``repro.kernels.fused_round.
    quantize_rows``).  Runs the ``quantize`` kernel; a launch counts in
    both ``quantize.launches`` and ``quantize_rows.launches``."""
    before = quantize.launches
    out = quantize(x, group=group)
    quantize_rows.launches += quantize.launches - before
    return out


quantize_rows.launches = 0


#: most rows a ``permute_rows`` launch takes (the kernel's parameter table).
PERMUTE_MAX_ROWS = 256


def permute_rows(x: torch.Tensor, perm) -> torch.Tensor:
    """Static row permutation ``out[i] = x[perm[i]]`` of a 2-D ``(rows,
    cols)`` tensor in one pass (``repro.kernels.fused_round.
    permute_rows``): the fused alltoall's last step, laying its final slot
    into source-rank order.  ``perm`` must be a permutation of
    ``0..rows-1``.  Differentiable: the gradient is the inverse
    permutation, run the same way.  On a card each direction launches the
    kernel (counted in ``permute_rows.launches``); on the CPU it runs
    ``ref.permute_rows_ref``."""
    perm = tuple(int(i) for i in perm)
    if x.ndim != 2:
        raise ValueError(f"need a 2-D buffer, got {tuple(x.shape)}")
    rows = x.shape[0]
    if sorted(perm) != list(range(rows)):
        raise ValueError(f"perm {perm} is not a permutation of "
                         f"0..{rows - 1}")
    return _PermuteRows.apply(x, perm)


permute_rows.launches = 0


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm):
        inv = [0] * len(perm)
        for i, src in enumerate(perm):
            inv[src] = i
        ctx.inv = tuple(inv)
        return _permute(x, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), ctx.inv), None


def _permute(x: torch.Tensor, perm: tuple[int, ...]) -> torch.Tensor:
    if x.device.type == "cpu":
        return _ref.permute_rows_ref(x, perm)
    if x.device.type != "cuda":
        raise ValueError(f"permute_rows runs on cuda or cpu, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("permute_rows kernel needs a contiguous buffer")
    rows, cols = x.shape
    if rows > PERMUTE_MAX_ROWS:
        raise ValueError(f"permute_rows kernel takes up to "
                         f"{PERMUTE_MAX_ROWS} rows, got {rows}")
    out = torch.empty_like(x)
    if x.numel():
        table = (ctypes.c_int32 * rows)(*perm)
        launch("permute_rows", "repro_permute_rows", "ppllp", x,
               x.data_ptr(), out.data_ptr(), rows, cols * x.element_size(),
               ctypes.addressof(table))
        permute_rows.launches += 1
    return out


def permute_bytes(rows: int, cols: int, itemsize: int) -> int:
    """Bytes one :func:`permute_rows` launch must move: the input read
    once and the output written once."""
    return 2 * rows * cols * itemsize
