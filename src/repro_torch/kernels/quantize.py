"""int8 symmetric group quantization on the card, and the int8 wire format.

``quantize``    float32/bfloat16 ``(rows, cols)`` to int8 codes plus one
                float32 scale per (row, group of ``g`` columns):
                ``scale = amax * _INV127 + _EPS``, ``codes = clip(round(x /
                scale), ±127)``, rounding half to even.  CUDA kernel
                ``csrc/quantize.cu``; replaces the Pallas TPU kernel
                ``repro/kernels/quantize.py:quantize``.
``dequant_add`` ``(acc.f32 + codes * scale).astype(acc.dtype)``, the
                compressed ⊕.  CUDA kernel ``csrc/quantize.cu``; replaces
                ``repro/kernels/quantize.py:dequant_add``.

Both are bound by bytes (each input element read once, each output
written once, a handful of operations per element); see the source for
what the design does about it.  Each wrapper launches its kernel for
tensors on a card and counts the launch in ``<wrapper>.launches``; for
tensors on the CPU it runs the plain version in ``kernels/ref.py`` (and
counts nothing).  A CUDA tensor the kernel does not take raises: there
is no fallback.

The wire: one contiguous int8 buffer per round, ``[codes | scale
bytes]`` along the columns, so a compressed round still makes exactly
one exchange and moves ``cols + 4 * ceil(cols / g)`` bytes per row.
``pack_wire`` / ``unpack_wire`` are byte views (little-endian, as the
reference's shifts are), so the port's wire is bitwise the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref as _ref
from .build import launch

DEFAULT_GROUP = 512  # elements per quantization group (one scale each)

#: largest group the kernels take: 1024 threads of 16 bytes each.
MAX_GROUP = 4096

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def wire_ngroups(cols: int, group: int = DEFAULT_GROUP) -> int:
    """Number of (per-row) quantization groups covering ``cols`` columns."""
    g = min(group, cols)
    return -(-cols // g)


def wire_width(cols: int, group: int = DEFAULT_GROUP) -> int:
    """int8 wire columns for ``cols`` payload columns: the codes plus four
    scale bytes per group (a compressed round's bytes per row)."""
    return cols + 4 * wire_ngroups(cols, group)


def pad2d(x: torch.Tensor, row_mult: int, col_mult: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor so rows and columns are multiples of
    ``row_mult`` and ``col_mult``; returns ``x`` itself (no copy) when
    they already are."""
    rows, cols = x.shape
    pr, pc = (-rows) % row_mult, (-cols) % col_mult
    if pr or pc:
        x = F.pad(x, (0, pc, 0, pr))
    return x


def pack_wire(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes ``(rows, cols)`` and float32 scales ``(rows, ng)``
    into one contiguous int8 buffer ``(rows, cols + 4 * ng)``."""
    sb = scales.contiguous().view(torch.int8)  # (rows, 4 * ng), LE bytes
    return torch.cat([codes, sb], dim=1)


def unpack_wire(wire: torch.Tensor, cols: int, *,
                group: int = DEFAULT_GROUP
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_wire`: split a ``(rows, wire_width(cols,
    group))`` int8 buffer into contiguous codes ``(rows, cols)`` and
    float32 scales ``(rows, ng)``.  The scale bytes of a row start at
    byte ``cols``, not 4-aligned in general, so they are copied into
    fresh storage before the float32 view."""
    rows = wire.shape[0]
    ng = wire_ngroups(cols, group)
    if wire.shape[1] != cols + 4 * ng:
        raise ValueError(
            f"wire has {wire.shape[1]} cols, want {cols + 4 * ng} "
            f"(cols={cols}, group={group})")
    codes = wire[:, :cols].contiguous()
    scales = wire[:, cols:].clone(memory_format=torch.contiguous_format)
    scales = scales.view(torch.float32)
    return codes, scales.reshape(rows, ng)


def _check_group(group: int, cols: int) -> int:
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    return min(group, cols)


def quantize(x: torch.Tensor, *, group: int = DEFAULT_GROUP
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with per-(row, group) scales.

    Any 2-D shape; the ragged last group of a row covers fewer than ``g =
    min(group, cols)`` columns and its scale is the amax of its real
    elements.  Returns ``codes`` of ``x.shape`` (int8) and ``scales`` of
    ``(rows, ceil(cols / g))`` (float32).
    """
    if x.ndim != 2:
        raise ValueError(f"need 2-D input, got {tuple(x.shape)}")
    g = _check_group(group, x.shape[1])
    if x.device.type == "cpu":
        return _ref.quantize_ref(x, group=g)
    if x.device.type != "cuda":
        raise ValueError(f"quantize runs on cuda or cpu, got {x.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"quantize kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize kernel needs a contiguous input")
    if g > MAX_GROUP:
        raise ValueError(f"quantize kernel takes groups up to {MAX_GROUP}, "
                         f"got {g}")
    rows, cols = x.shape
    codes = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, wire_ngroups(cols, g)), dtype=torch.float32,
                         device=x.device)
    if x.numel():
        launch("quantize", "repro_quantize", "pppllli", x, x.data_ptr(),
               codes.data_ptr(), scales.data_ptr(), rows, cols, g,
               _X_DTYPES[x.dtype])
        quantize.launches += 1
    return codes, scales


quantize.launches = 0


def dequant_add(acc: torch.Tensor, codes: torch.Tensor,
                scales: torch.Tensor, *, group: int = DEFAULT_GROUP
                ) -> torch.Tensor:
    """Fused ``acc + dequant(codes, scales)`` in float32, cast back to
    ``acc``'s dtype (float32 or bfloat16); any 2-D shape, the ragged last
    group as in :func:`quantize`."""
    if codes.ndim != 2:
        raise ValueError(f"need 2-D codes, got {tuple(codes.shape)}")
    rows, cols = codes.shape
    g = _check_group(group, cols)
    if tuple(acc.shape) != (rows, cols):
        raise ValueError(f"acc {tuple(acc.shape)} vs codes {(rows, cols)}")
    if tuple(scales.shape) != (rows, wire_ngroups(cols, g)):
        raise ValueError(f"scales {tuple(scales.shape)}, want "
                         f"{(rows, wire_ngroups(cols, g))}")
    if not (acc.device == codes.device == scales.device):
        raise ValueError("acc, codes and scales lie on different devices")
    if acc.device.type == "cpu":
        return _ref.dequant_add_ref(acc, codes, scales, group=g)
    if acc.device.type != "cuda":
        raise ValueError(f"dequant_add runs on cuda or cpu, got {acc.device}")
    if (acc.dtype not in _X_DTYPES or codes.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise TypeError(
            f"dequant_add kernel takes float32/bfloat16 acc, int8 codes and "
            f"float32 scales, got {acc.dtype}, {codes.dtype}, {scales.dtype}")
    if not (acc.is_contiguous() and codes.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("dequant_add kernel needs contiguous tensors")
    if g > MAX_GROUP:
        raise ValueError(f"dequant_add kernel takes groups up to "
                         f"{MAX_GROUP}, got {g}")
    out = torch.empty_like(acc)
    if out.numel():
        launch("quantize", "repro_dequant_add", "ppppllli", acc,
               acc.data_ptr(), codes.data_ptr(), scales.data_ptr(),
               out.data_ptr(), rows, cols, g, _X_DTYPES[acc.dtype])
        dequant_add.launches += 1
    return out


dequant_add.launches = 0


def quantize_bytes(rows: int, cols: int, itemsize: int,
                   group: int = DEFAULT_GROUP) -> int:
    """Bytes one :func:`quantize` launch must move: ``x`` read once,
    codes and scales written once."""
    return rows * (cols * itemsize + cols + 4 * wire_ngroups(cols, group))


def dequant_add_bytes(rows: int, cols: int, itemsize: int,
                      group: int = DEFAULT_GROUP) -> int:
    """Bytes one :func:`dequant_add` launch must move: acc, codes and
    scales read once, the result written once."""
    return rows * (2 * cols * itemsize + cols
                   + 4 * wire_ngroups(cols, group))

