"""Tests of the port that need an NVIDIA card (marker ``gpu``).

They skip without a card, and import neither JAX nor ``repro``, so they
run as they are on the machine with the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import (block_reduce, dequant_add, fused_round,
                                 fused_round_dq, permute_rows, quantize, ref)


def _same_bits(a, b) -> bool:
    a, b = a.contiguous(), b.contiguous()
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


@pytest.mark.gpu
def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    """On the card the wrapper launches the kernel (counted) and never
    calls the plain version; the result equals the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    live = torch.randn(8, 1000, device="cuda")
    recv = torch.randn(4, 1000, device="cuda")
    want = ref.fused_round_ref(live, recv, nb=4, next_lo=2, op="max")
    monkeypatch.setattr(ref, "fused_round_ref", refuse)
    before = fused_round.launches
    keep, send = fused_round(live, recv, nb=4, next_lo=2, op="max")
    torch.cuda.synchronize()
    assert fused_round.launches == before + 1
    assert torch.equal(keep, want[0]) and torch.equal(send, want[1])


def _refuse(monkeypatch, name):
    def refuse(*a, **k):
        raise AssertionError(f"{name} called for a CUDA tensor")
    monkeypatch.setattr(ref, name, refuse)


@pytest.mark.gpu
def test_quantize_kernel_matches_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(7, 515, device="cuda") * 2).to(dtype)
        want = ref.quantize_ref(x, group=128)
        with monkeypatch.context() as m:
            _refuse(m, "quantize_ref")
            before = quantize.launches
            codes, scales = quantize(x, group=128)
            torch.cuda.synchronize()
        assert quantize.launches == before + 1
        assert _same_bits(codes, want[0]) and _same_bits(scales, want[1])


@pytest.mark.gpu
def test_dequant_add_kernel_matches_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    acc = torch.randn(7, 515, device="cuda")
    codes, scales = ref.quantize_ref(torch.randn(7, 515, device="cuda"),
                                     group=128)
    codes = codes.contiguous()
    want = ref.dequant_add_ref(acc, codes, scales, group=128)
    _refuse(monkeypatch, "dequant_add_ref")
    before = dequant_add.launches
    got = dequant_add(acc, codes, scales, group=128)
    torch.cuda.synchronize()
    assert dequant_add.launches == before + 1
    assert _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_fused_round_dq_kernel_matches_plain_version(monkeypatch, op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    live = torch.randn(8, 1024, device="cuda")
    codes, scales = ref.quantize_ref(torch.randn(4, 1024, device="cuda") * 3,
                                     group=128)
    codes = codes.contiguous()
    want_k, want_s = ref.fused_round_dq_ref(live, codes, scales, nb=4,
                                            next_lo=2, op=op, group=128)
    _refuse(monkeypatch, "fused_round_dq_ref")
    before = fused_round_dq.launches
    keep, send = fused_round_dq(live, codes, scales, nb=4, next_lo=2, op=op,
                                group=128)
    torch.cuda.synchronize()
    assert fused_round_dq.launches == before + 1
    assert _same_bits(keep, want_k)
    assert _same_bits(send[0], want_s[0]) and _same_bits(send[1], want_s[1])


def _operand(shape, dtype, op, offset, gen):
    """``shape`` of ``dtype`` starting ``offset`` elements into its
    allocation (1: off 8- and 16-byte alignment), NaN at ~10 % of a float
    max/min operand's elements."""
    n = shape[0] * shape[1]
    x = torch.randn(n + offset, device="cuda", generator=gen)
    if op != "add" and dtype != torch.int32:
        x[torch.rand(n + offset, device="cuda", generator=gen) < 0.1] = \
            float("nan")
    return (x * 100).to(dtype)[offset:].view(shape)


# (1, n): single and odd elements, a ragged vector tail, and tails past
# the last whole block (U vectors a thread), on passes below and above
# 64 MiB (where the kernel's loads per thread change); several rows with
# an odd total; then operands off alignment, and an empty pair.
_BR_CASES = [((1, 1), 0), ((1, 3), 0), ((1, 4095), 0),
             ((1, (1 << 20) + 7), 0), ((1, 3 * (1 << 22) + 5), 0),
             ((1, 3 * (1 << 23) + 5), 0), ((9, 515), 0),
             ((1, (1 << 20) + 7), 1), ((1, 4095), 1), ((1, 0), 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", _BR_CASES)
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_block_reduce_kernel_matches_plain_version(monkeypatch, dtype, op,
                                                   shape, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(shape[1] + offset)
    a = _operand(shape, dtype, op, offset, gen)
    b = _operand(shape, dtype, op, offset, gen)
    want = ref.block_reduce_ref(a, b, op=op)
    _refuse(monkeypatch, "block_reduce_ref")
    before = block_reduce.launches
    got = block_reduce(a, b, op=op)
    torch.cuda.synchronize()
    assert block_reduce.launches == before + (a.numel() > 0)
    assert _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("rows,cols", [(4, 1), (5, 7), (8, 4096)])
def test_permute_rows_kernel_matches_plain_version(monkeypatch, dtype, rows,
                                                   cols):
    """Forward and backward (the inverse permutation) launch the kernel,
    bitwise the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = (torch.randn(rows, cols, device="cuda") * 100).to(dtype)
    perm = torch.randperm(rows).tolist()
    want = ref.permute_rows_ref(x, perm)
    _refuse(monkeypatch, "permute_rows_ref")
    before = permute_rows.launches
    got = permute_rows(x, perm)
    torch.cuda.synchronize()
    assert permute_rows.launches == before + 1
    assert _same_bits(got, want)
    if dtype != torch.int32:
        xg = x.detach().requires_grad_(True)
        w = torch.randn_like(xg)
        (permute_rows(xg, perm) * w).sum().backward()
        torch.cuda.synchronize()
        assert permute_rows.launches == before + 3
        inv = [perm.index(i) for i in range(rows)]
        assert _same_bits(xg.grad, w[inv])


@pytest.mark.gpu
def test_conformance_sweep_on_card():
    """The port's conformance harness on the card: every case passes and
    the fused cases launch the kernels (none falls back to the plain
    version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import conformance
    kernels = (fused_round, fused_round_dq, quantize, permute_rows)
    before = [k.launches for k in kernels]
    conformance.run_sweep(5, device="cuda")
    assert all(k.launches > b for k, b in zip(kernels, before))
