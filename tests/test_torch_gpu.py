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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_block_reduce_kernel_matches_plain_version(monkeypatch, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = (torch.randn(9, 515, device="cuda") * 100).to(dtype)
    b = (torch.randn(9, 515, device="cuda") * 100).to(dtype)
    want = {op: ref.block_reduce_ref(a, b, op=op) for op in ("add", "max",
                                                            "min")}
    _refuse(monkeypatch, "block_reduce_ref")
    for op, w in want.items():
        before = block_reduce.launches
        got = block_reduce(a, b, op=op)
        torch.cuda.synchronize()
        assert block_reduce.launches == before + 1
        assert _same_bits(got, w), op


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
