"""Tests of the port that need an NVIDIA card (marker ``gpu``).

They skip without a card, and import neither JAX nor ``repro``, so they
run as they are on the machine with the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import fused_round, ref


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
