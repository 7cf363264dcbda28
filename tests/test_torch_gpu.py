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


@pytest.mark.gpu
@pytest.mark.parametrize("p", [3, 4, 8])
def test_baselines_on_card_equal_cpu(p):
    """Ring, recursive halving (p = 4, 8), the native collectives,
    broadcast and the pipelined RS on the card: bitwise the same
    functions on the CPU (f32, bf16, i32; add, max, min)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.comm import LocalComm
    from repro_torch.core import CollectiveSpec, plan
    from repro_torch.core import collectives as C
    gen = torch.Generator().manual_seed(p)
    kinds = ["ring", "xla"] + (["recursive_halving"] if p & (p - 1) == 0
                               else [])
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        xs = [(torch.randn(p * 64, 33, generator=gen) * 100).to(dtype)
              for _ in range(p)]
        for kind in kinds:
            for op in ("add", "max", "min"):
                pl = plan(CollectiveSpec(kind=kind, op=op), p=p)
                outs = []
                for dev in ("cpu", "cuda"):
                    inp = [x.to(dev) for x in xs]
                    res = pl.reduce_scatter(inp, LocalComm(p))
                    if kind != "recursive_halving":
                        res += pl.allreduce(inp, LocalComm(p))
                    outs.append([t.cpu() for t in res])
                assert all(_same_bits(a, b) for a, b in zip(*outs)), \
                    (kind, op, dtype)
        outs = [[t.cpu() for t in C.broadcast([x[:64].to(dev) for x in xs],
                                              LocalComm(p))]
                for dev in ("cpu", "cuda")]
        assert all(_same_bits(a, b) for a, b in zip(*outs))
    xss = [[torch.randn(p * n, 5, generator=gen) for _ in range(p)]
           for n in (3, 8)]
    pl = plan(CollectiveSpec(), p=p)  # auto: fused_round on the card
    cpu = pl.reduce_scatter_pipelined(xss, LocalComm(p))
    before = fused_round.launches
    card = pl.reduce_scatter_pipelined(
        [[x.cuda() for x in xs] for xs in xss], LocalComm(p))
    assert fused_round.launches > before
    for a, b in zip(cpu, card):
        assert all(_same_bits(x, y.cpu()) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(bucket_bytes=30_000),
                                dict(bucket_bytes=30_000, wire_dtype="int8"),
                                dict(impl="ring"), dict(impl="xla")])
def test_grad_sync_on_card_equals_cpu(kw):
    """The sync of zero1 alone, p = 4, on the same gradients of
    scaled-down qwen3-1.7b's shapes: the bucketed reduce-scatter and
    allgather (exact and on the int8 wire) and the ring and xla
    reduce-scatters on the card, bitwise the same functions on the CPU
    (the kernels on the card, their plain versions on the CPU).  p is a
    power of two so that the average's ``/ world`` is exact: PyTorch's
    CUDA division by a scalar multiplies by its float32 reciprocal, which
    at p = 3 is not the CPU's quotient in the last bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import tree as T
    from repro_torch.comm import LocalComm
    from repro_torch.launch import bootstrap
    from repro_torch.optim import zero1 as Z
    p = 4
    sess = bootstrap.build_session(arch="qwen3-1.7b", scale_down=True,
                                   dp=p, global_batch=p, device="cpu")
    items = [(path, tuple(t.shape)) for path, t in T.flatten(sess.params[0])]
    gen = torch.Generator().manual_seed(5)
    grads = [[torch.randn(shape, generator=gen) for _, shape in items]
             for _ in range(p)]
    zero_idx = [i for i, (_, shape) in enumerate(items)
                if Z.is_zero_leaf(shape, p, 1024)]
    sync = Z.GradSyncConfig(**kw)
    outs = []
    for dev in ("cpu", "cuda"):
        gs = [[g.to(dev) for g in r] for r in grads]
        comm = LocalComm(p)
        if sync.bucket_bytes is None:
            res = [Z.reduce_scatter_leaf([g[i] for g in gs], comm, sync, p)
                   for i in zero_idx]
            res = [t for per in res for t in per]
        else:
            red = Z._bucketed_reduce(gs, zero_idx, items, comm, sync, p)
            res = [per[i] for per in red for i in zero_idx]
            shards = [{i: per[i].to(torch.bfloat16) for i in zero_idx}
                      for per in red]
            res += [t for _, full in Z._bucketed_allgather(
                shards, zero_idx, items, comm, sync, p,
                [torch.bfloat16] * len(items)) for t in full]
        outs.append(([t.cpu() for t in res], comm.exchanges))
    (cpu, x_cpu), (card, x_card) = outs
    assert x_cpu == x_card
    assert all(_same_bits(a, b) for a, b in zip(cpu, card))


@pytest.mark.gpu
def test_preflight_verifies_every_plan_on_the_card():
    """``build_zero1`` on the card verifies each plan it compiles (the
    int8 wire's reduce-scatter and the allgather) and resolves them to
    the kernel backends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.analysis.verify import assert_verified
    from repro_torch.core.plan import plan
    from repro_torch.launch import bootstrap
    before = assert_verified.calls
    sess = bootstrap.build_session(arch="qwen3-1.7b", scale_down=True,
                                   dp=3, global_batch=3, seq_len=8,
                                   mode="zero1", wire_dtype="int8",
                                   device="cuda", init_state=False)
    assert assert_verified.calls - before == 2
    assert plan(sess.sync.rs_spec(), p=3).backend_for("cuda") == "fused+int8"


@pytest.mark.gpu
def test_small_elastic_drill_on_the_card():
    """The scaled-down shrink drill on the card: 4 -> 3 at step 5,
    resumed from the step-3 checkpoint, losses bitwise the uninterrupted
    p' run's; every sync round launched ``fused_round``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.elastic import run_drill
    before = fused_round.launches
    res = run_drill(arch="qwen3-1.7b", scale_down=True, steps=7, seq_len=16,
                    global_batch=12, world=4, shrink_at_step=5, fail_rank=2,
                    ckpt_every=3, device="cuda")
    assert res["resumed_step"] == 3 and res["bitwise"], res
    assert fused_round.launches > before
    assert all(v > 0 for v in res["peaks"].values())
