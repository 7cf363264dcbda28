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


@pytest.mark.gpu
def test_decode_on_the_card_matches_cpu():
    """The scaled-down qwen3-1.7b (float32) on the card: prefill and three
    decode steps (scalar, then per-row positions) within 1e-4 of the same
    weights on the CPU (GEMMs of other orders), greedy tokens equal, and
    the paged scheduler's tokens equal one-shot ``generate``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serve import Scheduler, ServeEngine
    cfg = get_config("qwen3-1.7b").scaled_down()
    model = build(cfg, remat=False)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = T.map_leaves(lambda x: x.cuda(), cpu)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    out, fed = {}, []
    for name, params in (("cpu", cpu), ("cuda", card)):
        cache, logits = model.prefill(params, tokens.to(name), 24)
        seen = [logits.cpu()]
        for i in range(3):
            if name == "cpu":    # the card is fed the CPU's greedy tokens
                fed.append(torch.argmax(logits, -1).to(torch.int32))
            pos = 12 + i if i < 2 else torch.full((2,), 12 + i, device=name)
            cache, logits = model.decode_step(params, cache, fed[i].to(name),
                                              pos)
            seen.append(logits.cpu())
        out[name] = seen
    for a, b in zip(out["cpu"], out["cuda"]):
        assert float((a - b).abs().max()) <= 1e-4
    prompts = tokens.numpy().astype(np.int32)
    eng = ServeEngine(model, card, 24)
    one = eng.generate(prompts, 6)
    np.testing.assert_array_equal(
        one, ServeEngine(model, cpu, 24).generate(prompts, 6))
    sched = Scheduler(eng, max_batch=2, kv_block_size=4)
    rids = [sched.submit(p, 6) for p in prompts]
    got = sched.run()
    for r, row in zip(rids, one):
        np.testing.assert_array_equal(got[r], row)


@pytest.mark.gpu
def test_ep_decode_kernel_on_and_off_on_the_card():
    """Scaled-down phi-3.5-MoE served expert parallel over 2 ranks on the
    card: ``permute_rows`` launches 2 per rank per MoE layer per call, and
    the tokens are bitwise those of the plain alltoall."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np
    from repro_torch.launch import bootstrap
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    sess = bootstrap.build_serve_session(
        arch="phi3.5-moe-42b-a6.6b", max_len=16, scale_down=True,
        moe_dispatch="ep", ep_devices=2, device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, sess.cfg.vocab_size, (2, 8)).astype(np.int32)
    before = permute_rows.launches
    on = sess.engine.generate(prompts, 6)
    assert permute_rows.launches - before == \
        2 * 2 * sess.cfg.n_layers * (1 + 6)
    off = ServeEngine(build(sess.cfg, remat=False, ep_comm=sess.ep_comm,
                            use_fused_kernel=False), sess.params, 16)
    np.testing.assert_array_equal(off.generate(prompts, 6), on)


def _zero_leaf_rounds(arch: str, p: int = 3):
    """``(leaf, lo, nb, next_lo, cols, wire_cols, g)`` of every
    reduce-scatter round of ``arch``'s full-width zero leaves at ``p``
    ranks: the columns of one block and, on the int8 wire, the same padded
    to whole groups of ``g = min(DEFAULT_GROUP, cols)``."""
    import math

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import reduce_scatter_plan
    from repro_torch.kernels import DEFAULT_GROUP
    from repro_torch.models import param_shapes
    from repro_torch.optim.zero1 import GradSyncConfig, is_zero_leaf
    rounds = reduce_scatter_plan(p)
    out = []
    for path, shape in T.flatten(param_shapes(get_config(arch))):
        if not is_zero_leaf(shape, p, GradSyncConfig().min_shard_numel):
            continue
        cols = (shape[0] + (-shape[0]) % p) // p * math.prod(shape[1:])
        g = min(DEFAULT_GROUP, cols)
        for k, rnd in enumerate(rounds):
            nxt = rounds[k + 1].lo if k + 1 < len(rounds) else rnd.lo
            out.append((".".join(map(str, path)), rnd.lo, rnd.nblocks, nxt,
                        cols, -(-cols // g) * g, g))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m",
                                  "whisper-small"])
def test_zero1_kernels_at_other_families_leaf_shapes(arch):
    """``fused_round``, ``quantize`` and ``fused_round_dq`` bitwise their
    plain versions at every round shape of the full-width zero leaves of
    the hybrid, xLSTM and encoder-decoder families at p = 3 (Mamba's
    ``(32, 3200, 1)`` ``w_dt``, the xLSTM's per-layer leaves, Whisper's
    encoder and decoder stacks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for leaf, lo, nb, nxt, cols, wcols, g in _zero_leaf_rounds(arch):
        live = torch.randn((lo, cols), device="cuda", generator=gen)
        recv = torch.randn((nb, cols), device="cuda", generator=gen)
        got = fused_round(live, recv, nb=nb, next_lo=nxt)
        want = ref.fused_round_ref(live, recv, nb=nb, next_lo=nxt)
        for a, b in zip(got, want):
            assert (a is None) == (b is None), leaf
            assert a is None or _same_bits(a, b.contiguous()), leaf
        live = torch.randn((lo, wcols), device="cuda", generator=gen)
        x = torch.randn((nb, wcols), device="cuda", generator=gen) * 3
        codes, scales = quantize(x, group=g)
        want = ref.quantize_ref(x, group=g)
        assert _same_bits(codes, want[0]) and _same_bits(scales, want[1]), \
            leaf
        codes = codes.contiguous()
        keep, send = fused_round_dq(live, codes, scales, nb=nb, next_lo=nxt,
                                    group=g)
        wk, ws = ref.fused_round_dq_ref(live, codes, scales, nb=nb,
                                        next_lo=nxt, group=g)
        assert _same_bits(keep, wk), leaf
        assert (send is None) == (ws is None), leaf
        if send is not None:
            assert _same_bits(send[0], ws[0]) and _same_bits(send[1], ws[1])
        del live, recv, x, codes, scales, keep, send
