#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught):

1. card and build: prints ``nvidia-smi``'s name and power limit, builds
   every CUDA kernel of ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel), turns TF32 off for matmuls and convolutions;
2. kernel vs plain version on the card: ``fused_round`` against
   ``fused_round_ref`` bitwise, NaN-aware, over dtypes, ops,
   ragged shapes and every round shape of the main path, and timed at the
   main path's shapes beside its byte bound and the plain version; then
   the int8 wire's kernels (``quantize``, ``fused_round_dq``,
   ``dequant_add``) and ``block_reduce`` against their plain versions
   bitwise (finite inputs; ``block_reduce`` NaN-aware) over f32/bf16
   inputs, add/max/min, ragged columns and rows, groups below and equal
   to the row width, and every wire-round shape of both wire paths
   below, timed at the main path's shapes (``dequant_add`` beside
   ``torch.addcmul`` as its library yardstick); then ``block_reduce``
   bitwise over edge cases (ragged tails, 1-element offsets, several
   rows, empty, NaN) and a sweep of sizes (2**14 ... 2**26 and the FFN
   leaf's fold), dtypes and ops against ``torch.add`` / ``maximum`` /
   ``minimum`` (interleaved medians, host microseconds per call apart);
3. collectives on the card: circulant reduce-scatter and allreduce of
   64M-element float32 payloads per rank on a ``LocalComm``, p in
   {3, 4, 8}, exact and on the int8 wire, fused bitwise equal to eager,
   with exact exchange and launch counts and, on the wire, exactly
   ``rows * wire_width`` bytes per round;
4. the main path: ``python -m repro_torch.launch.train --arch qwen3-1.7b
   --mesh 3x1 --mode zero1 --grad-sync circulant --steps 4 --seq-len 2048
   --global-batch 3`` (full width, 28 layers, bf16 parameters, random
   weights from seed 0), with the kernel's launches counted over exactly
   that run, then one step each with the kernel on and off from the same
   seed, which must agree bitwise; the kernel-on session then takes one
   unprofiled and one profiled warm step (``torch.profiler``, device
   activity only: device busy and idle share of that step, time by
   kernel);
5. the int8 wire through the launcher's own argv, full width and 28
   layers: (a) phase 4's command with ``--wire-dtype int8
   --no-error-feedback`` (exact launch counts of ``quantize`` and
   ``fused_round_dq``, none of ``fused_round``; sync bytes per step
   beside phase 4's; one step each with the kernels on and off, bitwise
   equal on every rank; a warm step profiled as phase 4's, in a process
   of its own, ``chip_smoke.py --profile-wire-step``), and (b) ``--mesh
   2x1 --global-batch 2 --wire-dtype int8`` with error feedback on
   (exact launch counts, finite losses);
6. the expert-parallel MoE path (phi-3.5-MoE) through the launcher's
   session builder: (a) full width, 1 layer, ``--mesh 1x2 --mode zero1
   --moe-dispatch ep``, seq 2048 (a 2x2 mesh's four whole replicas with
   their AdamW state do not fit one card at any depth), 4 steps with the
   launch counts set to 0 just before and read just after, exact
   exchange and ``permute_rows`` launch counts, step 0 bitwise equal
   with the kernels on and off on every rank, peak memory, warm step
   times and a profiled warm step in a process of its own
   (``chip_smoke.py --profile-ep-step``); (b) scaled down on a 2x2 mesh
   (zero1's ``fused_round`` and the dispatch's ``permute_rows`` in one
   step), the same checks; (c) one full-width float32 MoE layer alone,
   forward and backward, at pe = 4 (a non-identity final-slot order) and
   pe = 3 (experts owned 6/5/5): fused bitwise equal to eager, ep equal
   to the global dispatch within ``1e-5 * max|global|``.

7. Corollary 3 and the conformance harness: (a) the port's conformance
   sweep (``repro_torch.core.conformance.run_sweep``) on the card at
   every p of ``DEFAULT_PS``, with the launch counts set to 0 just
   before and read just after: ``fused_round``, ``fused_round_dq``,
   ``quantize`` and ``permute_rows`` must each launch; (b) non-uniform
   (``counts=``) reduce-scatter and allreduce of qwen3-1.7b's embedding
   gradient leaf, ``(151936, 2048)`` float32 per rank, add and max,
   halving, at balanced counts (p = 3, 7: the unpadded ZeRO shards) and
   the harness's ``ragged``, ``zero_ranks`` and ``one_column`` patterns
   scaled to the leaf (p = 5): the first 16 columns bitwise equal to the
   simulator run on the CPU, rows past each count zero, the allreduce
   replicated bitwise, ``ceil_log2(p)`` exchanges per RS and twice that
   per AR, ``comm.bytes`` equal to ``nonuniform_round_widths`` rows of
   every rank, no kernel launched, peak memory per case; (c) at p = 7 the
   non-uniform RS (balanced) timed against the uniform RS of the same
   leaf padded to 7 equal blocks (``interleaved_ms``), ms and GB/s.

8. the paper's baselines and the grad-sync modes built on them: (a)
   reduce-scatter and allreduce of 64M-element float32 payloads per
   rank on a ``LocalComm`` at p in {3, 4, 8} by circulant fused,
   circulant eager, ring, recursive halving (p = 4, 8; reduce-scatter
   only) and the native call: exchanges, native calls and bytes exact,
   results within the reference's float32 tolerance of a float64 sum,
   timed interleaved; each at 1M elements bitwise the same function on
   the CPU; (b) broadcast at p = 3, 8 and hierarchical RS / AR on a 2x4
   ``LocalMesh``, bitwise the CPU's, exchanges exact; (c) phase 4's
   argv plus ``--bucket-bytes 25000000`` and ``2147483648``, each a
   4-step session built from that argv with the launch counts set to 0
   just before: ``fused_round`` launches, exchanges and sync bytes
   exact (``plan_grad_buckets``), step 0's loss and the params after it
   bitwise phase 4's, warm step ms and peak memory, and a warm step
   profiled in a process of its own (``chip_smoke.py
   --profile-bucket-step B``); (d) phase 5 (a)'s argv plus
   ``--bucket-bytes 25000000``: ``quantize`` / ``fused_round_dq``
   launches exact, params after step 1 within one update of phase 5
   (a)'s; (e) ``--grad-sync ring`` and ``xla``, 2 steps: step-0 loss
   bitwise phase 4's, params within one update, exchanges exact, warm
   step; (f) ``--grad-sync allreduce`` on a 2x1 mesh through the
   launcher (three ranks' full moments do not fit one card).

9. the plan verifier as pre-flight, per-sequence MoE dispatch and the
   elastic drill: (a) ``verify.run((2, 3, 5, 8, 16))`` clean, a plan with
   a dropped skip refused, and over phase 4 and (c) every plan a
   ``build_zero1`` call compiles (and the drill's re-plan) verified,
   counted (``Preflight``); (b) phi-3.5-MoE every width, 1 layer, seq
   2048, ``--mesh 2x1 --moe-dispatch rowwise --global-batch 4`` in zero1
   for 2 steps, ``fused_round`` launches and exchanges exact, peak memory
   and warm step, and one full-width float32 MoE layer of two sequences
   against the global dispatch of each sequence alone within 2e-5; (c)
   the elastic shrink drill at full width (qwen3-1.7b, 28 layers, seq
   2048): world 3, a checkpoint at step 3, rank 1 lost at step 4,
   resumed at p' = 2 from step 3, the resumed losses bitwise an
   uninterrupted p' = 2 run's from the same checkpoint; ``fused_round``
   launches exact; the recovery report, checkpoint bytes, write and
   restore seconds and the peak memory of each world printed; then
   ``resize_zero1_state`` 3 -> 2 -> 3 bitwise on the host over the
   checkpoint's gathered state.  The checkpoints go to a temporary
   directory under ``build/``, removed at the end.

Phase 2 also holds ``permute_rows`` against its plain version bitwise
(random permutations at p = 2..8, f32/bf16/i32, ragged and one-column
rows, a misaligned base, every alltoall shape of phases 3 and 6) and
times it at phase 6 (a)'s shape beside ``torch.index_select``
(interleaved medians, and back to back per call); phase 3 also runs the
uniform alltoall of 64M-element payloads at p in {4, 5, 8}, fused
bitwise equal to eager, with exact exchange and launch counts.

A profiled step counts only if its profile holds every launch of the
port's kernels that the step made; otherwise its device time is printed
as not measured.

``python3 chip_smoke.py --against SRC`` runs nothing of the above: it
compares this tree's kernels with those of the ``repro_torch`` under
``SRC`` (another checkout's ``src``) in one process on one card: the
host microseconds per call of every kernel wrapper of both, beside
``torch.add``'s, and ``block_reduce``'s device time of both, interleaved
with ``torch.add``'s, at the FFN leaf's fold.

Prints the card line, one ``{"kernels": [...]}`` JSON line and, last, the
verdict ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)
MAIN_ARGV = ["--arch", "qwen3-1.7b", "--mesh", "3x1", "--mode", "zero1",
             "--grad-sync", "circulant", "--steps", "4", "--seq-len", "2048",
             "--global-batch", "3", "--log-every", "1", "--device", "cuda"]
STEPS, P_MAIN = 4, 3
P_EF = 2
#: phase 6 (a): the ep MoE path's session, full width, depth cut to fit.
EP_ARCH = "phi3.5-moe-42b-a6.6b"
EP_MAIN = dict(arch=EP_ARCH, steps=STEPS, seq_len=2048, global_batch=1,
               dp=1, mp=2, mode="zero1", moe_dispatch="ep", n_layers=1,
               device="cuda")
#: phase 6 (b): the same path scaled down on a 2x2 mesh.
EP_SMALL = dict(arch=EP_ARCH, scale_down=True, steps=STEPS, seq_len=64,
                global_batch=2, dp=2, mp=2, mode="zero1", moe_dispatch="ep",
                device="cuda")


def argv_with(argv: list, **flags) -> list:
    """``argv`` with the values of ``--flag-name`` replaced (``flag_name``
    keywords; a new flag is appended, ``True`` for a bare switch)."""
    out = list(argv)
    for key, val in flags.items():
        flag = "--" + key.replace("_", "-")
        if flag in out:
            out[out.index(flag) + 1] = str(val)
        else:
            out += [flag] if val is True else [flag, str(val)]
    return out


WIRE_A_ARGV = argv_with(MAIN_ARGV, wire_dtype="int8", no_error_feedback=True)
WIRE_B_ARGV = argv_with(MAIN_ARGV, wire_dtype="int8", mesh=f"{P_EF}x1",
                        global_batch=P_EF)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bits(t):
    import torch
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.int32: torch.int32, torch.int8: torch.int8}[t.dtype])


def same_bits(a, b) -> bool:
    import torch
    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(bits(a), bits(b))


def counters():
    """Every kernel wrapper of the port, by name (each has ``.launches``)."""
    from repro_torch import kernels as K
    return {"fused_round": K.fused_round, "quantize": K.quantize,
            "quantize_rows": K.quantize_rows,
            "fused_round_dq": K.fused_round_dq,
            "dequant_add": K.dequant_add, "block_reduce": K.block_reduce,
            "permute_rows": K.permute_rows}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events, after
    two warm-up calls)."""
    import torch
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: cycles a spin kernel holds the stream for each call of a timed sample,
#: so that the host has queued the sample's calls before the first one
#: runs: ~40 us a call at the H100's ~2 GHz SM clock, more than any
#: wrapper or plain version timed here takes to queue one call.
SPIN_CYCLES_PER_CALL = 80_000


def interleaved_ms(fns: dict, reps: int, rounds: int = 7,
                   spin_per_call: int = SPIN_CYCLES_PER_CALL) -> dict:
    """Device milliseconds per call of each of ``fns`` (name ->
    zero-argument callable), timed in alternation: after a warm-up, each
    of ``rounds`` rounds takes one sample of ``reps`` calls of every
    function, in the given order on even rounds and reversed on odd ones.
    Before each sample a spin kernel holds the stream while the host
    queues the calls, so the CUDA events bracket the device's work and not
    the host's launch time.  Returns name -> ``(median, min, max)`` over
    the rounds."""
    import torch
    names = list(fns)
    for name in names:
        for _ in range(2):
            fns[name]()
    torch.cuda.synchronize()
    samples = {name: [] for name in names}
    for r in range(rounds):
        events = []
        for name in (names if r % 2 == 0 else names[::-1]):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(spin_per_call * reps)
            start.record()
            for _ in range(reps):
                fns[name]()
            end.record()
            events.append((name, start, end))
        torch.cuda.synchronize()
        for name, start, end in events:
            samples[name].append(start.elapsed_time(end) / reps)
    return {name: (statistics.median(s), min(s), max(s))
            for name, s in samples.items()}


def host_us(fn, calls: int) -> float:
    """Host microseconds per call of ``fn``: ``calls`` calls queued back
    to back with no synchronisation between them (the wrapper's and the
    launch's host cost, not the device's time), after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def spread(t: tuple) -> str:
    """``median [min, max]`` of an :func:`interleaved_ms` entry."""
    return f"{t[0]:.4f} [{t[1]:.4f}, {t[2]:.4f}]"


# ---------------------------------------------------------------------------
# Phase 1: card and build
# ---------------------------------------------------------------------------

def phase_card_and_build():
    import torch
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    for name, log in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spilled = []
        for chunk in log.split("Compiling entry function '")[1:]:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
            if m and int(m[1]) + int(m[2]):
                spilled.append((chunk.split("'")[0], int(m[1]) + int(m[2])))
        print(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {len(spilled)} spilling (ptxas -v)"
              + "".join(f"\n    {b} spill bytes: {fn}" for fn, b in spilled))
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: fused_round vs its plain version
# ---------------------------------------------------------------------------

def _rand(shape, dtype, gen, nan: bool):
    import torch
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int64,
                             device="cuda", generator=gen).to(torch.int32)
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    if nan:
        x[torch.rand(shape, device="cuda", generator=gen) < 0.1] = math.nan
    return x


def wire_leaves(p: int):
    """``(leaf, shape, cols, padded cols, g)`` of every zero leaf's
    reduce-scatter at ``p`` ranks: the columns of one block and, on the
    int8 wire, the same padded to whole groups of ``g =
    min(DEFAULT_GROUP, cols)``."""
    from repro_torch.configs import get_config
    from repro_torch import tree as T
    from repro_torch.kernels import DEFAULT_GROUP
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.zero1 import is_zero_leaf
    out = []
    for path, shape in T.flatten(param_shapes(get_config("qwen3-1.7b"))):
        if not is_zero_leaf(shape, p, 1024):
            continue
        ld_pad = shape[0] + (-shape[0]) % p
        cols = ld_pad // p * math.prod(shape[1:])
        g = min(DEFAULT_GROUP, cols)
        out.append((".".join(path), shape, cols, -(-cols // g) * g, g))
    return out


def main_path_rounds():
    """Every ``(leaf, lo, nb, next_lo, cols)`` fused_round launch shape of
    one main-path step on one rank (f32 payload, halving at p = 3)."""
    from repro_torch.core import reduce_scatter_plan
    rounds = reduce_scatter_plan(P_MAIN)
    out = []
    for leaf, _, cols, _, _ in wire_leaves(P_MAIN):
        for k, rnd in enumerate(rounds):
            nxt = rounds[k + 1].lo if k + 1 < len(rounds) else rnd.lo
            out.append((leaf, rnd.lo, rnd.nblocks, nxt, cols))
    return out


def nan_aware_equal(got, want) -> tuple[bool, bool]:
    """``(equal, nan_bits_equal)``: NaN positions and every other
    element's bits must agree; NaN payloads are reported apart (neither
    torch nor XLA pins them)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, False
    gb, wb = bits(got), bits(want)
    if got.dtype == torch.int32:
        return torch.equal(gb, wb), True
    gn, wn = torch.isnan(got), torch.isnan(want)
    if not torch.equal(gn, wn):
        return False, False
    return torch.equal(gb[~gn], wb[~wn]), torch.equal(gb[gn], wb[wn])


def describe_mismatch(got, want, inputs) -> str:
    """The first differing elements, with bits and inputs, for the log."""
    diff = (bits(got) != bits(want)).flatten().nonzero().flatten()[:4]
    lines = []
    for i in diff.tolist():
        vals = [f"{name}={t.flatten()[i].item()!r}/"
                f"{bits(t).flatten()[i].item() & 0xFFFFFFFF:#x}"
                for name, t in (("got", got), ("want", want), *inputs)
                if i < t.numel()]
        lines.append(f"  element {i}: " + " ".join(vals))
    return "\n".join(lines)


def phase_kernel_vs_plain():
    import torch
    from repro_torch.kernels import fused_round, ref, round_bytes
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    n_cases = 0
    nan_payload_cases = 0

    def compare(live, recv, nb, next_lo, op, what):
        nonlocal max_err, n_cases, nan_payload_cases
        keep, send = fused_round(live, recv, nb=nb, next_lo=next_lo, op=op)
        want_k, want_s = ref.fused_round_ref(live, recv, nb=nb,
                                             next_lo=next_lo, op=op)
        torch.cuda.synchronize()
        check((send is None) == (want_s is None), f"send presence: {what}")
        for name, got, want in (("keep", keep, want_k), ("send", send, want_s)):
            if got is None:
                continue
            want = want.contiguous()
            ok, nan_bits = nan_aware_equal(got, want)
            if not ok:
                print(describe_mismatch(got, want, (("live", live),
                                                    ("recv", recv))))
            check(ok, f"{name} differs: {what}")
            nan_payload_cases += not nan_bits
            if got.dtype != torch.int32:
                d = (got.float() - want.float()).abs()
                d = d[~torch.isnan(d)]
                if d.numel():
                    max_err = max(max_err, float(d.max()))
        n_cases += 1

    shapes = [(5, 1, 4, 7), (8, 4, 2, 1000), (7, 3, 2, 130), (8, 4, 4, 4099),
              (3, 2, 3, 33), (1, 1, 1, 5), (2, 1, 1, 1 << 20),
              (1, 1, 1, 1 << 20)]
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for op in ("add", "max", "min"):
            nan = op != "add" and dtype != torch.int32
            for lo, nb, nxt, cols in shapes:
                live = _rand((lo, cols), dtype, gen, nan)
                recv = _rand((nb, cols), dtype, gen, nan)
                compare(live, recv, nb, nxt, op, f"{dtype}/{op}/{lo},{nb},"
                        f"{nxt},{cols}")
            # a live buffer that starts off 16-byte alignment (scalar path)
            base = _rand((9, 5), dtype, gen, nan)
            compare(base[1:], _rand((4, 5), dtype, gen, nan), 4, 2, op,
                    f"{dtype}/{op}/misaligned")
    print(f"kernel vs plain: {n_cases} ragged/dtype/op cases bitwise equal "
          f"(NaN positions included; NaN payloads differ in "
          f"{nan_payload_cases} outputs)")

    # Every main-path launch shape: bitwise, then timed (f32, add).
    rows = []
    for leaf, lo, nb, nxt, cols in main_path_rounds():
        live = torch.randn((lo, cols), device="cuda", generator=gen)
        recv = torch.randn((nb, cols), device="cuda", generator=gen)
        compare(live, recv, nb, nxt, "add", f"main path {leaf} lo={lo}")
        reps = 10 if cols > (1 << 24) else 50
        k_ms = time_ms(lambda: fused_round(live, recv, nb=nb, next_lo=nxt),
                       reps)
        p_ms = time_ms(lambda: ref.fused_round_ref(live, recv, nb=nb,
                                                   next_lo=nxt), reps)
        nbytes = round_bytes(lo, nb, cols, 4)
        rows.append((leaf, lo, nb, nxt, cols, nbytes, k_ms, p_ms))
        del live, recv
    torch.cuda.empty_cache()
    print("main-path fused_round launches (one rank, one step; f32 add):")
    print(f"  {'leaf':28s} {'lo':>2s} {'nb':>2s} {'nxt':>3s} {'cols':>11s} "
          f"{'MB':>8s} {'kernel_ms':>9s} {'bound_ms':>8s} {'plain_ms':>8s} "
          f"{'GB/s':>6s}")
    for leaf, lo, nb, nxt, cols, nbytes, k_ms, p_ms in rows:
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  {leaf:28s} {lo:2d} {nb:2d} {nxt:3d} {cols:11d} "
              f"{nbytes / 1e6:8.1f} {k_ms:9.4f} {b_ms:8.4f} {p_ms:8.4f} "
              f"{nbytes / k_ms / 1e6:6.0f}")
    big = max(rows, key=lambda r: r[5])
    step = {"ms": P_MAIN * sum(r[6] for r in rows),
            "plain_ms": P_MAIN * sum(r[7] for r in rows),
            "bytes": P_MAIN * sum(r[5] for r in rows)}
    step["bound_ms"] = step["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"largest launch ({big[0]} lo={big[1]}): {big[5] / 1e9:.3f} GB, "
          f"kernel {big[6]:.4f} ms, bound {big[5] / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms, plain {big[7]:.4f} ms")
    print(f"per main-path step ({P_MAIN} ranks x {len(rows)} launches): "
          f"{step['bytes'] / 1e9:.2f} GB, kernel {step['ms']:.3f} ms, bound "
          f"{step['bound_ms']:.3f} ms, plain {step['plain_ms']:.3f} ms")
    return max_err, step


def wire_launches(p: int):
    """Every kernel launch of one rank's wire step at ``p``: ``("quantize",
    leaf, rows, cols, g)`` for round 0's send and ``("fused_round_dq",
    leaf, lo, nb, next_lo, cols, g)`` per round."""
    from repro_torch.core import reduce_scatter_plan
    rounds = reduce_scatter_plan(p)
    out = []
    for leaf, _, _, cols, g in wire_leaves(p):
        out.append(("quantize", leaf, rounds[0].hi - rounds[0].lo, cols, g))
        for k, rnd in enumerate(rounds):
            nxt = rounds[k + 1].lo if k + 1 < len(rounds) else rnd.lo
            out.append(("fused_round_dq", leaf, rnd.lo, rnd.nblocks, nxt,
                        cols, g))
    return out


class Errors:
    """Largest |kernel - plain| seen per kernel (float outputs, codes as
    integers; NaN positions left out), over every comparison."""

    def __init__(self):
        self.max = {}

    def note(self, name, got, want):
        import torch
        d = (got.float() - want.float()).abs()
        d = d[~torch.isnan(d)]
        err = float(d.max()) if d.numel() else 0.0
        self.max[name] = max(self.max.get(name, 0.0), err)


def phase_wire_kernels():
    """The int8 wire's kernels and ``block_reduce`` against their plain
    versions, bitwise, then timed at the main path's shapes."""
    import torch
    from repro_torch.kernels import (block_reduce, dequant_add,
                                     dq_round_bytes, fused_round_dq, quantize,
                                     ref)
    from repro_torch.kernels.quantize import (DEFAULT_GROUP,
                                              dequant_add_bytes,
                                              quantize_bytes)
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = Errors()
    n = {"quantize": 0, "dequant_add": 0, "fused_round_dq": 0,
         "block_reduce": 0}

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device="cuda", generator=gen)
                * scale).to(dtype)

    def same(name, got, want, what):
        ok = same_bits(got, want)
        if not ok:
            print(describe_mismatch(got.contiguous(), want.contiguous(), ()))
        check(ok, f"{name} differs from its plain version: {what}")
        errs.note(name, got, want)

    def check_quantize(x, g, what):
        codes, scales = quantize(x, group=g)
        want = ref.quantize_ref(x, group=g)
        torch.cuda.synchronize()
        same("quantize", codes, want[0], what + " codes")
        same("quantize", scales, want[1], what + " scales")
        n["quantize"] += 1
        return codes, scales

    def check_dq(live, codes, scales, nb, nxt, op, g, what):
        keep, send = fused_round_dq(live, codes, scales, nb=nb, next_lo=nxt,
                                    op=op, group=g)
        wk, ws = ref.fused_round_dq_ref(live, codes, scales, nb=nb,
                                        next_lo=nxt, op=op, group=g)
        torch.cuda.synchronize()
        check((send is None) == (ws is None), f"send presence: {what}")
        same("fused_round_dq", keep, wk, what + " keep")
        if send is not None:
            same("fused_round_dq", send[0], ws[0], what + " send codes")
            same("fused_round_dq", send[1], ws[1], what + " send scales")
        n["fused_round_dq"] += 1

    ragged = [(3, 7), (130, 515), (5, 130), (7, 515), (1, 1), (9, 4),
              (2, 1 << 20), (4, 4096)]
    for dtype in (torch.float32, torch.bfloat16):
        for rows, cols in ragged:
            for grp in sorted({4, 128, 512, min(cols, 4096)}):
                g = min(grp, cols)
                what = f"{dtype} ({rows}, {cols}) g={g}"
                x = randn((rows, cols), 2.0, dtype)
                codes, scales = check_quantize(x, g, what)
                acc = randn((rows, cols), 1.0, dtype)
                same("dequant_add", dequant_add(acc, codes, scales, group=g),
                     ref.dequant_add_ref(acc, codes, scales, group=g), what)
                n["dequant_add"] += 1
    for what, x in (
            ("zero group", torch.zeros((2, 64), device="cuda")),
            ("denormal", randn((3, 64), 1e-38)),
            ("near the f32 range", randn((3, 64), 1e37))):
        check_quantize(x, 32, what)
    geometries = [(8, 4, 4), (8, 4, 2), (7, 3, 2), (5, 1, 4), (6, 2, 4),
                  (2, 1, 1), (4, 4, 4), (1, 1, 1)]
    for op in ("add", "max", "min"):
        for lo, nb, nxt in geometries:
            for cols, g in ((16, 4), (512, 128), (36, 12), (10, 5),
                            (64, 64), (1 << 20, 512)):
                live = randn((lo, cols))
                codes, scales = ref.quantize_ref(randn((nb, cols), 3.0),
                                                 group=g)
                check_dq(live, codes.contiguous(), scales, nb, nxt, op, g,
                         f"{op} ({lo},{nb},{nxt}) cols={cols} g={g}")
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for op in ("add", "max", "min"):
            for shape in ((3, 7), (130, 515), (1, 1), (2, 1 << 20)):
                nan = op != "add" and dtype != torch.int32
                a, b = (_rand(shape, dtype, gen, nan) for _ in range(2))
                got = block_reduce(a, b, op=op)
                want = ref.block_reduce_ref(a, b, op=op)
                torch.cuda.synchronize()
                ok, _ = nan_aware_equal(got, want)
                check(ok, f"block_reduce differs: {dtype} {op} {shape}")
                if dtype != torch.int32:
                    errs.note("block_reduce", got, want)
                n["block_reduce"] += 1
    print(f"wire kernels vs plain: {n} cases bitwise equal")

    # Every wire-round shape of both wire paths: bitwise, and those of path
    # (a) timed (f32 add); path (b)'s EF quantize at every leaf shape.
    steps = {}
    rows_out = []
    for p in (P_MAIN, P_EF):
        per = {"quantize": [0.0, 0.0, 0], "fused_round_dq": [0.0, 0.0, 0]}
        for launch in wire_launches(p):
            if launch[0] == "quantize":
                _, leaf, rows, cols, g = launch
                x = randn((rows, cols))
                check_quantize(x, g, f"p={p} {leaf} round-0 send")
                fn = lambda: quantize(x, group=g)            # noqa: E731
                pf = lambda: ref.quantize_ref(x, group=g)    # noqa: E731
                nb_ = quantize_bytes(rows, cols, 4, g)
            else:
                _, leaf, lo, nb, nxt, cols, g = launch
                live = randn((lo, cols))
                codes, scales = ref.quantize_ref(randn((nb, cols), 3.0),
                                                 group=g)
                codes = codes.contiguous()
                check_dq(live, codes, scales, nb, nxt, "add", g,
                         f"p={p} {leaf} lo={lo}")
                fn = lambda: fused_round_dq(live, codes, scales,  # noqa: E731
                                            nb=nb, next_lo=nxt, group=g)
                pf = lambda: ref.fused_round_dq_ref(  # noqa: E731
                    live, codes, scales, nb=nb, next_lo=nxt, group=g)
                nb_ = dq_round_bytes(lo, nb, nxt, cols, g)
            if p == P_MAIN:
                reps = 10 if cols > (1 << 24) else 50
                t_k, t_p = time_ms(fn, reps), time_ms(pf, reps)
                acc = per[launch[0]]
                acc[0] += t_k
                acc[1] += t_p
                acc[2] += nb_
                rows_out.append((launch[0], leaf, launch[2:], nb_, t_k, t_p))
            torch.cuda.empty_cache()
        if p == P_MAIN:
            for name, (t_k, t_p, b) in per.items():
                steps[name] = {"ms": p * t_k, "plain_ms": p * t_p,
                               "bytes": p * b,
                               "bound_ms": p * b / HBM_BYTES_PER_S * 1e3}
    for leaf, shape, _, _, _ in wire_leaves(P_EF):
        rows = shape[0] if len(shape) > 1 else 1
        x = randn((rows, math.prod(shape) // rows))
        check_quantize(x, min(DEFAULT_GROUP, x.shape[1]), f"EF {leaf}")
        del x
    torch.cuda.empty_cache()
    print("main-path wire launches (one rank, one step of path (a); f32 "
          "add):")
    print(f"  {'kernel':14s} {'leaf':22s} {'shape':>24s} {'MB':>8s} "
          f"{'kernel_ms':>9s} {'bound_ms':>8s} {'plain_ms':>8s} {'GB/s':>6s}")
    for name, leaf, shape, nb_, t_k, t_p in rows_out:
        print(f"  {name:14s} {leaf:22s} {str(shape):>24s} {nb_ / 1e6:8.1f} "
              f"{t_k:9.4f} {nb_ / HBM_BYTES_PER_S * 1e3:8.4f} {t_p:8.4f} "
              f"{nb_ / t_k / 1e6:6.0f}")
    for name, st in steps.items():
        print(f"per wire step (a) ({P_MAIN} ranks), {name}: "
              f"{st['bytes'] / 1e9:.3f} GB, kernel {st['ms']:.3f} ms, bound "
              f"{st['bound_ms']:.3f} ms, plain {st['plain_ms']:.3f} ms")

    # Off the main path: dequant_add at a round-0 receive of the FFN leaf
    # (the compressed (+) of one row) beside its plain version and the one
    # PyTorch call that computes the same function, torch.addcmul over
    # (rows, groups, g) views (rounded once where the plain version rounds
    # the product and the sum apart: within 2**-24 |q s| + 1 ulp of it).
    # The port never calls addcmul.
    leaf, _, _, cols, g = max(wire_leaves(P_MAIN), key=lambda r: r[3])
    check(cols % g == 0, f"{leaf}: {cols} columns in groups of {g}")
    ng = cols // g
    acc = randn((1, cols))
    codes, scales = quantize(randn((1, cols), 3.0), group=g)
    want = ref.dequant_add_ref(acc, codes, scales, group=g)
    same("dequant_add", dequant_add(acc, codes, scales, group=g), want,
         f"{leaf} receive")

    def addcmul():
        return torch.addcmul(acc.view(1, ng, g), codes.view(1, ng, g),
                             scales.view(1, ng, 1)).view(1, cols)

    lib = addcmul()
    deq = ref.dequant_ref(codes, scales, group=g).double().abs()
    ulp = torch.nextafter(want.abs(), torch.tensor(math.inf, device="cuda")
                          ) - want.abs()
    err = (lib.double() - want.double()).abs()
    check(lib.dtype == torch.float32 and
          bool((err <= 2.0**-24 * deq + ulp.double()).all()),
          f"torch.addcmul is not dequant_add's function: max |diff| "
          f"{float(err.max())}")
    print(f"dequant_add yardstick torch.addcmul: max |diff| from the plain "
          f"version {float(err.max()):.3e}, {int((err > 0).sum())} of {cols} "
          f"elements differ (within 2**-24 |q s| + 1 ulp)")
    del lib, deq, ulp, err, want
    t = interleaved_ms({
        "kernel": lambda: dequant_add(acc, codes, scales, group=g),
        "plain": lambda: ref.dequant_add_ref(acc, codes, scales, group=g),
        "torch.addcmul": addcmul}, reps=20)
    nb_ = dequant_add_bytes(1, cols, 4, g)
    steps["dequant_add"] = {
        "ms": t["kernel"][0], "plain_ms": t["plain"][0],
        "library_ms": t["torch.addcmul"][0], "bytes": nb_,
        "bound_ms": nb_ / HBM_BYTES_PER_S * 1e3}
    print(f"dequant_add at (1, {cols}) f32, g={g}: {nb_ / 1e9:.3f} GB, "
          f"bound {steps['dequant_add']['bound_ms']:.4f} ms; interleaved "
          f"median [min, max] ms: " + ", ".join(
              f"{k} {spread(v)}" for k, v in t.items()))
    del acc, codes, scales
    torch.cuda.empty_cache()
    return errs.max, steps


#: block_reduce's sweep: elements per operand, 2**14 ... 2**26, and the
#: fold of the FFN leaf's round-0 receive, (2, 125829120) flattened.
BR_SWEEP = [1 << k for k in range(14, 27)] + [2 * 125829120]
#: its edge cases: single and odd elements, a ragged vector tail, a tail
#: past the last whole block, passes below and above 64 MiB (where the
#: kernel's loads per thread change).
BR_EDGE_N = [1, 3, 4095, (1 << 20) + 7, 3 * (1 << 24) + 5]


def phase_block_reduce():
    """``block_reduce`` on the card: bitwise equal to the plain version
    over edge cases; the sweep over sizes, dtypes and ops against the
    matching PyTorch call (the port never calls it); and the table's row
    at the FFN leaf's fold."""
    import torch
    from repro_torch.kernels import block_reduce, ref
    from repro_torch.kernels.block_reduce import block_reduce_bytes
    gen = torch.Generator(device="cuda").manual_seed(7)
    libs = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}
    max_err = 0.0

    def same(got, want, what):
        nonlocal max_err
        ok = same_bits(got, want)
        if not ok:
            print(describe_mismatch(got.contiguous(), want.contiguous(), ()))
        check(ok, f"block_reduce differs from its plain version: {what}")
        if got.dtype != torch.int32 and got.numel():
            d = (got.float() - want.float()).abs()
            d = d[~torch.isnan(d)]
            if d.numel():
                max_err = max(max_err, float(d.max()))

    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for op in ("add", "max", "min"):
            nan = op != "add" and dtype != torch.int32
            for n in BR_EDGE_N:
                for off_a, off_b in ((0, 0), (1, 1), (0, 1)):
                    base = _rand((1, n + 1), dtype, gen, nan)
                    a = base[:, off_a:off_a + n]
                    b = _rand((1, n + 1), dtype, gen, nan)[:, off_b:off_b + n]
                    want = ref.block_reduce_ref(a, b, op=op)
                    what = f"{dtype} {op} n={n} offsets {off_a},{off_b}"
                    same(block_reduce(a, b, op=op), want, what)
                    n_cases += 1
            a, b = (_rand((9, 515), dtype, gen, nan) for _ in range(2))
            same(block_reduce(a, b, op=op), ref.block_reduce_ref(a, b, op=op),
                 f"{dtype} {op} (9, 515)")
            n_cases += 1
            before = block_reduce.launches
            for shape in ((0, 5), (1, 0)):
                e = torch.empty(shape, dtype=dtype, device="cuda")
                check(block_reduce(e, e, op=op).shape == shape,
                      f"block_reduce of an empty {shape}")
            check(block_reduce.launches == before, "empty input launched")
    torch.cuda.synchronize()
    print(f"block_reduce vs plain: {n_cases} cases ((1, n), n in "
          f"{BR_EDGE_N}, operands at 16-byte and 1-element offsets; (9, "
          f"515); NaN for float max/min) x f32/bf16/i32 x add/max/min "
          f"bitwise equal; empty inputs launch nothing")

    # The sweep: bitwise, then kernel vs the PyTorch call, interleaved.
    print("block_reduce sweep (1, n), kernel vs the library call; "
          "interleaved median [min, max] ms over 7 rounds, host us per call "
          "queued back to back:")
    print(f"  {'dtype':8s} {'op':3s} {'n':>10s} {'kernel_ms':>26s} "
          f"{'library_ms':>26s} {'bound_ms':>8s} {'k/lib':>6s} "
          f"{'k_host_us':>9s} {'lib_host_us':>11s}")
    losses = []
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for op in ("add", "max", "min"):
            nan = op != "add" and dtype != torch.int32
            for n in BR_SWEEP:
                a, b = (_rand((1, n), dtype, gen, nan) for _ in range(2))
                same(block_reduce(a, b, op=op),
                     ref.block_reduce_ref(a, b, op=op),
                     f"sweep {dtype} {op} n={n}")
                lib = libs[op]
                big = n >= 1 << 24
                t = interleaved_ms(
                    {"kernel": lambda: block_reduce(a, b, op=op),
                     "library": lambda: lib(a, b)},
                    reps=20 if big else 200)
                h_k = host_us(lambda: block_reduce(a, b, op=op),
                              20 if big else 200)
                h_l = host_us(lambda: lib(a, b), 20 if big else 200)
                bound = (block_reduce_bytes(n, a.element_size())
                         / HBM_BYTES_PER_S * 1e3)
                ratio = t["kernel"][0] / t["library"][0]
                if n >= 1 << 22 and ratio > 1:
                    losses.append((str(dtype), op, n, ratio))
                print(f"  {str(dtype)[6:]:8s} {op:3s} {n:10d} "
                      f"{spread(t['kernel']):>26s} "
                      f"{spread(t['library']):>26s} {bound:8.4f} "
                      f"{ratio:6.4f} {h_k:9.2f} {h_l:11.2f}")
                del a, b
            torch.cuda.empty_cache()
    n_big = 9 * sum(n >= 1 << 22 for n in BR_SWEEP)
    print(f"block_reduce sweep: kernel median <= the library's at "
          f"{n_big - len(losses)} of {n_big} points with n >= 2**22"
          + (f"; slower at {losses}" if losses else ""))

    # The table's row: the FFN leaf's fold, kernel vs plain vs torch.add.
    cols = BR_SWEEP[-1] // 2
    a, b = (torch.randn((2, cols), device="cuda", generator=gen)
            for _ in range(2))
    same(block_reduce(a, b), ref.block_reduce_ref(a, b), "FFN leaf fold")
    t = interleaved_ms({"kernel": lambda: block_reduce(a, b),
                        "plain": lambda: ref.block_reduce_ref(a, b),
                        "torch.add": lambda: torch.add(a, b)}, reps=20)
    nb_ = block_reduce_bytes(2 * cols, 4)
    row = {"ms": t["kernel"][0], "plain_ms": t["plain"][0],
           "library_ms": t["torch.add"][0], "bytes": nb_,
           "bound_ms": nb_ / HBM_BYTES_PER_S * 1e3}
    print(f"block_reduce at (2, {cols}) f32 add: {nb_ / 1e9:.3f} GB, bound "
          f"{row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f}"
          f" % of it reached); interleaved median [min, max] ms: "
          + ", ".join(f"{k} {spread(v)}" for k, v in t.items()))
    del a, b
    torch.cuda.empty_cache()
    return max_err, row


def load_kernels(src: str):
    """The ``repro_torch.kernels`` package under ``src``, imported as
    ``against_kernels`` beside this tree's (its modules import only each
    other; it builds into its own checkout's ``build/``)."""
    import importlib.util
    init = Path(src).resolve() / "repro_torch" / "kernels" / "__init__.py"
    if not init.is_file():
        fail(f"{src} holds no repro_torch/kernels")
    spec = importlib.util.spec_from_file_location(
        "against_kernels", init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def against_report(src: str) -> int:
    """This tree's kernels against those under ``src``, in one process:
    ``python3 chip_smoke.py --against SRC``.  Prints the host microseconds
    per call of every kernel wrapper of both trees and of ``torch.add``,
    at small shapes (device time far below the host's), round-robin; then
    ``block_reduce`` of both trees, each bitwise equal to the plain
    version, timed interleaved with ``torch.add`` at the FFN leaf's fold
    ``(2, 125829120)`` f32 add."""
    import torch
    from repro_torch import kernels as here
    from repro_torch.kernels import ref
    there = load_kernels(src)
    print(f"this tree: {Path(here.__file__).parent}; against: "
          f"{Path(there.__file__).parent}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((4, 4096), device="cuda", generator=gen)
    recv = torch.randn((2, 4096), device="cuda", generator=gen)
    codes, scales = here.quantize(recv, group=512)

    def wrappers(K):
        return {
            "block_reduce": lambda: K.block_reduce(x, x),
            "fused_round": lambda: K.fused_round(x, recv, nb=2, next_lo=2),
            "fused_round_dq": lambda: K.fused_round_dq(
                x, codes, scales, nb=2, next_lo=2, group=512),
            "quantize": lambda: K.quantize(x, group=512),
            "dequant_add": lambda: K.dequant_add(recv, codes, scales,
                                                 group=512),
            "permute_rows": lambda: K.permute_rows(x, (3, 1, 0, 2))}

    fns = {"torch.add": lambda: torch.add(x, x)}
    for tree, K in (("here", here), ("against", there)):
        fns.update({f"{tree} {k}": f for k, f in wrappers(K).items()})
    rounds = {name: [] for name in fns}
    for _ in range(7):  # round-robin, so a busy host weighs on all alike
        for name, fn in fns.items():
            rounds[name].append(host_us(fn, 1000))
    print("  wrapper                  median [min, max] us per call over 7 "
          "rounds of 1000 calls; median excess over torch.add in the same "
          "round")
    for name, us in rounds.items():
        extra = statistics.median(u - a for u, a in
                                  zip(us, rounds["torch.add"]))
        print(f"  {name:24s} {statistics.median(us):7.2f} [{min(us):.2f}, "
              f"{max(us):.2f}]  {extra:+7.2f}")

    cols = 125829120
    a, b = (torch.randn((2, cols), device="cuda", generator=gen)
            for _ in range(2))
    want = ref.block_reduce_ref(a, b)
    for tree, K in (("here", here), ("against", there)):
        check(same_bits(K.block_reduce(a, b), want),
              f"block_reduce ({tree}) differs from its plain version")
    del want
    t = interleaved_ms({"here": lambda: here.block_reduce(a, b),
                        "against": lambda: there.block_reduce(a, b),
                        "torch.add": lambda: torch.add(a, b)}, reps=20)
    lib = t["torch.add"][0]
    print(f"block_reduce at (2, {cols}) f32 add, bitwise both; interleaved "
          f"median [min, max] ms, / torch.add: " + ", ".join(
              f"{k} {spread(v)} {v[0] / lib:.4f}" for k, v in t.items()))
    return 0


def ep_shape(cfg, pe: int, tokens: int) -> tuple[int, int]:
    """``(rows, cols)`` of the dispatch alltoall's final slot (what
    ``permute_rows`` permutes) for ``cfg`` over ``pe`` ranks of
    ``tokens`` tokens each."""
    from repro_torch.models.dispatch import capacity, expert_owners
    own_max = max(expert_owners(cfg.n_experts, pe))
    return pe, own_max * capacity(cfg, tokens) * cfg.d_model


def ep_main_launches() -> int:
    """``permute_rows`` launches of one phase 6 (a) step: per layer and
    rank, the two alltoalls of the forward, again in remat's
    recomputation, and their two inverses in the backward."""
    return EP_MAIN["n_layers"] * 6 * EP_MAIN["dp"] * EP_MAIN["mp"]


def phase_permute_rows():
    """``permute_rows`` against its plain version, bitwise, then timed at
    phase 6 (a)'s shape beside ``torch.index_select`` (the library call
    for the same function; the port never calls it)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.plan import final_slot_order
    from repro_torch.kernels import permute_bytes, permute_rows, ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    n_cases, max_err = 0, 0.0

    def compare(x, perm, what):
        nonlocal n_cases, max_err
        got = permute_rows(x, perm)
        want = ref.permute_rows_ref(x, perm)
        torch.cuda.synchronize()
        check(same_bits(got, want), f"permute_rows differs: {what}")
        max_err = max(max_err, float((got.double() - want.double()).abs()
                                     .max()))
        n_cases += 1

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for rows in range(2, 9):
            for cols in (1, 7, 130, 4099, 1 << 20):
                x = _rand((rows, cols), dtype, gen, False)
                perm = torch.randperm(rows, generator=torch.Generator()
                                      .manual_seed(rows * cols)).tolist()
                compare(x, perm, f"{dtype} {rows}x{cols} {perm}")
        base = _rand((5 * 9 + 1,), dtype, gen, False)  # off 16-byte base
        compare(base[1:].view(5, 9), (4, 0, 3, 1, 2), f"{dtype} misaligned")
    cfg = get_config(EP_ARCH)
    small = cfg.scaled_down()
    shapes = [("phase 6 (a)", ep_shape(cfg, 2, 2048), torch.bfloat16),
              ("phase 6 (b)", ep_shape(small, 2, 64), torch.float32),
              ("phase 6 (c) pe=4", ep_shape(cfg, 4, 2048), torch.float32),
              ("phase 6 (c) pe=3", ep_shape(cfg, 3, 2048), torch.float32)]
    n = 64 << 20
    shapes += [(f"phase 3 p={p}", (p, (n - n % p) // p), torch.float32)
               for p in (4, 5, 8)]
    for what, (rows, cols), dtype in shapes:
        x = _rand((rows, cols), dtype, gen, False)
        compare(x, final_slot_order(rows), f"{what} ({rows}, {cols})")
        del x
    torch.cuda.empty_cache()
    print(f"permute_rows vs plain: {n_cases} cases bitwise equal (p = 2..8 x "
          f"f32/bf16/i32 x ragged and one-column rows, misaligned base, "
          f"every alltoall shape of phases 3 and 6)")
    rows, cols = ep_shape(cfg, 2, 2048)
    x = _rand((rows, cols), torch.bfloat16, gen, False)
    perm = final_slot_order(rows)
    idx = torch.tensor(perm, device="cuda")
    check(same_bits(torch.index_select(x, 0, idx), permute_rows(x, perm)),
          "index_select differs from permute_rows")
    nbytes = permute_bytes(rows, cols, 2)
    # Interleaved, the stream held while the host queues each sample: a
    # launch takes the card ~30 us, about what the host takes to issue it.
    t = interleaved_ms({
        "kernel": lambda: permute_rows(x, perm),
        "plain": lambda: ref.permute_rows_ref(x, perm),
        "index_select": lambda: torch.index_select(x, 0, idx)}, reps=50)
    one = {"ms": t["kernel"][0], "plain_ms": t["plain"][0],
           "library_ms": t["index_select"][0],
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    # Back to back, the host issues each launch while the card runs the
    # last one: this reading shows where the host, not the card, bounds it.
    b2b = {"kernel": time_ms(lambda: permute_rows(x, perm), 50),
           "plain": time_ms(lambda: ref.permute_rows_ref(x, perm), 50),
           "index_select": time_ms(lambda: torch.index_select(x, 0, idx),
                                   50)}
    del x
    torch.cuda.empty_cache()
    k = ep_main_launches()
    print(f"permute_rows at phase 6 (a)'s shape ({rows}, {cols}) bf16, "
          f"{nbytes / 1e6:.1f} MB per launch: kernel {spread(t['kernel'])} "
          f"ms, bound {one['bound_ms']:.4f} ms, plain {spread(t['plain'])} "
          f"ms, index_select {spread(t['index_select'])} ms "
          f"({nbytes / one['ms'] / 1e6:.0f} GB/s)")
    print(f"permute_rows back to back at the same shape, per call: kernel "
          f"{b2b['kernel']:.4f} ms, plain {b2b['plain']:.4f} ms, "
          f"index_select {b2b['index_select']:.4f} ms")
    step = {key: k * v for key, v in one.items()}
    print(f"permute_rows per phase 6 (a) step ({k} launches): kernel "
          f"{step['ms']:.4f} ms, bound {step['bound_ms']:.4f} ms, plain "
          f"{step['plain_ms']:.4f} ms, index_select "
          f"{step['library_ms']:.4f} ms")
    return max_err, step


# ---------------------------------------------------------------------------
# Phase 3: collectives on the card
# ---------------------------------------------------------------------------

def phase_collectives():
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.core import CollectiveSpec, ceil_log2, plan
    from repro_torch.kernels import fused_round
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 64 << 20
    for p in (3, 4, 8):
        xs = [torch.randn(n - n % p, device="cuda", generator=gen)
              for _ in range(p)]
        q = ceil_log2(p)
        out = {}
        for fused in (False, True):
            pl = plan(CollectiveSpec(use_fused_kernel=fused), p=p)
            comm = LocalComm(p)
            before = fused_round.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = pl.reduce_scatter(xs, comm)
            torch.cuda.synchronize()
            t_rs = time.perf_counter() - t0
            check(comm.exchanges == q, f"p={p} RS exchanges {comm.exchanges}")
            ar = pl.allreduce(xs, comm)
            torch.cuda.synchronize()
            check(comm.exchanges == 3 * q,
                  f"p={p} RS+AR exchanges {comm.exchanges}")
            launched = fused_round.launches - before
            check(launched == (2 * p * q if fused else 0),
                  f"p={p} fused={fused}: {launched} launches")
            out[fused] = (rs, ar)
            print(f"collectives p={p} fused={fused}: RS of {len(xs[0])} f32 "
                  f"per rank {t_rs * 1e3:.2f} ms (host clock, {p} virtual "
                  f"ranks), exchanges {comm.exchanges}, launches {launched}")
        for a, b in zip(out[False][0] + out[False][1],
                        out[True][0] + out[True][1]):
            check(same_bits(a, b), f"p={p}: fused differs from eager")
        del xs, out
        torch.cuda.empty_cache()
    print("collectives: fused bitwise equal to eager at p = 3, 4, 8")


def phase_wire_collectives():
    """Wire RS and AR at p in {3, 4, 8}: the fused backend (``quantize`` and
    ``fused_round_dq``) bitwise equal to the eager one (their plain
    versions on the card), exact exchanges and launches, and ``rows *
    wire_width`` bytes in every round."""
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.core import CollectiveSpec, ceil_log2, plan
    from repro_torch.kernels import DEFAULT_GROUP, wire_width
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 64 << 20
    for p in (3, 4, 8):
        xs = [torch.randn(n - n % p, device="cuda", generator=gen)
              for _ in range(p)]
        blk = len(xs[0]) // p
        g = min(DEFAULT_GROUP, blk)
        row = wire_width(-(-blk // g) * g, g)
        q = ceil_log2(p)
        out = {}
        for fused in (False, True):
            pl = plan(CollectiveSpec(use_fused_kernel=fused,
                                     wire_dtype="int8"), p=p)
            comm = LocalComm(p)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = pl.rs_begin(xs, comm)
            while not st.done:  # round by round, to read each one's bytes
                rnd, before = st.round, comm.bytes
                pl.finish_round(pl.start_round(st))
                check(comm.bytes - before == p * rnd.nblocks * row,
                      f"p={p} round {st.k - 1}: {comm.bytes - before} bytes, "
                      f"expected {p} ranks x {rnd.nblocks} rows x {row}")
            rs = pl.rs_end(st)
            torch.cuda.synchronize()
            t_rs = time.perf_counter() - t0
            check(comm.exchanges == q, f"p={p} wire RS exchanges "
                  f"{comm.exchanges}")
            ar = pl.allreduce(xs, comm)
            torch.cuda.synchronize()
            check(comm.exchanges == 3 * q,
                  f"p={p} wire RS+AR exchanges {comm.exchanges}")
            check(comm.bytes == 3 * p * (p - 1) * row,
                  f"p={p} wire RS+AR bytes {comm.bytes}")
            c = read_counts()
            want = ({"quantize": 3 * p, "quantize_rows": 3 * p,
                     "fused_round_dq": 2 * p * q} if fused else
                    {"quantize": 0, "quantize_rows": 0, "fused_round_dq": 0})
            for name, w in want.items():
                check(c[name] == w, f"p={p} fused={fused}: {name} launched "
                      f"{c[name]} times, expected {w}")
            check(c["fused_round"] == 0, f"p={p}: fused_round on the wire")
            out[fused] = (rs, ar)
            print(f"wire collectives p={p} fused={fused}: RS of {len(xs[0])} "
                  f"f32 per rank {t_rs * 1e3:.2f} ms (host clock), "
                  f"exchanges {comm.exchanges}, bytes {comm.bytes} "
                  f"({row} per block row), launches "
                  f"{ {k: c[k] for k in want} }")
        for a, b in zip(out[False][0] + out[False][1],
                        out[True][0] + out[True][1]):
            check(same_bits(a, b), f"p={p}: wire fused differs from eager")
        del xs, out
        torch.cuda.empty_cache()
    print("wire collectives: fused bitwise equal to eager at p = 3, 4, 8")


def phase_alltoall():
    """Uniform circulant alltoall of 64M-element float32 payloads per rank
    at p in {4, 5, 8}: fused (``permute_rows``) bitwise equal to eager,
    ``ceil_log2(p)`` exchanges, p launches per fused alltoall."""
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.core import CollectiveSpec, ceil_log2, plan
    from repro_torch.core.plan import final_slot_order
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 64 << 20
    for p in (4, 5, 8):
        xs = [torch.randn((p, (n - n % p) // p), device="cuda",
                          generator=gen) for _ in range(p)]
        out = {}
        for fused in (False, True):
            comm = LocalComm(p)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[fused] = plan(CollectiveSpec(use_fused_kernel=fused),
                              p=p).alltoall(xs, comm)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c = read_counts()
            check(comm.exchanges == ceil_log2(p),
                  f"alltoall p={p}: {comm.exchanges} exchanges")
            check(c["permute_rows"] == (p if fused else 0) and
                  sum(c.values()) == c["permute_rows"],
                  f"alltoall p={p} fused={fused}: launches {c}")
            print(f"alltoall p={p} fused={fused}: {xs[0].numel()} f32 per "
                  f"rank, {dt * 1e3:.2f} ms (host clock, {p} virtual ranks), "
                  f"exchanges {comm.exchanges}, permute_rows launches "
                  f"{c['permute_rows']}, final-slot order "
                  f"{final_slot_order(p)}")
        for a, b in zip(out[False], out[True]):
            check(same_bits(a, b), f"alltoall p={p}: fused differs from eager")
        for r in (0, p - 1):  # row j of rank r is rank j's row r
            for j in range(p):
                check(torch.equal(out[True][r][j], xs[j][r]),
                      f"alltoall p={p}: rank {r} row {j} misplaced")
        del xs, out
        torch.cuda.empty_cache()
    print("alltoall: fused bitwise equal to eager at p = 4, 5, 8")


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

#: the port's kernels that a profiled step must hold every launch of:
#: launch counter -> the CUDA function's name in the profile.
PROFILED_KERNELS = {"fused_round": "fused_round_kernel",
                    "fused_round_dq": "fused_round_dq_kernel",
                    "quantize": "quantize_kernel",
                    "permute_rows": "permute_rows_kernel"}

#: argument that makes this script the child process profiling path (a).
PROFILE_WIRE_STEP = "--profile-wire-step"
#: argument that makes it the child process profiling phase 6 (a).
PROFILE_EP_STEP = "--profile-ep-step"
#: ``--against SRC``: only this tree's kernels against those under SRC.
AGAINST = "--against"


def timed_step(step) -> float:
    """Wall milliseconds of ``step()``, host clock to device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profiled_step(step, label: str, unprofiled_ms: float,
                  ranks: int = P_MAIN) -> None:
    """Run ``step()`` (one warm main-path step) under ``torch.profiler``,
    recording device activity only (host-op recording would stretch the
    step's wall time several-fold), and print where the device time goes:
    busy vs the same step's wall time (the idle share), time by kernel
    family, and the top kernels.  ``unprofiled_ms`` is the previous
    step's wall time without the profiler, printed beside it to show the
    profiler's own cost.  The profile counts only if it holds every
    launch of the port's kernels that the step made (its launch counts
    are set to 0 just before it); otherwise device time is not measured
    and nothing of it is printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = timed_step(step)
    launched = read_counts()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    lost = {}
    for name, fn in PROFILED_KERNELS.items():
        seen = sum(fn in e.name for e in kernels)
        if seen != launched[name]:
            lost[name] = f"{seen} of {launched[name]} launches recorded"
    if not kernels or lost:
        print(f"profile ({label}): device busy not measured (profile "
              f"incomplete: {len(kernels)} device events; {lost})")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:  # union of kernel intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us() / 1e3
        acc[1] += 1
    families = {"fused_round": 0.0, "wire": 0.0, "permute_rows": 0.0,
                "gemm": 0.0, "other": 0.0}
    for name, (ms, _) in by_name.items():
        fam = ("wire" if "fused_round_dq" in name or "quantize" in name else
               "fused_round" if "fused_round" in name else
               "permute_rows" if "permute_rows" in name else
               "gemm" if any(k in name.lower() for k in
                             ("gemm", "nvjet", "xmma", "cutlass", "cublas"))
               else "other")
        families[fam] += ms
    busy_ms = busy_us / 1e3
    print(f"profile ({label}, {ranks} ranks): wall {wall_ms:.1f} ms "
          f"(previous step unprofiled: {unprofiled_ms:.1f} ms), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f} % of this step, "
          f"{len(kernels)} kernels")
    print("profile: device ms by family: " + ", ".join(
        f"{k} {v:.1f} ({100 * v / busy_ms:.1f} %)" for k, v in
        families.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, n) in top:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:90]}")


def sync_bytes(p: int, wire: bool) -> tuple[int, int]:
    """Exact bytes one step's exchanges send at ``p`` ranks, summed over
    the ranks: the gradient reduce-scatter's (float32 rows, or int8 wire
    rows padded to whole groups) and the parameter allgather's (shards in
    the parameters' dtype, never on the wire).  Tiny leaves go through an
    all-reduce, which is not an exchange."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import wire_width
    itemsize = getattr(torch, get_config("qwen3-1.7b").dtype).itemsize
    rs = ag = 0
    for _, _, cols, padded, g in wire_leaves(p):
        rs += p * (p - 1) * (wire_width(padded, g) if wire else 4 * cols)
        ag += p * (p - 1) * itemsize * cols
    return rs, ag


def ranks_agree(params: list, label: str) -> None:
    """Every rank's parameters bitwise equal to rank 0's."""
    from repro_torch import tree as T
    items = T.flatten(params[0])
    for other in params[1:]:
        for (path, a), b in zip(items, T.leaves(other)):
            check(same_bits(a, b), f"{label}: ranks disagree on {path}")


def step0_state(sess, metrics, label: str) -> dict:
    """A session's state once step 0 has finished, every rank's params
    first checked bitwise equal to rank 0's: the loss, the grad norm, and
    on the host rank 0's params and every rank's AdamW first moments
    (each leaf's synced gradient shard times the clip scale and ``1 -
    beta1``: what the sync decided, element by element)."""
    from repro_torch import tree as T
    ranks_agree(sess.params, label)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": [(p, t.cpu()) for p, t in T.flatten(sess.params[0])],
            "m": [[(p, t.cpu()) for p, t in T.flatten(o.m)]
                  for o in sess.opt]}


def run_path(argv, label: str, want: dict, p: int, wire: bool,
             sync: tuple | None = None, exchanges: int | None = None,
             at_step0=None):
    """Drive the launcher's ``main(argv)`` with every launch count set to 0
    just before and read just after; check the counts and the sync's
    bytes per step (``sync``: the reduce-scatter's and the allgather's,
    by default those of the per-leaf sync) and, when given, its
    exchanges per step; print what the run measured.  ``at_step0(sess,
    metrics)``, when given, runs once step 0 has finished (outside its
    timing); what it returns comes last."""
    import torch
    from repro_torch.launch import train as trainer
    kept, hook_s = [], []

    def on_step(step, sess, metrics):
        if step == 0 and at_step0 is not None:
            t0 = time.perf_counter()
            kept.append(at_step0(sess, metrics))
            hook_s.append(time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    run = trainer.main(argv, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    left = torch.cuda.memory_allocated()  # the session is gone: ~0 unless
    #                                       a reference cycle still holds it
    for name, w in want.items():
        check(counts[name] == w, f"{label}: {name} launched {counts[name]} "
              f"times, expected {w}")
    check(all(math.isfinite(x) for x in run.losses),
          f"{label}: non-finite loss {run.losses}")
    rs, ag = sync if sync is not None else sync_bytes(p, wire)
    check(exchanges is None or all(x == exchanges
                                   for x in run.sync_exchanges),
          f"{label}: exchanges per step {run.sync_exchanges}, expected "
          f"{exchanges}")
    check(all(b == rs + ag for b in run.sync_bytes),
          f"{label}: sync bytes per step {run.sync_bytes}, expected "
          f"{rs} (reduce-scatter) + {ag} (allgather)")
    print(f"{label}: losses {run.losses}")
    print(f"{label}: step seconds {[round(t, 4) for t in run.step_seconds]}"
          f" (host clock to device sync)")
    print(f"{label}: launches {counts}")
    print(f"{label}: peak memory allocated {peak / 2**30:.2f} GiB; "
          f"{left / 2**30:.2f} GiB still allocated once the run returned")
    print(f"{label}: sync bytes per step {run.sync_bytes[0]} = "
          f"reduce-scatter {rs} + allgather {ag}; exchanges per step "
          f"{run.sync_exchanges[0]}")
    print(f"{label}: {wall:.1f} s in the launcher: steps "
          f"{sum(run.step_seconds):.1f}, step 0's state kept or held "
          f"{sum(hook_s):.1f}, the rest (the session's build) "
          f"{wall - sum(run.step_seconds) - sum(hook_s):.1f}")
    gc.collect()
    torch.cuda.empty_cache()
    return run, counts, peak, rs, (kept[0] if kept else None)


def phase_main_path():
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import bootstrap

    cfg = get_config("qwen3-1.7b")
    n_zero = len(wire_leaves(P_MAIN))
    print(f"main path: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params, {n_zero} zero leaves")
    print("reduced: none (every width and all 28 layers)")
    want = {name: 0 for name in counters()}
    want["fused_round"] = STEPS * P_MAIN * n_zero * 2
    run, counts, peak, rs_bytes, _ = run_path(MAIN_ARGV, "main path", want,
                                              P_MAIN, wire=False)
    launches = counts["fused_round"]
    print(f"main path: fused_round launches {launches} "
          f"(= {STEPS} steps x {P_MAIN} ranks x {n_zero} leaves x 2 rounds)")

    def one_step(fused):
        sess = bootstrap.build_session(
            arch="qwen3-1.7b", steps=STEPS, seq_len=2048, global_batch=3,
            dp=P_MAIN, mode="zero1", use_fused_kernel=fused, device="cuda")
        return bootstrap.run_step(sess, 0), sess

    metrics, sess = one_step(True)
    ref = step0_state(sess, metrics, "main path")
    loss_on, snapshot = ref["loss"], ref["params"]
    # Two more steps of this session: step 1 unprofiled, step 2 profiled,
    # so the idle share is read on one warm step against its own wall time.
    wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
    print(f"main path: warm step 1 of a kernel-on session {wall_1:.1f} ms "
          f"(host clock to device sync)")
    profiled_step(lambda: bootstrap.run_step(sess, 2),
                  "warm step 2 of a kernel-on session", wall_1)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    metrics, sess = one_step(False)
    loss_off = float(metrics["loss"])
    check(loss_on == run.losses[0], f"step-0 loss {loss_on} != main path's "
          f"{run.losses[0]}")
    check(loss_on == loss_off, f"step-0 loss fused {loss_on} != off {loss_off}")
    check(ref["grad_norm"] == float(metrics["grad_norm"]),
          f"step-0 grad norm fused {ref['grad_norm']} != off "
          f"{float(metrics['grad_norm'])}")
    for (path, want_t), got in zip(snapshot, T.leaves(sess.params[0])):
        check(same_bits(want_t, got.cpu()),
              f"params after step 1 differ with the kernel off: {path}")
    print("main path: --fused-kernel off gives a bitwise-equal step-0 loss "
          "and grad norm and bitwise-equal params after step 1")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    ref.update(warm_ms=wall_1, peak=peak)
    return counts, run, peak, rs_bytes, ref


def wire_session_a(fused: bool):
    """A fresh path (a) session: p = 3 on the int8 wire, EF off."""
    from repro_torch.launch import bootstrap
    return bootstrap.build_session(
        arch="qwen3-1.7b", steps=STEPS, seq_len=2048, global_batch=3,
        dp=P_MAIN, mode="zero1", wire_dtype="int8", error_feedback=False,
        use_fused_kernel=fused, device="cuda")


def profile_wire_step() -> int:
    """The child process of phase 5 (a): a kernel-on wire session takes
    step 0, step 1 unprofiled and step 2 profiled, as phase 4's (TF32
    off, as phase 1 sets it)."""
    import torch
    from repro_torch.launch import bootstrap
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sess = wire_session_a(True)
    bootstrap.run_step(sess, 0)
    wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
    profiled_step(lambda: bootstrap.run_step(sess, 2),
                  "warm step 2 of a wire session, path (a), in a fresh "
                  "process", wall_1)
    return 0


def phase_wire_path(f32_rs_bytes: int):
    """Phase 5: the int8 wire through the launcher's own argv."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import bootstrap

    n_a, n_b = len(wire_leaves(P_MAIN)), len(wire_leaves(P_EF))
    print(f"wire path (a): {' '.join(WIRE_A_ARGV)}")
    print("reduced: none (every width and all 28 layers)")
    want = {name: 0 for name in counters()}
    want.update(quantize=STEPS * P_MAIN * n_a,
                quantize_rows=STEPS * P_MAIN * n_a,
                fused_round_dq=STEPS * P_MAIN * n_a * 2)
    run_a, counts_a, peak_a, rs_a, _ = run_path(
        WIRE_A_ARGV, "wire path (a)", want, P_MAIN, wire=True)
    print(f"wire path (a): reduce-scatter bytes per step {rs_a} vs "
          f"{f32_rs_bytes} in float32 (phase 4): {f32_rs_bytes / rs_a:.4f}x "
          f"fewer")

    def one_step(fused):
        """Step 0 of a fresh session: its loss and grad norm, the launches
        it made, and rank 0's params after it (on the host), once every
        rank's params are checked bitwise equal to rank 0's."""
        sess = wire_session_a(fused)
        zero_counts()
        metrics = bootstrap.run_step(sess, 0)
        counts = read_counts()
        ranks_agree(sess.params, "wire path (a)")
        params = [(path, t.cpu()) for path, t in T.flatten(sess.params[0])]
        del sess
        gc.collect()
        torch.cuda.empty_cache()
        return (float(metrics["loss"]), float(metrics["grad_norm"]), counts,
                params)

    loss_on, gn_on, c_on, on = one_step(True)
    loss_off, gn_off, c_off, off = one_step(False)
    want_on = {name: 0 for name in counters()}
    want_on.update(quantize=P_MAIN * n_a, quantize_rows=P_MAIN * n_a,
                   fused_round_dq=P_MAIN * n_a * 2)
    check(c_on == want_on, f"wire step with the kernels on: {c_on}")
    check(not any(c_off.values()), f"wire step with the kernels off: {c_off}")
    check(loss_on == run_a.losses[0] and loss_on == loss_off,
          f"wire step-0 loss: main {run_a.losses[0]}, on {loss_on}, off "
          f"{loss_off}")
    check(gn_on == gn_off, f"wire step-0 grad norm: on {gn_on}, off {gn_off}")
    for (path, a), (_, b) in zip(on, off):
        check(same_bits(a, b), f"wire params after step 1 differ with the "
              f"kernels off: {'.'.join(path)}")
    print("wire path (a): kernels on and off give a bitwise-equal step-0 "
          "loss and grad norm and bitwise-equal params after step 1, on "
          "every rank")
    wire_ref = {"loss": loss_on, "grad_norm": gn_on}
    del on, off
    gc.collect()
    torch.cuda.empty_cache()
    # The profiler records a second step in one process incompletely (it
    # lost the wire step's tail after phase 4's profile), so path (a)'s
    # warm step is profiled in a process of its own.
    sys.stdout.flush()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            PROFILE_WIRE_STEP], timeout=600)
    check(child.returncode == 0,
          f"wire path (a) profile process exited {child.returncode}")

    print(f"wire path (b): {' '.join(WIRE_B_ARGV)}")
    print("reduced: none (every width and all 28 layers); p = 2, not 3: "
          "three ranks' full-leaf EF residuals do not fit one card")
    want = {name: 0 for name in counters()}
    want.update(quantize=STEPS * P_EF * n_b * 2,
                quantize_rows=STEPS * P_EF * n_b,
                fused_round_dq=STEPS * P_EF * n_b)
    run_b, counts_b, peak_b, _, _ = run_path(WIRE_B_ARGV, "wire path (b)",
                                             want, P_EF, wire=True)
    return {"a": (run_a, counts_a, peak_a), "b": (run_b, counts_b, peak_b),
            "ref": wire_ref}


# ---------------------------------------------------------------------------
# Phase 6: the expert-parallel MoE path
# ---------------------------------------------------------------------------

def ep_session(fused, **kw):
    from repro_torch.launch import bootstrap
    return bootstrap.build_session(use_fused_kernel=fused, **kw)


def ep_step_counts(sess) -> dict:
    """Exact launches and exchanges of one step of an ep session: per
    layer ``8·ceil_log2(M)`` model-axis exchanges (forward alltoallv and
    two alltoalls, remat's recomputation of them, and the two float
    alltoalls' reverse shifts) and 6 ``permute_rows`` launches per rank;
    per zero leaf one reduce-scatter and one allgather over the data
    axis, each ``ceil_log2(D)`` exchanges and the reduce-scatter one
    ``fused_round`` launch per rank and round."""
    from repro_torch import tree as T
    from repro_torch.core import ceil_log2
    from repro_torch.optim.zero1 import is_zero_leaf
    d, ranks = sess.comm.p, sess.comm.size
    n_zero = sum(is_zero_leaf(tuple(x.shape), d, sess.sync.min_shard_numel)
                 for x in T.leaves(sess.params[0]))
    q_data, q_model = ceil_log2(d), ceil_log2(sess.ep_comm.p)
    return {"permute_rows": sess.cfg.n_layers * 6 * ranks,
            "fused_round": ranks * n_zero * q_data,
            "data_exchanges": 2 * q_data * n_zero,
            "model_exchanges": sess.cfg.n_layers * 8 * q_model}


def run_ep_path(label: str, kw: dict):
    """Drive ``kw``'s ep session for its steps with every launch count set
    to 0 just before and read just after; check counts, exchanges and
    finite losses; then one step each with the kernels on and off from
    the same seed, which must agree bitwise on every rank."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import bootstrap
    torch.cuda.reset_peak_memory_stats()
    sess = ep_session(None, **kw)
    per = ep_step_counts(sess)
    steps = kw["steps"]
    print(f"{label}: {sess.cfg.name}, d_model {sess.cfg.d_model}, "
          f"{sess.cfg.n_experts} experts, {sess.cfg.n_layers} layer(s), mesh "
          f"{kw['dp']}x{kw['mp']}, seq {kw['seq_len']}, global batch "
          f"{kw['global_batch']}, {sess.cfg.param_count() / 1e9:.3f} B "
          f"params per rank")
    zero_counts()
    losses, secs = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        losses.append(float(bootstrap.run_step(sess, step)["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in counters()}
    want.update(permute_rows=steps * per["permute_rows"],
                fused_round=steps * per["fused_round"])
    for name, w in want.items():
        check(counts[name] == w, f"{label}: {name} launched {counts[name]} "
              f"times, expected {w}")
    check(sess.comm.exchanges == steps * per["data_exchanges"] and
          sess.ep_comm.exchanges == steps * per["model_exchanges"],
          f"{label}: exchanges data {sess.comm.exchanges} model "
          f"{sess.ep_comm.exchanges}, expected {per} per step")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    print(f"{label}: losses {losses}")
    print(f"{label}: step seconds {[round(t, 4) for t in secs]} (host clock "
          f"to device sync)")
    print(f"{label}: launches {counts}; exchanges data "
          f"{sess.comm.exchanges} model {sess.ep_comm.exchanges} "
          f"(= {steps} steps x {per})")
    print(f"{label}: peak memory allocated {peak / 2**30:.2f} GiB")
    del sess
    gc.collect()
    torch.cuda.empty_cache()

    def one_step(fused):
        sess = ep_session(fused, **kw)
        zero_counts()
        loss = float(bootstrap.run_step(sess, 0)["loss"])
        c = read_counts()
        params = [[(path, t.cpu()) for path, t in T.flatten(p)]
                  for p in sess.params]
        del sess
        gc.collect()
        torch.cuda.empty_cache()
        return loss, c, params

    loss_on, c_on, on = one_step(True)
    loss_off, c_off, off = one_step(False)
    check(c_on["permute_rows"] == per["permute_rows"] and
          c_on["fused_round"] == per["fused_round"],
          f"{label}: kernel-on step launches {c_on}")
    check(not any(c_off.values()), f"{label}: kernel-off step {c_off}")
    check(loss_on == losses[0] and loss_on == loss_off,
          f"{label}: step-0 loss: run {losses[0]}, on {loss_on}, off "
          f"{loss_off}")
    for g, (a_rank, b_rank) in enumerate(zip(on, off)):
        for (path, a), (_, b) in zip(a_rank, b_rank):
            check(same_bits(a, b), f"{label}: rank {g} params after step 1 "
                  f"differ with the kernels off: {'.'.join(path)}")
    print(f"{label}: kernels on and off give a bitwise-equal step-0 loss "
          f"and bitwise-equal params after step 1 on all "
          f"{len(on)} ranks")
    del on, off
    gc.collect()
    torch.cuda.empty_cache()
    return losses, counts, peak, secs


def profile_ep_step() -> int:
    """The child process of phase 6 (a): a kernel-on session takes step
    0, step 1 unprofiled and step 2 profiled (TF32 off)."""
    import torch
    from repro_torch.launch import bootstrap
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sess = ep_session(True, **EP_MAIN)
    bootstrap.run_step(sess, 0)
    wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
    profiled_step(lambda: bootstrap.run_step(sess, 2),
                  "warm step 2 of the ep MoE session, phase 6 (a), in a "
                  "fresh process", wall_1,
                  ranks=EP_MAIN["dp"] * EP_MAIN["mp"])
    return 0


def moe_layer_check(pe: int) -> None:
    """One full-width MoE layer alone, float32, over ``pe`` ranks:
    forward and backward, fused bitwise equal to eager (outputs, aux,
    input and weight gradients), exact exchanges and launches, and each
    rank's output equal to the global dispatch of its own tokens within
    ``1e-5 * max|global|`` (the same per-slot arithmetic in GEMMs of
    other shapes)."""
    import dataclasses
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.configs import get_config
    from repro_torch.core import ceil_log2
    from repro_torch.core.plan import final_slot_order
    from repro_torch.models.dispatch import (expert_owners, moe_ffn_ep,
                                             moe_ffn_global)
    from repro_torch.models.moe import init_moe
    cfg = dataclasses.replace(get_config(EP_ARCH), dtype="float32",
                              moe_dispatch="ep")
    gen = torch.Generator(device="cuda").manual_seed(6 + pe)
    params = init_moe(gen, cfg, torch.float32, "cuda")
    for v in params.values():
        v.requires_grad_(True)
    shape = (1, 2048, cfg.d_model)
    xs0 = [torch.randn(shape, device="cuda", generator=gen)
           for _ in range(pe)]
    ws = [torch.randn(shape, device="cuda", generator=gen)
          for _ in range(pe)]
    q = ceil_log2(pe)
    res = {}
    for fused in (False, True):
        for v in params.values():
            v.grad = None
        xs = [x.clone().requires_grad_(True) for x in xs0]
        comm = LocalComm(pe)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, auxs = moe_ffn_ep([params] * pe, cfg, xs, comm,
                                use_fused_kernel=fused)
        total = sum((o * w).sum() + a for o, w, a in zip(outs, ws, auxs))
        total.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = read_counts()
        check(comm.exchanges == 5 * q, f"layer pe={pe}: {comm.exchanges} "
              f"exchanges, expected {5 * q}")
        check(c["permute_rows"] == (4 * pe if fused else 0)
              and sum(c.values()) == c["permute_rows"],
              f"layer pe={pe} fused={fused}: launches {c}")
        res[fused] = ([o.detach() for o in outs], [a.detach() for a in auxs],
                      [x.grad for x in xs],
                      {k: v.grad.clone() for k, v in params.items()})
        print(f"MoE layer pe={pe} fused={fused}: forward + backward "
              f"{dt * 1e3:.1f} ms (host clock), exchanges {comm.exchanges}, "
              f"permute_rows launches {c['permute_rows']}")
    eager, fused = res[False], res[True]
    for a, b in zip([*eager[0], *eager[1], *eager[2]],
                    [*fused[0], *fused[1], *fused[2]]):
        check(same_bits(a, b), f"layer pe={pe}: fused differs from eager")
    for k in eager[3]:
        check(same_bits(eager[3][k], fused[3][k]),
              f"layer pe={pe}: {k} gradient differs fused vs eager")
    gcfg = dataclasses.replace(cfg, moe_dispatch="global")
    worst = 0.0
    with torch.no_grad():
        for r in range(pe):
            want, _ = moe_ffn_global(params, gcfg, xs0[r])
            err = float((fused[0][r] - want).abs().max())
            scale = float(want.abs().max())
            worst = max(worst, err / scale)
            check(err <= 1e-5 * scale, f"layer pe={pe} rank {r}: ep vs "
                  f"global max |diff| {err} > 1e-5 x {scale}")
    print(f"MoE layer pe={pe} (experts owned "
          f"{expert_owners(cfg.n_experts, pe)}, final-slot order "
          f"{final_slot_order(pe)}): fused bitwise equal to eager (outputs, "
          f"aux, input and weight gradients); ep vs global max |diff| "
          f"{worst:.3e} of max|global|")
    del params, res, xs0, ws
    gc.collect()
    torch.cuda.empty_cache()


def phase_ep_path():
    """Phase 6: the expert-parallel MoE path."""
    import torch
    cfg_note = ("reduced: depth 32 -> 1 layer and mesh 2x2 -> 1x2 (four "
                "whole replicas with AdamW state need ~94 GB); every "
                "width kept (d_model 4096, 16 experts top-2, d_ff 6400, "
                "vocab 32064)")
    print(f"ep MoE path (a): build_session({EP_MAIN})")
    print(cfg_note)
    run_a = run_ep_path("ep MoE path (a)", EP_MAIN)
    sys.stdout.flush()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            PROFILE_EP_STEP], timeout=600)
    check(child.returncode == 0,
          f"ep MoE path (a) profile process exited {child.returncode}")
    print(f"ep MoE path (b): build_session({EP_SMALL})")
    run_b = run_ep_path("ep MoE path (b)", EP_SMALL)
    for pe in (4, 3):
        moe_layer_check(pe)
    torch.cuda.empty_cache()
    return run_a, run_b


# ---------------------------------------------------------------------------
# Phase 7: conformance sweep and Corollary 3's non-uniform collectives
# ---------------------------------------------------------------------------

#: the kernels the conformance sweep must launch (its fused, int8-wire and
#: fused alltoall cases); none of them may fall back to the plain version.
SWEEP_KERNELS = ("fused_round", "fused_round_dq", "quantize", "permute_rows")
#: phase 7 (b): qwen3-1.7b's embedding gradient leaf, (vocab, d_model) f32.
NU_ROWS, NU_COLS = 151936, 2048
#: leading columns of every result held bitwise against the simulator.
NU_CHECK_COLS = 16
#: spin cycles per call before each timed sample of phase 7 (c): one
#: reduce-scatter over 7 virtual ranks takes the host ~1-3 ms to queue.
NU_SPIN_PER_CALL = 8_000_000


def balanced_counts(rows: int, p: int) -> tuple[int, ...]:
    """The unpadded ZeRO shard rows of a ``rows``-row leaf at p ranks."""
    return tuple(rows // p + (i < rows % p) for i in range(p))


def scaled_counts(pattern, rows: int) -> tuple[int, ...]:
    """``pattern`` scaled to ``rows`` rows in all, zeros kept; the rows
    lost to rounding go to the largest entry."""
    out = [c * rows // sum(pattern) for c in pattern]
    out[out.index(max(out))] += rows - sum(out)
    return tuple(out)


def nonuniform_cases() -> list:
    """(pattern, p, counts) of phase 7 (b)."""
    from repro_torch.core.conformance import nonuniform_counts_cases
    pats = nonuniform_counts_cases(5)
    return [("balanced", 3, balanced_counts(NU_ROWS, 3)),
            ("balanced", 7, balanced_counts(NU_ROWS, 7))] + [
        (name, 5, scaled_counts(pats[name], NU_ROWS))
        for name in ("ragged", "zero_ranks", "one_column")]


def phase_conformance(smi: str) -> dict:
    """Phase 7 (a): the port's conformance sweep on the card at every p
    of ``DEFAULT_PS``, launch counts set to 0 just before and read just
    after; every kernel of ``SWEEP_KERNELS`` must have launched."""
    import torch
    from repro_torch.core import conformance
    zero_counts()
    t0 = time.perf_counter()
    for p in conformance.DEFAULT_PS:
        rep = conformance.run_sweep(p, device="cuda")
        print(f"conformance p={p}: {rep['n_cases']} cases, "
              f"{len(rep['rounds'])} schedule variants, "
              f"{rep['nonuniform']['n_cases']} non-uniform, "
              f"{rep['alltoall']['n_cases']} alltoall cases pass")
    torch.cuda.synchronize()
    c = read_counts()
    for name in SWEEP_KERNELS:
        check(c[name] > 0, f"conformance sweep launched no {name}: its "
              f"fused cases fell back to the plain version ({c})")
    print(f"conformance on the card: p = {conformance.DEFAULT_PS} in "
          f"{time.perf_counter() - t0:.1f} s ({smi}), launches "
          f"{ {k: c[k] for k in SWEEP_KERNELS} }")
    return c


def phase_nonuniform(smi: str) -> None:
    """Phase 7 (b): non-uniform RS and AR of qwen3-1.7b's embedding
    gradient leaf per rank, add and max, halving schedule, on a
    ``LocalComm``: the first columns bitwise equal to the simulator run on
    the CPU (columns are independent), rows past each count zero, the AR
    replicated bitwise, exact exchanges and bytes, no kernel launched."""
    import numpy as np
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.core import CollectiveSpec, ceil_log2, plan
    from repro_torch.core.cost_model import nonuniform_round_widths
    from repro_torch.core.simulator import simulate_reduce_scatter
    np_ops = {"add": np.add, "max": np.maximum}
    row = NU_COLS * 4
    print(f"non-uniform collectives: ({NU_ROWS}, {NU_COLS}) f32 per rank "
          f"({NU_ROWS * row / 1e9:.3f} GB), halving; no case cut ({smi})")
    for name, p, counts in nonuniform_cases():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(70 + p)
        xs = [torch.randn((NU_ROWS, NU_COLS), device="cuda", generator=gen)
              for _ in range(p)]
        offs = np.concatenate([[0], np.cumsum(counts)])
        heads = [x[:, :NU_CHECK_COLS].cpu().numpy() for x in xs]
        inputs = [[h[offs[i]:offs[i + 1]] for i in range(p)] for h in heads]
        q, bmax = ceil_log2(p), max(counts)
        rs_bytes = sum(nonuniform_round_widths(counts)) * row * p
        ar_bytes = rs_bytes + sum(
            nonuniform_round_widths(counts, phase="ag")) * row * p
        what = f"non-uniform {name} p={p}"
        for op in ("add", "max"):
            pl = plan(CollectiveSpec(op=op, counts=counts), p=p)
            check(pl.backend_for("cuda") == "nonuniform",
                  f"{what}: backend {pl.backend_for('cuda')}")
            W, _ = simulate_reduce_scatter(inputs, np_ops[op])
            want = np.concatenate(W)
            zero_counts()
            comm = LocalComm(p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = pl.reduce_scatter(xs, comm)
            torch.cuda.synchronize()
            t_rs = time.perf_counter() - t0
            check((comm.exchanges, comm.bytes) == (q, rs_bytes),
                  f"{what} {op} RS: {comm.exchanges} exchanges, "
                  f"{comm.bytes} bytes; want {q}, {rs_bytes}")
            for r in range(p):
                c = counts[r]
                check(tuple(rs[r].shape) == (bmax, NU_COLS),
                      f"{what} {op}: rank {r} shape {tuple(rs[r].shape)}")
                got = rs[r][:c, :NU_CHECK_COLS].cpu().numpy()
                check(got.view(np.uint32).tobytes()
                      == W[r].view(np.uint32).tobytes(),
                      f"{what} {op}: rank {r} differs from the simulator")
                check(not rs[r][c:].any(),
                      f"{what} {op}: rank {r} rows past {c} not zero")
            del rs
            comm = LocalComm(p)
            ar = pl.allreduce(xs, comm)
            torch.cuda.synchronize()
            check((comm.exchanges, comm.bytes) == (2 * q, ar_bytes),
                  f"{what} {op} AR: {comm.exchanges} exchanges, "
                  f"{comm.bytes} bytes; want {2 * q}, {ar_bytes}")
            for r in range(1, p):
                check(same_bits(ar[r], ar[0]),
                      f"{what} {op}: AR rank {r} differs from rank 0")
            got = ar[0][:, :NU_CHECK_COLS].cpu().numpy()
            check(got.view(np.uint32).tobytes()
                  == want.view(np.uint32).tobytes(),
                  f"{what} {op}: AR differs from the simulator")
            c = read_counts()
            check(not any(c.values()), f"{what}: kernels launched {c}")
            del ar
            print(f"{what} {op}: counts {counts}, RS {t_rs * 1e3:.2f} ms "
                  f"(host clock), exchanges RS {q} AR {2 * q}, bytes RS "
                  f"{rs_bytes} AR {ar_bytes}; {NU_CHECK_COLS} columns "
                  f"bitwise the simulator's ({smi})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{what}: peak max_memory_allocated {peak:.2f} GiB ({smi})")
        del xs
    torch.cuda.empty_cache()


def phase_nonuniform_timing(smi: str) -> None:
    """Phase 7 (c): at p = 7, the non-uniform RS of the embedding leaf
    (balanced counts, no padding) against the uniform RS of the same leaf
    padded to 7 equal blocks (auto backend: ``fused_round`` on the card),
    interleaved.  A finding, not a claim."""
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.core import CollectiveSpec, plan
    p = 7
    counts = balanced_counts(NU_ROWS, p)
    blk = max(counts)
    gen = torch.Generator(device="cuda").manual_seed(77)
    xs = [torch.randn((NU_ROWS, NU_COLS), device="cuda", generator=gen)
          for _ in range(p)]
    padded = [torch.cat([x, x.new_zeros((p * blk - NU_ROWS, NU_COLS))])
              for x in xs]
    nonu = plan(CollectiveSpec(counts=counts), p=p)
    uni = plan(CollectiveSpec(), p=p)
    wire = {}

    def run(name, pl, inputs):
        def fn():
            comm = LocalComm(p)
            pl.reduce_scatter(inputs, comm)
            wire[name] = comm.bytes
        return fn

    fns = {"non-uniform": run("non-uniform", nonu, xs),
           "uniform padded": run("uniform padded", uni, padded)}
    res = interleaved_ms(fns, reps=3, spin_per_call=NU_SPIN_PER_CALL)
    in_bytes = {"non-uniform": p * NU_ROWS * NU_COLS * 4,
                "uniform padded": p * p * blk * NU_COLS * 4}
    for name, t in res.items():
        print(f"RS timing p={p} {name}: {spread(t)} ms per call "
              f"(interleaved, 7 rounds x 3 calls), wire {wire[name]} bytes "
              f"= {wire[name] / t[0] / 1e6:.1f} GB/s, input "
              f"{in_bytes[name] / t[0] / 1e6:.1f} GB/s ({smi})")
    print(f"RS timing p={p}: non-uniform / uniform padded = "
          f"{res['non-uniform'][0] / res['uniform padded'][0]:.3f} ({smi})")
    del xs, padded
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8: the paper's baselines, broadcast, hierarchical, bucketed and
# baseline grad syncs
# ---------------------------------------------------------------------------

#: phase 8 (a): elements per rank of the timed payloads (phase 3's), and
#: of the payloads held bitwise against the CPU.
ALGO_N, ALGO_CPU_N = 64 << 20, 1 << 20
#: phase 8 (c): the reference launcher's example bucket size, and one
#: above the largest leaf (every bucket holds whole leaves).
BUCKETS = (25_000_000, 2_147_483_648)
#: argument that makes this script the child profiling a bucketed step.
PROFILE_BUCKET_STEP = "--profile-bucket-step"
#: phase 8 (f): the no-ZeRO baseline on two ranks (three ranks' full
#: moments do not fit one card).
P_ALLREDUCE = 2
ALLREDUCE_ARGV = argv_with(MAIN_ARGV, grad_sync="allreduce",
                           mesh=f"{P_ALLREDUCE}x1", global_batch=P_ALLREDUCE)


def rs_algorithms(p: int) -> dict:
    """Phase 8 (a)'s reduce-scatter algorithms at p ranks."""
    from repro_torch.core import CollectiveSpec
    algos = {"circulant fused": CollectiveSpec(use_fused_kernel=True),
             "circulant eager": CollectiveSpec(use_fused_kernel=False),
             "ring": CollectiveSpec(kind="ring"),
             "recursive halving": CollectiveSpec(kind="recursive_halving"),
             "native": CollectiveSpec(kind="xla")}
    if p & (p - 1):
        del algos["recursive halving"]
    return algos


def algo_counts(name: str, coll: str, p: int) -> tuple[int, int]:
    """(exchanges, native calls) of one call of ``name``'s ``coll``."""
    from repro_torch.core import ceil_log2
    rounds = {"ring": p - 1, "recursive halving": ceil_log2(p),
              "native": 0}.get(name, ceil_log2(p))
    return rounds * (2 if coll == "AR" else 1), int(name == "native")


def phase_paper_comparison(smi: str) -> None:
    """Phase 8 (a): reduce-scatter and allreduce of 64M float32 elements
    per rank on a ``LocalComm`` at p = 3, 4, 8, by every algorithm:
    exchanges, native calls and bytes exact (every reduce-scatter sends
    p - 1 blocks per rank); results within the reference's float32
    tolerance of a float64 sum on the card, the allreduce replicated
    bitwise; device ms per call interleaved.  Then each algorithm at 1M
    elements per rank bitwise equal to the same function on the CPU."""
    import torch
    from repro_torch.comm import LocalComm
    from repro_torch.core import plan
    tol = 2e-5  # the reference's float32 add tolerance (rtol = atol)
    for p in (3, 4, 8):
        n = ALGO_N - ALGO_N % p
        blk = n // p
        gen = torch.Generator(device="cuda").manual_seed(80 + p)
        xs = [torch.randn(n, device="cuda", generator=gen) for _ in range(p)]
        ref = xs[0].double()
        for x in xs[1:]:
            ref += x.double()
        for coll in ("RS", "AR"):
            fns = {}
            for name, spec in rs_algorithms(p).items():
                if coll == "AR" and name == "recursive halving":
                    continue
                pl = plan(spec, p=p)
                run = pl.reduce_scatter if coll == "RS" else pl.allreduce
                comm = LocalComm(p)
                out = run(xs, comm)
                ex, nat = algo_counts(name, coll, p)
                nbytes = 0 if name == "native" else \
                    p * (p - 1) * blk * 4 * (2 if coll == "AR" else 1)
                check((comm.exchanges, comm.natives, comm.bytes) ==
                      (ex, nat, nbytes),
                      f"{coll} {name} p={p}: exchanges {comm.exchanges}, "
                      f"natives {comm.natives}, bytes {comm.bytes}; want "
                      f"{(ex, nat, nbytes)}")
                for r, o in enumerate(out):
                    want = ref[r * blk:(r + 1) * blk] if coll == "RS" else ref
                    err = (o.double() - want).abs() - tol * want.abs()
                    check(bool((err <= tol).all()),
                          f"{coll} {name} p={p} rank {r}: beyond the "
                          f"reference's tolerance of the float64 sum")
                    if coll == "AR":
                        check(same_bits(o, out[0]), f"AR {name} p={p}: "
                              f"rank {r} differs from rank 0")
                del out
                fns[name] = (lambda run=run: run(xs, LocalComm(p)))
            res = interleaved_ms(fns, reps=3, spin_per_call=NU_SPIN_PER_CALL)
            del fns  # its calls hold xs
            base = res["circulant fused"][0]
            for name, t in res.items():
                print(f"paper comparison {coll} p={p} {name}: {spread(t)} ms "
                      f"per call ({t[0] / base:.3f} of circulant fused; "
                      f"{n} f32 per rank, interleaved, 7 rounds x 3 calls; "
                      f"{smi})")
        del xs, ref
        torch.cuda.empty_cache()
    for p in (3, 4, 8):
        n = ALGO_CPU_N - ALGO_CPU_N % p
        gen = torch.Generator().manual_seed(90 + p)
        xs = [torch.randn(n, generator=gen) for _ in range(p)]
        for name, spec in rs_algorithms(p).items():
            pl = plan(spec, p=p)
            runs = [pl.reduce_scatter] + \
                ([] if name == "recursive halving" else [pl.allreduce])
            for run in runs:
                cpu = run(xs, LocalComm(p))
                card = run([x.cuda() for x in xs], LocalComm(p))
                for a, b in zip(cpu, card):
                    check(same_bits(a, b.cpu()), f"{name} p={p}: the card "
                          f"differs from the CPU")
    print(f"paper comparison: every algorithm at {ALGO_CPU_N} f32 per rank "
          f"bitwise equal on the card and the CPU, p = 3, 4, 8")


def phase_broadcast_hierarchical(smi: str) -> None:
    """Phase 8 (b): broadcast at p = 3, 8 (bitwise replicated,
    ``ceil_log2(p)`` exchanges) and hierarchical RS / AR on a 2x4
    ``LocalMesh``, fused (``fused_round`` on the card): bitwise the CPU's,
    exchanges per axis exact."""
    import torch
    from repro_torch.comm import LocalComm, LocalMesh
    from repro_torch.core import ceil_log2
    from repro_torch.core import collectives as C
    from repro_torch.kernels import fused_round
    gen = torch.Generator().manual_seed(88)
    for p in (3, 8):
        xs = [torch.randn(ALGO_CPU_N // p, generator=gen) for _ in range(p)]
        comm = LocalComm(p)
        out = C.broadcast([x.cuda() for x in xs], comm)
        full = torch.cat(xs)
        check(comm.exchanges == ceil_log2(p),
              f"broadcast p={p}: {comm.exchanges} exchanges")
        for r, o in enumerate(out):
            check(same_bits(o.cpu(), full), f"broadcast p={p}: rank {r}")
        print(f"broadcast p={p}: {ALGO_CPU_N // p} f32 per rank delivered "
              f"bitwise to every rank in {comm.exchanges} exchanges")
    axes, shape = ("x", "y"), (2, 4)
    xs = [torch.randn(ALGO_CPU_N, generator=gen) for _ in range(8)]
    for name, fn, per in (("RS", C.hierarchical_reduce_scatter, 1),
                          ("AR", C.hierarchical_allreduce, 2)):
        got = {}
        for dev in ("cpu", "cuda"):
            mesh = LocalMesh(shape, axes)
            before = fused_round.launches
            out = fn([x.to(dev) for x in xs], mesh, axes,
                     use_fused_kernel=True)
            got[dev] = [o.cpu() for o in out]
            ex = (mesh.axis("x").exchanges, mesh.axis("y").exchanges)
            check(ex == (per * 1, per * 2),
                  f"hierarchical {name} 2x4: exchanges {ex}")
            if dev == "cuda":
                check(fused_round.launches > before,
                      f"hierarchical {name}: no fused_round launched")
        check(all(same_bits(a, b) for a, b in zip(got["cpu"], got["cuda"])),
              f"hierarchical {name} 2x4: the card differs from the CPU")
    print(f"hierarchical RS / AR on a 2x4 LocalMesh, fused: bitwise the "
          f"CPU's, exchanges x 1 / 2, y 2 / 4 ({smi})")


def bucket_sync(p: int, bucket_bytes: int, wire: bool):
    """``(buckets, reduce-scatter bytes, allgather bytes)`` of one step of
    the bucketed sync at p ranks: every bucket's block sent p - 1 times
    per rank, float32 or on the int8 wire (padded to whole groups of
    ``min(DEFAULT_GROUP, width)``), the allgather in the parameters'
    dtype."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import DEFAULT_GROUP, wire_width
    from repro_torch.optim.zero1 import plan_grad_buckets
    itemsize = getattr(torch, get_config("qwen3-1.7b").dtype).itemsize
    shapes = [shape for _, shape, _, _, _ in wire_leaves(p)]
    buckets = plan_grad_buckets(shapes, p, bucket_bytes)
    rs = ag = 0
    for b in buckets:
        w = sum((hi - lo) * math.prod(shapes[li][1:]) for li, lo, hi in b)
        g = min(DEFAULT_GROUP, w)
        rs += p * (p - 1) * (wire_width(-(-w // g) * g, g) if wire else 4 * w)
        ag += p * (p - 1) * itemsize * w
    return buckets, rs, ag


#: phase 8 (e), (f): the zero1 test's tolerance (rtol, atol) for syncs
#: that fold in another order.  Their bfloat16 params after step 0 are
#: held bitwise all the same: the first update, about ``lr * sign(g)``,
#: moves each param by less than half its bfloat16 spacing or by whole
#: spacings, so a last-bit difference in a gradient does not reach them.
FOLD_TOL = (1e-5, 1e-9)
#: phase 8 (d): the reference's int8-wire rtol (``_tolerances``), held on
#: the L2 norm of each rank's first moments and on the grad norm.
WIRE_RTOL = 0.1


def hold_step0(sess, metrics, ref: dict, label: str, mode: str) -> str:
    """Hold a session's state after step 0 against ``ref`` (what
    :func:`step0_state` kept), leaf by leaf on the card (each of the
    reference's leaves copied there in turn: the whole of it beside a
    full-width session does not fit), every rank's
    params first checked equal; returns what was held.  The loss is held
    bitwise in every mode.  ``"bitwise"``: the grad norm, rank 0's params
    and every rank's first moments bitwise.  ``"fold"``: the params
    bitwise, the grad norm and the first moments within ``FOLD_TOL``.
    ``"wire"``: each rank's first moments (its whole shard) within
    ``WIRE_RTOL`` of the reference's in the L2 norm; a small leaf can
    be further off, its quantization groups shared with larger
    neighbours in a bucket, and is printed, not held.  A leaf whose moments are whole
    here and sharded in ``ref`` is held on each rank's shard rows."""
    import torch
    from repro_torch import tree as T
    from repro_torch.optim.zero1 import local_rows
    ranks_agree(sess.params, label)
    loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
    check(loss == ref["loss"], f"{label}: step-0 loss {loss} != {ref['loss']}")
    rtol, atol = FOLD_TOL
    if mode == "bitwise":
        check(gn == ref["grad_norm"], f"{label}: grad norm {gn} != "
              f"{ref['grad_norm']}")
    elif mode == "fold":
        check(abs(gn - ref["grad_norm"]) <= atol + rtol * ref["grad_norm"],
              f"{label}: grad norm {gn} vs {ref['grad_norm']}")
    if mode != "wire" and "params" in ref:
        for (path, want), got in zip(ref["params"], T.leaves(sess.params[0])):
            check(same_bits(got, want.to(got.device)), f"{label}: params "
                  f"after step 1 differ: {'.'.join(path)}")
    world = len(ref["m"])
    check(len(sess.opt) == world, f"{label}: {len(sess.opt)} ranks, the "
          f"reference's {world}")
    worst, sums, leaf_worst = 0.0, [0.0, 0.0], (0.0, "")
    for j, (want_m, o) in enumerate(zip(ref["m"], sess.opt)):
        for (path, want), got in zip(want_m, T.leaves(o.m)):
            name = f"rank {j} {'.'.join(path)}"
            want = want.to(got.device)
            if got.shape != want.shape:
                got = local_rows(got, j, world)
            check(got.shape == want.shape, f"{label}: first moments of "
                  f"shape {tuple(got.shape)}, the reference's "
                  f"{tuple(want.shape)}: {name}")
            if mode == "bitwise":
                check(same_bits(got, want), f"{label}: first moments "
                      f"differ: {name}")
            elif mode == "fold":
                d = (got - want).abs()
                check(bool((d <= atol + rtol * want.abs()).all()),
                      f"{label}: first moments beyond {FOLD_TOL}: {name}")
                worst = max(worst, float(d.max()) if d.numel() else 0.0)
            else:
                e2 = float(torch.linalg.vector_norm(got - want)) ** 2
                w2 = float(torch.linalg.vector_norm(want)) ** 2
                sums[0] += e2
                sums[1] += w2
                leaf_worst = max(leaf_worst, ((e2 / max(w2, 1e-60)) ** 0.5,
                                              name))
        if mode == "wire":
            rel = (sums[0] / max(sums[1], 1e-60)) ** 0.5
            check(rel <= WIRE_RTOL, f"{label}: rank {j}'s first moments "
                  f"{rel:.4f} off the reference's in the L2 norm")
            worst = max(worst, rel)
            sums = [0.0, 0.0]
    return {"bitwise": "loss, grad norm, params and every rank's first "
                       "moments bitwise",
            "fold": f"loss bitwise, params "
                    f"{'bitwise' if 'params' in ref else 'not held'}; "
                    f"grad norm {gn!r} vs "
                    f"{ref['grad_norm']!r}, every rank's first moments "
                    f"within rtol {rtol} / atol {atol} (largest absolute "
                    f"difference {worst:.3e})",
            "wire": f"loss bitwise; every rank's first moments within "
                    f"{WIRE_RTOL} of the reference's in the L2 norm "
                    f"(largest {worst:.3e}; of one leaf {leaf_worst[0]:.3e}, "
                    f"{leaf_worst[1]})"}[mode]


def warm_ms(run) -> list:
    return [round(t * 1e3, 1) for t in run.step_seconds[1:]]


def profile_bucket_step(bucket_bytes: int) -> int:
    """The child process of phase 8 (c): a bucketed session takes step 0,
    step 1 unprofiled and step 2 profiled, as phase 4's (TF32 off)."""
    import torch
    from repro_torch.launch import bootstrap
    from repro_torch.launch import train as trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, sess = trainer.build(argv_with(MAIN_ARGV, bucket_bytes=bucket_bytes))
    bootstrap.run_step(sess, 0)
    wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
    profiled_step(lambda: bootstrap.run_step(sess, 2),
                  f"warm step 2 of a bucketed session, --bucket-bytes "
                  f"{bucket_bytes}, in a fresh process", wall_1)
    return 0


def phase_grad_syncs(smi: str, ref: dict, wire_ref: dict) -> dict:
    """Phase 8 (c)-(f), 2 steps a run (1 for (d)), each run's state after
    step 0 held against a reference's (:func:`hold_step0`): the bucketed
    main path at both bucket sizes bitwise phase 4's per-leaf sync
    (``ref``), the 25 MB one's warm step profiled in a process of its
    own; the bucketed
    int8 wire with the kernels on bitwise the same with them off, its
    moments within the wire tolerance of phase 4's exact ones and its
    grad norm of phase 5 (a)'s (``wire_ref``); the ring and xla grad
    syncs within the fold tolerance of phase 4's; the allreduce baseline
    at p = 2 within it of a per-leaf circulant run at p = 2.  Returns
    each workload run's launch counts."""
    import torch
    from repro_torch.core import ceil_log2
    n_zero, q = len(wire_leaves(P_MAIN)), ceil_log2(P_MAIN)
    none = {name: 0 for name in counters()}
    steps = 2
    out = {}
    print(f"grad syncs: phase 4's full-width session (every width, all 28 "
          f"layers), warm step {ref['warm_ms']:.1f} ms, peak "
          f"{ref['peak'] / 2**30:.2f} GiB; {steps} steps a run, 1 for the "
          f"int8 wire ({smi})")

    def report(label, run, peak, held):
        print(f"{label}: after step 0 {held}")
        print(f"{label}: warm step ms {warm_ms(run)} (host clock to device "
              f"sync; step 0 {run.step_seconds[0] * 1e3:.1f}), peak memory "
              f"allocated {peak / 2**30:.2f} GiB ({smi})")

    for bb in BUCKETS:
        t0 = time.perf_counter()
        buckets, rs, ag = bucket_sync(P_MAIN, bb, wire=False)
        nb = len(buckets)
        argv = argv_with(MAIN_ARGV, bucket_bytes=bb, steps=steps)
        label = f"bucketed --bucket-bytes {bb}"
        print(f"{label}: {' '.join(argv)}; {nb} buckets for {n_zero} zero "
              f"leaves; reduced: none")
        run, counts, peak, _, held = run_path(
            argv, label, dict(none, fused_round=steps * P_MAIN * nb * q),
            P_MAIN, wire=False, sync=(rs, ag), exchanges=2 * q * nb,
            at_step0=lambda s, m: hold_step0(s, m, ref, label, "bitwise"))
        report(label, run, peak, held)
        out[f"8c-{bb}"] = counts
        if bb == BUCKETS[0]:
            sys.stdout.flush()
            child = subprocess.run([sys.executable,
                                    str(Path(__file__).resolve()),
                                    PROFILE_BUCKET_STEP, str(bb)],
                                   timeout=600)
            check(child.returncode == 0,
                  f"{label}: profile process exited {child.returncode}")
        print(f"{label}: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    bb = BUCKETS[0]
    buckets, rs, ag = bucket_sync(P_MAIN, bb, wire=True)
    nb = len(buckets)
    label = f"bucketed int8 wire --bucket-bytes {bb}"
    on = {}

    def wire_step0(sess, metrics):
        held = hold_step0(sess, metrics, ref, label, "wire")
        gn = float(metrics["grad_norm"])
        check(abs(gn - wire_ref["grad_norm"]) <=
              WIRE_RTOL * wire_ref["grad_norm"],
              f"{label}: grad norm {gn} vs phase 5 (a)'s "
              f"{wire_ref['grad_norm']}")
        on.update(step0_state(sess, metrics, label))
        return (f"{held}, of phase 4's; grad norm {gn!r}, phase 5 (a)'s "
                f"{wire_ref['grad_norm']!r}")

    for fused in ("on", "off"):
        argv = argv_with(WIRE_A_ARGV, bucket_bytes=bb, steps=1,
                         fused_kernel=fused)
        print(f"{label}: {' '.join(argv)}; {nb} buckets; reduced: none")
        want = dict(none) if fused == "off" else dict(
            none, quantize=P_MAIN * nb, quantize_rows=P_MAIN * nb,
            fused_round_dq=P_MAIN * nb * q)
        run, counts, peak, _, held = run_path(
            argv, f"{label}, kernels {fused}", want, P_MAIN, wire=True,
            sync=(rs, ag), exchanges=2 * q * nb,
            at_step0=wire_step0 if fused == "on" else
            lambda s, m: hold_step0(s, m, on, label, "bitwise") +
            " with the kernels on and off")
        report(f"{label}, kernels {fused}", run, peak, held)
        if fused == "on":
            out["8d"] = counts
    del on
    print(f"{label}: {time.perf_counter() - t0:.1f} s")

    for impl in ("ring", "xla"):
        t0 = time.perf_counter()
        argv = argv_with(MAIN_ARGV, grad_sync=impl, steps=steps)
        label = f"--grad-sync {impl}"
        print(f"{label}: {' '.join(argv)}; reduced: none")
        # ring: p - 1 rounds per RS (volume-optimal: the same bytes) and
        # the circulant allgather's q; xla: native calls only
        if impl == "ring":
            ex, sync = n_zero * ((P_MAIN - 1) + q), sync_bytes(P_MAIN, False)
        else:
            ex, sync = 0, (0, 0)
        run, counts, peak, _, held = run_path(
            argv, label, dict(none), P_MAIN, wire=False, sync=sync,
            exchanges=ex,
            at_step0=lambda s, m: hold_step0(s, m, ref, label, "fold"))
        report(label, run, peak, held)
        out[f"8e-{impl}"] = counts
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    label = "--grad-sync allreduce"
    circ = argv_with(ALLREDUCE_ARGV, grad_sync="circulant", steps=1)
    n2 = len(wire_leaves(P_ALLREDUCE))
    print(f"{label}: its reference {' '.join(circ)}")
    _, _, _, _, ref2 = run_path(  # one step, one round at p = 2
        circ, f"{label}'s reference", dict(none, fused_round=P_ALLREDUCE * n2),
        P_ALLREDUCE, wire=False,
        at_step0=lambda s, m: step0_state(s, m, label))
    del ref2["params"]  # AdamW on whole leaves or on shards: not held
    argv = argv_with(ALLREDUCE_ARGV, steps=steps)
    print(f"{label}: {' '.join(argv)}; reduced: p = 2, not 3 (three ranks' "
          f"full float32 moments, 3 x 13.8 GB, do not fit beside the model)")
    run, counts, peak, _, held = run_path(
        argv, label, dict(none), P_ALLREDUCE, wire=False, sync=(0, 0),
        exchanges=0,
        at_step0=lambda s, m: hold_step0(s, m, ref2, label, "fold"))
    report(label, run, peak, held)
    out["8f"] = counts
    del ref2
    print(f"{label}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the plan verifier as pre-flight, per-sequence MoE dispatch, and
# the elastic shrink drill
# ---------------------------------------------------------------------------

#: phase 9 (b): the rowwise MoE path, full width, depth cut as phase 6 (a).
ROW_MAIN = dict(arch=EP_ARCH, steps=2, seq_len=2048, global_batch=4, dp=2,
                mp=1, mode="zero1", moe_dispatch="rowwise", n_layers=1,
                device="cuda")
#: phase 9 (c): the elastic shrink drill, qwen3-1.7b full width and depth.
DRILL = dict(arch="qwen3-1.7b", scale_down=False, steps=5, seq_len=2048,
             global_batch=6, world=3, shrink_at_step=4, fail_rank=1,
             ckpt_every=3, keep_last=1, device="cuda")


class Preflight:
    """Counts, over a ``with`` block, the plans every ``build_zero1`` call
    compiles (``collective_specs``) and the ``assert_verified`` calls; on
    exit the two must agree (plus ``extra`` verified plans, e.g. the
    elastic re-plan's)."""

    def __init__(self, label: str):
        self.label, self.plans, self.builds, self.extra = label, 0, 0, 0

    def __enter__(self):
        from repro_torch.analysis.verify import assert_verified
        from repro_torch.launch import bootstrap
        from repro_torch.train.steps import collective_specs
        self._orig = orig = bootstrap.build_zero1

        def counted(model, comm, opt_cfg, sync, device=None, ep_world=None):
            self.builds += 1
            self.plans += len(collective_specs(sync, model.cfg, ep_world))
            return orig(model, comm, opt_cfg, sync, device, ep_world)

        bootstrap.build_zero1 = counted
        self._calls0 = assert_verified.calls
        return self

    def __exit__(self, *exc):
        from repro_torch.analysis.verify import assert_verified
        from repro_torch.launch import bootstrap
        bootstrap.build_zero1 = self._orig
        if exc[0] is not None:
            return False
        calls = assert_verified.calls - self._calls0
        want = self.plans + self.extra
        check(self.builds > 0 and calls == want,
              f"{self.label}: {calls} assert_verified calls for {self.builds} "
              f"build_zero1 calls compiling {self.plans} plans "
              f"(+ {self.extra} re-planned)")
        print(f"{self.label}: pre-flight verified {calls} plans = "
              f"{self.plans} compiled by {self.builds} build_zero1 calls"
              + (f" + {self.extra} re-planned" if self.extra else ""))
        return False


def phase_verifier() -> None:
    """Phase 9 (a): the registry verifies clean; a corrupted plan (a
    dropped skip) makes ``assert_verified`` raise."""
    import dataclasses
    from repro_torch.analysis import verify
    from repro_torch.core.plan import plan
    from repro_torch.core.spec import CollectiveSpec
    ps = (2, 3, 5, 8, 16)
    t0 = time.perf_counter()
    findings = verify.run(ps)
    n = sum(len(verify.registry_specs(p)) for p in ps)
    check(findings == [], f"verifier: {len(findings)} findings: "
          + "; ".join(f.render() for f in findings[:4]))
    print(f"verifier: run({ps}) clean over {n} plans in "
          f"{time.perf_counter() - t0:.3f} s")
    pl = plan(CollectiveSpec(), p=8)
    bad = dataclasses.replace(
        pl, skips=pl.skips[:-1], rs_rounds=pl.rs_rounds[:-1],
        rs_send_blocks=pl.rs_send_blocks[:-1],
        rs_recv_blocks=pl.rs_recv_blocks[:-1], ag_rounds=pl.ag_rounds[1:],
        ag_send_blocks=pl.ag_send_blocks[1:],
        ag_recv_blocks=pl.ag_recv_blocks[1:])
    try:
        verify.assert_verified(bad)
    except AssertionError:
        rules = sorted({f.rule for f in verify.verify_plan(bad)})
        print(f"verifier: a dropped skip at p=8 is refused ({rules})")
    else:
        fail("verifier: assert_verified accepted a plan with a dropped skip")


def rowwise_layer_check() -> None:
    """One full-width float32 MoE layer, two sequences of 2048: the
    rowwise dispatch against ``moe_ffn_global`` applied to each sequence
    alone, within 2e-5 on outputs.  The expert weights are drawn with
    std ``1/sqrt(fan-in)`` of each matmul (d_model for ``w_gate`` /
    ``w_up``, d_ff for ``w_down``), so outputs are O(1) and an absolute
    2e-5 means what it means in ``tests/test_torch_rowwise.py``; the
    init's own fan-in (the expert count) gives outputs in the thousands,
    where float32 rounding alone exceeds it."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.dispatch import (moe_ffn_global, moe_ffn_rowwise,
                                             route)
    cfg = dataclasses.replace(get_config(EP_ARCH), dtype="float32",
                              moe_dispatch="rowwise")
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(9)

    def draw(shape, std):
        return torch.randn(shape, device="cuda", generator=gen) * std

    params = {"router": draw((d, e), 0.02),
              "w_gate": draw((e, d, ff), d ** -0.5),
              "w_up": draw((e, d, ff), d ** -0.5),
              "w_down": draw((e, ff, d), ff ** -0.5)}
    x = draw((2, 2048, d), 1.0)
    with torch.no_grad():
        zero_counts()
        out, aux = moe_ffn_rowwise(params, cfg, x)
        check(not any(read_counts().values()),
              f"rowwise layer launched {read_counts()}")
        worst, scale, flips = 0.0, 0.0, 0
        _, idx_b, _ = route(params["router"], cfg, x)
        for b in range(x.shape[0]):
            want, _ = moe_ffn_global(params, cfg, x[b:b + 1])
            worst = max(worst, float((out[b:b + 1] - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
            _, idx_1, _ = route(params["router"], cfg, x[b])
            flips += int((idx_b[b] != idx_1).any(-1).sum())
    print(f"rowwise MoE layer (2 x 2048 tokens, d_model {d}, {e} experts, "
          f"f32): vs the global dispatch of each sequence alone max |diff| "
          f"{worst:.3e} (max |out| {scale:.3f}, limit 2e-5); tokens routed "
          f"differently by the batched router: {flips}")
    check(math.isfinite(float(aux)) and worst <= 2e-5,
          f"rowwise layer vs global per sequence: max |diff| {worst}")
    del params, x, out
    gc.collect()
    torch.cuda.empty_cache()


def phase_rowwise() -> dict:
    """Phase 9 (b): phi-3.5-MoE with ``moe_dispatch="rowwise"`` in zero1 on
    a 2x1 mesh, two sequences per rank, counts exact."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core import ceil_log2
    from repro_torch.launch import bootstrap
    from repro_torch.optim.zero1 import is_zero_leaf
    print(f"rowwise MoE path: build_session({ROW_MAIN})")
    print("reduced: depth 32 -> 1 layer (as phase 6 (a)); every width kept")
    torch.cuda.reset_peak_memory_stats()
    sess = bootstrap.build_session(**ROW_MAIN)
    d = sess.world
    n_zero = sum(is_zero_leaf(tuple(x.shape), d, sess.sync.min_shard_numel)
                 for x in T.leaves(sess.params[0]))
    q = ceil_log2(d)
    steps = ROW_MAIN["steps"]
    zero_counts()
    x0 = sess.comm.exchanges
    losses, secs = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        losses.append(float(bootstrap.run_step(sess, step)["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in counters()}
    want["fused_round"] = steps * d * n_zero * q
    for name, w in want.items():
        check(counts[name] == w, f"rowwise path: {name} launched "
              f"{counts[name]} times, expected {w}")
    exch = sess.comm.exchanges - x0
    check(exch == steps * 2 * q * n_zero, f"rowwise path: {exch} exchanges, "
          f"expected {steps} x 2 x {q} x {n_zero}")
    check(all(math.isfinite(x) for x in losses),
          f"rowwise path: non-finite loss {losses}")
    print(f"rowwise path: losses {losses}; launches {counts} (= {steps} "
          f"steps x {d} ranks x {n_zero} zero leaves x {q} round); "
          f"exchanges {exch}")
    print(f"rowwise path: step seconds {[round(t, 4) for t in secs]} (host "
          f"clock to device sync; warm step {secs[-1] * 1e3:.1f} ms); peak "
          f"memory allocated {peak / 2**30:.2f} GiB")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    rowwise_layer_check()
    return counts


def drill_launches(n_zero: dict) -> int:
    """``fused_round`` launches of the drill: the old world's steps before
    the fault, then the resumed and the reference runs' steps at p'."""
    from repro_torch.core import ceil_log2
    w, w2 = DRILL["world"], DRILL["world"] - 1
    pre = DRILL["shrink_at_step"]
    post = DRILL["steps"] - DRILL["ckpt_every"]
    return (pre * w * n_zero[w] * ceil_log2(w)
            + 2 * post * w2 * n_zero[w2] * ceil_log2(w2))


def resize_round_trip(mgr, step: int, world: int, new_world: int) -> None:
    """``resize_zero1_state`` world -> new_world -> world on the full-width
    gathered state of the drill's checkpoint, on the host, leaf by leaf:
    every ``m`` / ``v`` array back bitwise."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import leaf_dtype, param_shapes
    from repro_torch.optim.zero1 import (GradSyncConfig, Zero1State,
                                         resize_zero1_state)
    cfg = get_config(DRILL["arch"])
    template = T.unflatten(
        (path, torch.empty(shape, dtype=leaf_dtype(cfg, path),
                           device="meta"))
        for path, shape in T.flatten(param_shapes(cfg)))
    t0 = time.perf_counter()
    _, _, opt, man = mgr.restore(step, template, device="meta")
    check(man["world"] == world, f"resize: checkpoint world {man['world']}")
    items = T.flatten(template)
    sync, n = GradSyncConfig(), len(items)
    moved = 0
    for i, (path, shape_t) in enumerate(items):
        for half in (0, n):
            arr = opt[f"leaf_{half + i}"]
            one = {path[-1]: shape_t}
            st = Zero1State(m={path[-1]: arr}, v={}, step=0)
            there = resize_zero1_state(st, one, new_world, sync)
            back = resize_zero1_state(there, one, world, sync)
            check(np.array_equal(back.m[path[-1]], arr),
                  f"resize {world} -> {new_world} -> {world} lost bits in "
                  f"{'.'.join(path)}")
            moved += arr.nbytes
    print(f"resize_zero1_state {world} -> {new_world} -> {world} on the "
          f"host: every m and v array of the full-width gathered state "
          f"({moved / 1e9:.2f} GB) back bitwise, in "
          f"{time.perf_counter() - t0:.1f} s")


def phase_elastic_drill(smi: str) -> dict:
    """Phase 9 (c): the elastic shrink drill at full width: 3 -> 2 ranks
    after a rank loss at step 4, resumed from the step-3 checkpoint, the
    resumed losses bitwise an uninterrupted p' = 2 run's from the same
    checkpoint; every build_zero1 plan verified."""
    import shutil
    import tempfile
    import torch
    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.elastic import run_drill
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.zero1 import is_zero_leaf
    cfg = get_config(DRILL["arch"])
    shapes = [s for _, s in T.flatten(param_shapes(cfg))]
    w, w2 = DRILL["world"], DRILL["world"] - 1
    n_zero = {p: sum(is_zero_leaf(s, p, 1024) for s in shapes)
              for p in (w, w2)}
    print(f"elastic drill: run_drill({DRILL}); {cfg.name} full width, "
          f"{cfg.n_layers} layers; reduced: none")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    free = shutil.disk_usage(ckpt_dir).free
    print(f"elastic drill: checkpoints in {ckpt_dir} ({free / 1e9:.1f} GB "
          f"free on its disk)")
    try:
        zero_counts()
        t0 = time.perf_counter()
        with Preflight("elastic drill") as pf:
            res = run_drill(ckpt_dir=ckpt_dir, compare_ref=True, **DRILL)
            pf.extra = len(res["report"].replans)
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {name: 0 for name in counters()}
        want["fused_round"] = drill_launches(n_zero)
        for name, n in want.items():
            check(counts[name] == n, f"elastic drill: {name} launched "
                  f"{counts[name]} times, expected {n}")
        rep, ck = res["report"], res["ckpt"]
        check(res["resumed_step"] == DRILL["ckpt_every"]
              and res["lost_steps"] == 1 and not rep.restarted,
              f"elastic drill: resumed at {res['resumed_step']}, lost "
              f"{res['lost_steps']}, restarted {rep.restarted}")
        check(all(r.verified and r.new_p == w2 for r in rep.replans),
              "elastic drill: a re-planned spec was not verified")
        check(all(math.isfinite(x) for _, x in res["pre"] + res["post"]),
              "elastic drill: non-finite loss")
        check(res["bitwise"], f"elastic drill: resumed losses {res['post']} "
              f"differ from the p'={w2} reference's {res['ref']}")
        print(f"elastic drill: pre {res['pre']}")
        print(f"elastic drill: post {res['post']} bitwise the p'={w2} "
              f"reference run's {res['ref']}")
        print(f"elastic drill: detected at step {res['detected_at']}, resumed "
              f"from step {res['resumed_step']}, {res['lost_steps']} step "
              f"lost; re-planned {len(rep.replans)} specs in "
              f"{rep.replan_us:.0f} us, evicted {rep.evicted}; phases "
              + ", ".join(f"{n} {t:.3f} s" for n, t in rep.phases))
        write = ck["write"]
        print(f"elastic drill: checkpoint of step {write['step']}: "
              f"{write['bytes']} bytes on disk, written in {write['s']:.1f} s "
              f"(background); restores {[round(t, 1) for t in ck['restore_s']]}"
              f" s (resume, reference)")
        print("elastic drill: peak memory allocated per world: "
              + ", ".join(f"{k} {v / 2**30:.2f} GiB"
                          for k, v in res["peaks"].items()))
        print(f"elastic drill: launches {counts}; {wall:.1f} s ({smi})")
        resize_round_trip(CheckpointManager(ckpt_dir, keep_last=1),
                          res["resumed_step"], w, w2)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    if len(sys.argv) == 3 and sys.argv[1] == AGAINST:
        return against_report(sys.argv[2])
    if sys.argv[1:] == [PROFILE_WIRE_STEP]:
        return profile_wire_step()
    if sys.argv[1:] == [PROFILE_EP_STEP]:
        return profile_ep_step()
    if len(sys.argv) == 3 and sys.argv[1] == PROFILE_BUCKET_STEP:
        return profile_bucket_step(int(sys.argv[2]))
    t_all = time.perf_counter()
    smi = phase_card_and_build()
    max_err, step = phase_kernel_vs_plain()
    wire_errs, wire = phase_wire_kernels()
    br_err, br = phase_block_reduce()
    perm_err, perm = phase_permute_rows()
    phase_collectives()
    phase_wire_collectives()
    phase_alltoall()
    with Preflight("main path"):
        counts, _, _, f32_rs_bytes, ref = phase_main_path()
    paths = phase_wire_path(f32_rs_bytes)
    ep_a, ep_b = phase_ep_path()
    sweep = phase_conformance(smi)
    phase_nonuniform(smi)
    phase_nonuniform_timing(smi)
    t8 = time.perf_counter()
    phase_paper_comparison(smi)
    phase_broadcast_hierarchical(smi)
    print(f"phase 8 (a), (b) in {time.perf_counter() - t8:.1f} s")
    syncs = phase_grad_syncs(smi, ref, paths["ref"])
    print(f"phase 8 in {time.perf_counter() - t8:.1f} s ({smi})")
    del ref, paths["ref"]
    t9 = time.perf_counter()
    phase_verifier()
    rowwise = phase_rowwise()
    drill = phase_elastic_drill(smi)
    print(f"phase 9 in {time.perf_counter() - t9:.1f} s ({smi})")
    by_path = {"4": counts, "5a": paths["a"][1], "5b": paths["b"][1],
               "6a": ep_a[1], "6b": ep_b[1], "7a": sweep, **syncs,
               "9b": rowwise, "9c": drill}

    def row(name, source, replaces, st, err):
        n = {path: c[name] for path, c in by_path.items()}
        # ``launches`` counts the workload paths (4 to 6, 8's and 9's) only:
        # the sweep of 7 (a) is a correctness check on tiny blocks, not a
        # workload.
        work = sum(k for path, k in n.items() if path != "7a")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": work,
                "launches_by_path": n, "max_abs_err": err, "ms": st["ms"],
                "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                "bound_by": "bytes", "library_ms": st.get("library_ms")}

    print(json.dumps({"kernels": [
        row("fused_round", "src/repro_torch/csrc/fused_round.cu",
            "src/repro/kernels/fused_round.py:109", step, max_err),
        row("fused_round_dq", "src/repro_torch/csrc/fused_round_dq.cu",
            "src/repro/kernels/fused_round.py:228", wire["fused_round_dq"],
            wire_errs["fused_round_dq"]),
        row("quantize", "src/repro_torch/csrc/quantize.cu",
            "src/repro/kernels/quantize.py:83", wire["quantize"],
            wire_errs["quantize"]),
        row("dequant_add", "src/repro_torch/csrc/quantize.cu",
            "src/repro/kernels/quantize.py:131", wire["dequant_add"],
            wire_errs["dequant_add"]),
        row("block_reduce", "src/repro_torch/csrc/block_reduce.cu",
            "src/repro/kernels/block_reduce.py:40", br,
            max(br_err, wire_errs["block_reduce"])),
        row("permute_rows", "src/repro_torch/csrc/permute_rows.cu",
            "src/repro/kernels/fused_round.py:319", perm, perm_err)]}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
