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
5. the int8 wire through the launcher's own argv, full width: (a) phase
   4's command (28 layers) with ``--wire-dtype int8
   --no-error-feedback`` (exact launch counts of ``quantize`` and
   ``fused_round_dq``, none of ``fused_round``; sync bytes per step
   beside phase 4's; one step each with the kernels on and off, bitwise
   equal on every rank; the kernel-on session's warm step profiled as
   phase 4's), and (b) ``--mesh 2x1 --global-batch 2 --wire-dtype
   int8`` with error feedback on, at 7 of 28 layers (exact launch
   counts, finite losses);
6. the expert-parallel MoE path (phi-3.5-MoE) through the launcher's
   session builder: (a) full width, 1 layer, ``--mesh 1x2 --mode zero1
   --moe-dispatch ep``, seq 2048 (a 2x2 mesh's four whole replicas with
   their AdamW state do not fit one card at any depth), 4 steps with the
   launch counts set to 0 just before and read just after, exact
   exchange and ``permute_rows`` launch counts, step 0 bitwise equal
   with the kernels on and off on every rank, peak memory, warm step
   times and the kernel-on session's warm step profiled; (b) scaled
   down on a 2x2 mesh
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
   ``LocalMesh``, bitwise the CPU's, exchanges exact; (c)-(f) at 4 of
   28 layers (every width), each held against one step of phase 4's
   argv and of phase 5 (a)'s at that depth: (c) phase 4's argv plus
   ``--bucket-bytes 25000000`` and ``2147483648``, each a 2-step
   session built from that argv with the launch counts set to 0 just
   before: ``fused_round`` launches, exchanges and sync bytes exact
   (``plan_grad_buckets``), step 0's loss and the params after it
   bitwise the per-leaf sync's, warm step ms and peak memory; (d) phase
   5 (a)'s argv plus ``--bucket-bytes 25000000``: ``quantize`` /
   ``fused_round_dq`` launches exact, first moments within the wire
   tolerance of the per-leaf sync's, grad norm of phase 5 (a)'s, on and
   off bitwise; (e) ``--grad-sync ring`` and ``xla``, 2 steps: step-0
   loss bitwise the per-leaf sync's, params within one update,
   exchanges exact, warm step; (f) ``--grad-sync allreduce`` on a 2x1
   mesh through the launcher (at 28 layers three ranks' full moments do
   not fit one card).

9. the plan verifier as pre-flight, per-sequence MoE dispatch and the
   elastic drill: (a) ``verify.run((2, 3, 5, 8, 16))`` clean, a plan with
   a dropped skip refused, and over phase 4 and (c) every plan a
   ``build_zero1`` call compiles (and the drill's re-plan) verified,
   counted (``Preflight``); (b) phi-3.5-MoE every width, 1 layer, seq
   2048, ``--mesh 2x1 --moe-dispatch rowwise --global-batch 4`` in zero1
   for 2 steps, ``fused_round`` launches and exchanges exact, peak memory
   and warm step, and one full-width float32 MoE layer of two sequences
   against the global dispatch of each sequence alone within 2e-5; (c)
   the elastic shrink drill at full width (qwen3-1.7b, 3 of 28 layers, seq
   2048): world 3, a checkpoint at step 3, rank 1 lost at step 4,
   resumed at p' = 2 from step 3, the resumed losses bitwise an
   uninterrupted p' = 2 run's from the same checkpoint; ``fused_round``
   launches exact; the recovery report, checkpoint bytes, write and
   restore seconds and the peak memory of each world printed; then
   ``resize_zero1_state`` 3 -> 2 -> 3 bitwise on the host over the
   checkpoint's gathered state.  The checkpoints go to a temporary
   directory under ``build/``, removed at the end.

10. serving: (a) ``python -m repro_torch.launch.serve --arch qwen3-1.7b
   --batch 8 --prompt-len 2048 --max-new 128`` through its argv (full
   width, 28 layers, bf16, random weights from seed 0; the prefill runs
   flash attention): tokens in range, time to first token, decode step
   p50 / p99 beside its byte bound, steady-state tokens/s of the second
   call, KV-cache bytes, peak memory; (b) the same config in float32,
   batch 2, prompt 2048, 16 new tokens: every decode step's logits within
   1e-3 of ``forward_logits`` over the teacher-forced sequence, greedy
   tokens equal to its argmax, ``generate`` equal to the loop; largest
   gap and smallest top-2 margin printed; (c) 16 requests from seed 0
   (prompts 256-2048 in steps of 64, max_new 16-128) through
   ``Scheduler`` with ``max_batch=8, kv_block_size=16``: in float32 (every
   width, 2 of 28 layers) each
   request's tokens against a one-shot B=1 ``generate`` of it alone (a
   split passes only where the one-shot's top-2 margin at the first
   differing token is below the logits gap there; both printed), in
   bf16 timed (decode-boundary p50 / p99, tokens/s, decode steps and
   prefills, peak memory); (d) ``build_serve_session(replicas=3)`` at
   (a)'s shapes, 2 of 28 layers: the broadcast fan-out's 14 leaves x 2
   exchanges, bytes and seconds, every replica's weights bitwise the
   source's,
   each replica's rows bitwise a single engine's on the same rows; (e)
   phi-3.5-MoE every width, depth 32 -> 8, ``moe_dispatch="ep"`` over 2
   ranks sharing one parameter tree, batch 2, prompt 2048, 32 new tokens:
   ``permute_rows`` launched exactly 2 x 2 x 8 x (1 + 32) times (counts
   set to 0 just before), tokens bitwise with the kernel on and off,
   agreement with the global dispatch of the same weights, peak memory
   and decode ms.

11. the other architecture families: (a) ``python -m
   repro_torch.launch.train`` with phase 4's argv for ``hymba-1.5b``
   (seq 2048: past its 1024-token window; 8 of 32 layers),
   ``xlstm-125m`` (seq 128) and ``whisper-small`` (1500 encoder frames,
   448 decoder tokens), full width, 2 steps over 3 virtual ranks: ``fused_round``
   launches, sync bytes and exchanges exact, step seconds and peak
   memory, then step 0 again with ``--fused-kernel off``: loss, grad norm
   and the params after it bitwise; and hymba with ``--wire-dtype int8
   --no-error-feedback`` for 2 steps, ``quantize`` and ``fused_round_dq``
   launches exact; (b) in phase 2, ``fused_round``, ``quantize`` and
   ``fused_round_dq`` bitwise their plain versions at every zero-leaf
   round shape of the three (p = 3), the shapes printed; (c) greedy bf16
   serving of whisper (8 x 320 frames and prompt, 128 new) through
   ``python -m repro_torch.launch.serve``'s argv, and of hymba (depth 32
   -> 8; 4 x 2048, 64 new), xlstm (depth 12 -> 3; 8 x 2048, 128 new),
   llama-3.2-vision-90b (depth 100 -> 5: one group; 4096 image tokens)
   and qwen1.5-110b (depth 80 -> 2; QKV bias, 2 x 2048, 32 new), every
   width, through the session
   builder with the launcher's inputs: time to first token, decode p50 /
   p99, tokens/s, cache or state bytes, peak memory, no kernel launched;
   and for each a float32 run at batch 2, 16 new tokens: prefill and
   every decode step within 1e-3 of ``forward_logits``.

13. the roofline of the card's own runs (``repro_torch.roofline``; it
   runs nothing new, in well under a second): for phase 4's, phase 5
   (a)'s and each phase 11 (a) run's fastest warm step, phase 10 (a)'s
   time to first token (a ``prefill`` cell of 8 x 2048) and decode p50
   (a ``decode`` cell at the 2176-token cache each step reads), and under
   ``--cards 4`` phase 12 (c)'s world step: the ``CellSpec``, the
   compute, memory and collective terms on the H100's data-sheet peaks,
   the bound (the largest), the bottleneck, measured ÷ bound and
   ``mfu``; the sync's bytes and exchanges a step counted from the plans
   (``sync_counts``) beside the launcher's ``comm.bytes`` /
   ``comm.exchanges``, which must be equal, and no measured time below
   its bound; one JSON record a path in ``build/roofline`` and the
   rendered table (``repro_torch.roofline.report``).  Tensor-parallel
   paths (phases 14 (a), 15 (a), and under ``--cards 4`` 14 (c), (d),
   15 (d), (e)) are
   ``CellSpec(tp=M)`` with both axes' counts from ``tp_counts`` (the
   plans' data-axis sync of the blocks, the model's model-axis calls
   from a run on ``meta`` tensors), equal to ``comm.bytes`` /
   ``exchanges`` / ``natives`` of both axes on every step.

14. tensor parallelism (``--mesh DxM`` with M > 1: ZeRO-1 over the data
   axis, TP over the model axis) and ``--mode fsdp_auto``: (a) phase 4's
   argv at ``--mesh 2x2 --global-batch 2 --steps 3`` (qwen3-1.7b full
   width, 7 of 28 layers, bf16, 4 virtual ranks on one card), the launch
   counts set to 0 just before: ``fused_round`` launched 3 steps x 4
   ranks x the
   blocks' zero leaves x 1 round, the warm step, the peak, a profiled
   warm step's idle share; step 0 bitwise with ``--fused-kernel off``;
   at 3 layers in float32, 2 steps, held against the 2x1 path (loss
   within 1e-5 relative, params rtol 1e-4 / atol 1e-6); (b) ``--mode
   fsdp_auto`` on 2x2 at 3 layers in float32 against mode ``single``
   at the same global batch (the same bounds), no kernel launched; and
   qwen1.5-110b at full width, ``tp_fsdp`` on 2x2, at 1 of 80 layers
   (the 12-bytes-a-parameter reckoning printed): step seconds and peak.
   Under ``--cards 4``: (c) (a)'s argv on a 2x2 ``DistMesh`` over NCCL,
   full depth: per-rank steps, peaks, rank 0's idle share; at 3 layers
   every rank's blocks against (a)'s in-process run within rtol 1e-5 /
   atol 1e-5 (the model axis sums with NCCL's ``all_reduce``; whether
   they came out bitwise is printed); (d) qwen1.5-110b fsdp_auto on a
   2x2 ``DistMesh`` at 12 layers: step seconds, peak a card.

15. tensor parallelism and fsdp_auto of the MoE and VLM families: (a)
   phi-3.5-MoE (global dispatch) at ``--mesh 2x2 --global-batch 2
   --steps 3``, full width, 2 of 32 layers, bf16, 4 virtual ranks on one
   card: ``fused_round`` launched 3 steps x 4 ranks x the blocks' zero
   leaves x 1 round, the warm step, the peak, a profiled warm step's
   idle share, step 0 bitwise with ``--fused-kernel off``; at 1 layer in
   float32, 2 steps, ``--mesh 1x2`` held against mode ``single`` at
   global batch 1 (phase 14's bounds; the 2x1 path's two whole float32
   replicas do not fit the card); (b)
   the same at ``--moe-dispatch rowwise``, 2 steps, with its hold; (c)
   ``--mode fsdp_auto`` of grok-1-314b and llama-3.2-vision-90b at their
   scale-down configs (float32) on 2x2 against mode ``single`` at the
   same global batch, no kernel launched.  Under ``--cards 4``, on a 2x2
   ``DistMesh`` over NCCL, fsdp_auto ``tp_fsdp`` at full width: (d)
   grok-1-314b at 3 of 64 layers, (e) llama-3.2-vision-90b at 20 of 100
   (4 groups), each with the 12-bytes-a-parameter reckoning printed
   first: per-rank step seconds, the peak a card, rank 0's idle share;
   at the scale-down config every rank's blocks against the in-process
   run within rtol 1e-5 / atol 1e-5.

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

``python3 chip_smoke.py --cards 4`` runs phase 1 on every card, phase
12 (b)-(g), phase 14 (c), (d), phase 15 (d), (e) and phase 13 for 12
(c), 14 (c), (d), 15 (d), (e).

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
#: phase 5 (b)'s depth (every width kept), cut for the script's time
P5B_LAYERS = 7

#: phase 13's inputs: label -> what phases 4, 5 (a), 10 (a), 11 (a) and
#: 12 (c) measured (see :func:`measured_train`, :func:`phase_roofline`)
MEASURED: dict[str, dict] = {}


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
    from repro_torch.tree import same_bits as equal
    return equal(a, b)


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


#: wall seconds of each phase of the default run, in order (printed
#: before the kernels line: the run has a time limit of 1200 s)
SECONDS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in :data:`SECONDS`."""
    t0 = time.perf_counter()
    out = fn(*args)
    SECONDS[name] = round(time.perf_counter() - t0, 1)
    return out


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


def wire_leaves(p: int, arch: str = "qwen3-1.7b",
                n_layers: int | None = None):
    """``(leaf, shape, cols, padded cols, g)`` of every zero leaf's
    reduce-scatter at ``p`` ranks (``arch`` full width, at ``n_layers``
    layers, by default the depth phase 11 trains it at,
    :data:`FAMILY_LAYERS`, or its own): the columns of one block and, on
    the int8 wire, the same padded to whole groups of
    ``g = min(DEFAULT_GROUP, cols)``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch import tree as T
    from repro_torch.kernels import DEFAULT_GROUP
    from repro_torch.models import param_shapes
    from repro_torch.optim.zero1 import is_zero_leaf
    cfg = get_config(arch)
    n_layers = n_layers or FAMILY_LAYERS.get(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    out = []
    for path, shape in T.flatten(param_shapes(cfg)):
        if not is_zero_leaf(shape, p, 1024):
            continue
        ld_pad = shape[0] + (-shape[0]) % p
        cols = ld_pad // p * math.prod(shape[1:])
        g = min(DEFAULT_GROUP, cols)
        out.append((".".join(map(str, path)), shape, cols,
                    -(-cols // g) * g, g))
    return out


def main_path_rounds(arch: str = "qwen3-1.7b"):
    """Every ``(leaf, lo, nb, next_lo, cols)`` fused_round launch shape of
    one main-path step on one rank (f32 payload, halving at p = 3) of
    ``arch`` at full width."""
    from repro_torch.core import reduce_scatter_plan
    rounds = reduce_scatter_plan(P_MAIN)
    out = []
    for leaf, _, cols, _, _ in wire_leaves(P_MAIN, arch):
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
    # Phase 11 (b): every round shape of the other families' zero leaves.
    for arch in FAMILY_TRAIN:
        shapes = main_path_rounds(arch)
        for leaf, lo, nb, nxt, cols in shapes:
            live = torch.randn((lo, cols), device="cuda", generator=gen)
            recv = torch.randn((nb, cols), device="cuda", generator=gen)
            compare(live, recv, nb, nxt, "add", f"{arch} {leaf} lo={lo}")
            del live, recv
        torch.cuda.empty_cache()
        print(f"phase 11 (b): fused_round bitwise its plain version at "
              f"{arch}'s {len(shapes)} zero-leaf round launches (p = "
              f"{P_MAIN}, f32 add); (lo, nb, next_lo, cols): "
              f"{sorted({r[1:] for r in shapes})}")
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


def wire_launches(p: int, arch: str = "qwen3-1.7b"):
    """Every kernel launch of one rank's wire step at ``p`` (``arch`` full
    width): ``("quantize", leaf, rows, cols, g)`` for round 0's send and
    ``("fused_round_dq", leaf, lo, nb, next_lo, cols, g)`` per round."""
    from repro_torch.core import reduce_scatter_plan
    rounds = reduce_scatter_plan(p)
    out = []
    for leaf, _, _, cols, g in wire_leaves(p, arch):
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
    # Phase 11 (b): every wire launch shape of the other families'
    # zero leaves.
    for arch in FAMILY_TRAIN:
        launches = wire_launches(P_MAIN, arch)
        for launch in launches:
            if launch[0] == "quantize":
                _, leaf, rows, cols, g = launch
                check_quantize(randn((rows, cols)), g,
                               f"{arch} {leaf} round-0 send")
            else:
                _, leaf, lo, nb, nxt, cols, g = launch
                codes, scales = ref.quantize_ref(randn((nb, cols), 3.0),
                                                 group=g)
                check_dq(randn((lo, cols)), codes.contiguous(), scales, nb,
                         nxt, "add", g, f"{arch} {leaf} lo={lo}")
            torch.cuda.empty_cache()
        print(f"phase 11 (b): quantize and fused_round_dq bitwise their "
              f"plain versions at {arch}'s {len(launches)} wire launches "
              f"(p = {P_MAIN}); (kernel, shape, g): "
              f"{sorted({(x[0], x[2:-1], x[-1]) for x in launches})}")
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
    """``permute_rows`` against its plain version, bitwise, at every
    shape the alltoalls of phases 3, 6 and 10 (e) give it, then timed at
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
              ("phase 6 (c) pe=3", ep_shape(cfg, 3, 2048), torch.float32),
              # 10 (e): every rank routes the whole batch, b x s tokens in
              # the prefill and b tokens a decode step.
              ("phase 10 (e) prefill",
               ep_shape(cfg, EP_SERVE["ep_devices"],
                        EP_SERVE["batch"] * EP_SERVE["prompt"]),
               torch.bfloat16),
              ("phase 10 (e) decode",
               ep_shape(cfg, EP_SERVE["ep_devices"], EP_SERVE["batch"]),
               torch.bfloat16)]
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
          f"every alltoall shape of phases 3, 6 and 10 (e))")
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


def sync_bytes(p: int, wire: bool, arch: str = "qwen3-1.7b",
               n_layers: int | None = None) -> tuple[int, int]:
    """Exact bytes one step's exchanges send at ``p`` ranks, summed over
    the ranks (``n_layers``: as :func:`wire_leaves`): the gradient
    reduce-scatter's (float32 rows, or int8 wire rows padded to whole
    groups) and the parameter allgather's (shards in the parameters'
    dtype, never on the wire).  Tiny leaves go through an all-reduce,
    which is not an exchange."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import wire_width
    itemsize = getattr(torch, get_config(arch).dtype).itemsize
    rs = ag = 0
    for _, _, cols, padded, g in wire_leaves(p, arch, n_layers):
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
    measured_train("4", "qwen3-1.7b", 2048, P_MAIN, run, peak, {})
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
    del sess, ref, snapshot
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rs_bytes


def wire_session_a(fused: bool):
    """A fresh path (a) session: p = 3 on the int8 wire, EF off."""
    from repro_torch.launch import bootstrap
    return bootstrap.build_session(
        arch="qwen3-1.7b", steps=STEPS, seq_len=2048, global_batch=3,
        dp=P_MAIN, mode="zero1", wire_dtype="int8", error_feedback=False,
        use_fused_kernel=fused, device="cuda")


def phase_wire_path(f32_rs_bytes: int):
    """Phase 5: the int8 wire through the launcher's own argv."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import bootstrap

    n_a = len(wire_leaves(P_MAIN))
    n_b = len(wire_leaves(P_EF, n_layers=P5B_LAYERS))
    print(f"wire path (a): {' '.join(WIRE_A_ARGV)}")
    print("reduced: none (every width and all 28 layers)")
    want = {name: 0 for name in counters()}
    want.update(quantize=STEPS * P_MAIN * n_a,
                quantize_rows=STEPS * P_MAIN * n_a,
                fused_round_dq=STEPS * P_MAIN * n_a * 2)
    run_a, counts_a, peak_a, rs_a, _ = run_path(
        WIRE_A_ARGV, "wire path (a)", want, P_MAIN, wire=True)
    measured_train("5a", "qwen3-1.7b", 2048, P_MAIN, run_a, peak_a,
                   dict(wire_dtype="int8", error_feedback=False))
    print(f"wire path (a): reduce-scatter bytes per step {rs_a} vs "
          f"{f32_rs_bytes} in float32 (phase 4): {f32_rs_bytes / rs_a:.4f}x "
          f"fewer")

    def one_step(fused):
        """Step 0 of a fresh session: its loss and grad norm, the launches
        it made, and rank 0's params after it (on the host), once every
        rank's params are checked bitwise equal to rank 0's; the kernel-on
        session then takes step 1 unprofiled and step 2 profiled."""
        sess = wire_session_a(fused)
        zero_counts()
        metrics = bootstrap.run_step(sess, 0)
        counts = read_counts()
        ranks_agree(sess.params, "wire path (a)")
        params = [(path, t.cpu()) for path, t in T.flatten(sess.params[0])]
        if fused:
            wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
            profiled_step(lambda: bootstrap.run_step(sess, 2),
                          "warm step 2 of a kernel-on wire session, path "
                          "(a)", wall_1)
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
    del on, off
    gc.collect()
    torch.cuda.empty_cache()

    print(f"wire path (b): {' '.join(WIRE_B_ARGV)}")
    print(f"reduced: depth 28 -> {P5B_LAYERS}, every width kept; p = 2, not "
          f"3: at 28 layers three ranks' full-leaf EF residuals do not fit "
          f"one card")
    want = {name: 0 for name in counters()}
    want.update(quantize=STEPS * P_EF * n_b * 2,
                quantize_rows=STEPS * P_EF * n_b,
                fused_round_dq=STEPS * P_EF * n_b)
    with cut_depth(P5B_LAYERS):
        run_b, counts_b, peak_b, _, _ = run_path(
            WIRE_B_ARGV, "wire path (b)", want, P_EF, wire=True,
            sync=sync_bytes(P_EF, True, n_layers=P5B_LAYERS))
    return {"a": (run_a, counts_a, peak_a), "b": (run_b, counts_b, peak_b)}


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


def run_ep_path(label: str, kw: dict, profile: bool = False):
    """Drive ``kw``'s ep session for its steps with every launch count set
    to 0 just before and read just after; check counts, exchanges and
    finite losses; then one step each with the kernels on and off from
    the same seed, which must agree bitwise on every rank; with
    ``profile``, the kernel-on session then takes step 1 unprofiled and
    step 2 profiled."""
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
        if fused and profile:
            wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
            profiled_step(lambda: bootstrap.run_step(sess, 2),
                          f"warm step 2 of the kernel-on session, {label}",
                          wall_1, ranks=kw["dp"] * kw["mp"])
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
    from repro_torch.models.moe import moe_draws
    cfg = dataclasses.replace(get_config(EP_ARCH), dtype="float32",
                              moe_dispatch="ep")
    gen = torch.Generator(device="cuda").manual_seed(6 + pe)
    params = dict(moe_draws(gen, cfg, torch.float32, "cuda"))
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
    run_a = run_ep_path("ep MoE path (a)", EP_MAIN, profile=True)
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
#: phase 8 (c)-(f): the depth of every run (every width kept; at 28 layers
#: the phase took 141.2 s of the script's 1200 s, PERF.md §4).
P8_LAYERS = 4
#: phase 8 (f): the no-ZeRO baseline on two ranks (three ranks' full
#: moments do not fit one card at 28 layers).
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


def bucket_sync(p: int, bucket_bytes: int, wire: bool, n_layers: int):
    """``(buckets, reduce-scatter bytes, allgather bytes)`` of one step of
    the bucketed sync at p ranks, qwen3-1.7b at ``n_layers`` layers:
    every bucket's block sent p - 1 times
    per rank, float32 or on the int8 wire (padded to whole groups of
    ``min(DEFAULT_GROUP, width)``), the allgather in the parameters'
    dtype."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import DEFAULT_GROUP, wire_width
    from repro_torch.optim.zero1 import plan_grad_buckets
    itemsize = getattr(torch, get_config("qwen3-1.7b").dtype).itemsize
    shapes = [shape for _, shape, _, _, _ in wire_leaves(p,
                                                        n_layers=n_layers)]
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


def phase_grad_syncs(smi: str) -> dict:
    """Phase 8 (c)-(f) at :data:`P8_LAYERS` layers, 2 steps a run (1 for
    (d)), each run's state after step 0 held against a reference's
    (:func:`hold_step0`): first the per-leaf circulant sync (phase 4's)
    and phase 5 (a)'s int8 wire take step 0 at that depth as the
    references; then the bucketed main path at both bucket sizes bitwise
    the per-leaf sync; the bucketed int8 wire with the kernels on bitwise
    the same with them off, its moments within the wire tolerance of the
    exact ones and its grad norm of phase 5 (a)'s; the ring and xla grad
    syncs within the fold tolerance of the per-leaf sync; the allreduce
    baseline at p = 2 within it of a per-leaf circulant run at p = 2.
    Returns each workload run's launch counts."""
    with cut_depth(P8_LAYERS):
        return grad_syncs(smi)


def grad_syncs(smi: str) -> dict:
    """The body of :func:`phase_grad_syncs`, within its depth cut."""
    import torch
    from repro_torch.core import ceil_log2
    depth = P8_LAYERS
    n_zero = len(wire_leaves(P_MAIN, n_layers=depth))
    q = ceil_log2(P_MAIN)
    none = {name: 0 for name in counters()}
    steps = 2
    out = {}
    cut = f"reduced: depth 28 -> {depth}, every width kept"
    print(f"grad syncs: phase 4's session at {depth} of 28 layers, every "
          f"width; {steps} steps a run, 1 for the int8 wire ({smi})")

    def report(label, run, peak, held):
        print(f"{label}: after step 0 {held}")
        print(f"{label}: warm step ms {warm_ms(run)} (host clock to device "
              f"sync; step 0 {run.step_seconds[0] * 1e3:.1f}), peak memory "
              f"allocated {peak / 2**30:.2f} GiB ({smi})")

    label = "grad syncs' reference, phase 4's per-leaf sync"
    _, _, _, _, ref = run_path(
        argv_with(MAIN_ARGV, steps=1), label,
        dict(none, fused_round=P_MAIN * n_zero * q), P_MAIN, wire=False,
        sync=sync_bytes(P_MAIN, False, n_layers=depth),
        exchanges=2 * q * n_zero,
        at_step0=lambda s, m: step0_state(s, m, label))
    label = "grad syncs' wire reference, phase 5 (a)'s int8 wire"
    _, _, _, _, wire_ref = run_path(
        argv_with(WIRE_A_ARGV, steps=1), label,
        dict(none, quantize=P_MAIN * n_zero, quantize_rows=P_MAIN * n_zero,
             fused_round_dq=P_MAIN * n_zero * q), P_MAIN, wire=True,
        sync=sync_bytes(P_MAIN, True, n_layers=depth),
        exchanges=2 * q * n_zero,
        at_step0=lambda s, m: {"grad_norm": float(m["grad_norm"])})
    for bb in BUCKETS:
        t0 = time.perf_counter()
        buckets, rs, ag = bucket_sync(P_MAIN, bb, False, depth)
        nb = len(buckets)
        argv = argv_with(MAIN_ARGV, bucket_bytes=bb, steps=steps)
        label = f"bucketed --bucket-bytes {bb}"
        print(f"{label}: {' '.join(argv)}; {nb} buckets for {n_zero} zero "
              f"leaves; {cut}")
        run, counts, peak, _, held = run_path(
            argv, label, dict(none, fused_round=steps * P_MAIN * nb * q),
            P_MAIN, wire=False, sync=(rs, ag), exchanges=2 * q * nb,
            at_step0=lambda s, m: hold_step0(s, m, ref, label, "bitwise"))
        report(label, run, peak, held)
        out[f"8c-{bb}"] = counts
        print(f"{label}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bb = BUCKETS[0]
    buckets, rs, ag = bucket_sync(P_MAIN, bb, True, depth)
    nb = len(buckets)
    label = f"bucketed int8 wire --bucket-bytes {bb}"
    on = {}

    def wire_step0(sess, metrics):
        held = hold_step0(sess, metrics, ref, label, "wire")
        gn = float(metrics["grad_norm"])
        check(abs(gn - wire_ref["grad_norm"]) <=
              WIRE_RTOL * wire_ref["grad_norm"],
              f"{label}: grad norm {gn} vs phase 5 (a)'s at this depth "
              f"{wire_ref['grad_norm']}")
        on.update(step0_state(sess, metrics, label))
        return (f"{held}, of the per-leaf sync's; grad norm {gn!r}, phase "
                f"5 (a)'s {wire_ref['grad_norm']!r}")

    for fused in ("on", "off"):
        argv = argv_with(WIRE_A_ARGV, bucket_bytes=bb, steps=1,
                         fused_kernel=fused)
        print(f"{label}: {' '.join(argv)}; {nb} buckets; {cut}")
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
        print(f"{label}: {' '.join(argv)}; {cut}")
        # ring: p - 1 rounds per RS (volume-optimal: the same bytes) and
        # the circulant allgather's q; xla: native calls only
        if impl == "ring":
            ex = n_zero * ((P_MAIN - 1) + q)
            sync = sync_bytes(P_MAIN, False, n_layers=depth)
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
    n2 = len(wire_leaves(P_ALLREDUCE, n_layers=depth))
    print(f"{label}: its reference {' '.join(circ)}")
    _, _, _, _, ref2 = run_path(  # one step, one round at p = 2
        circ, f"{label}'s reference", dict(none, fused_round=P_ALLREDUCE * n2),
        P_ALLREDUCE, wire=False,
        sync=sync_bytes(P_ALLREDUCE, False, n_layers=depth),
        at_step0=lambda s, m: step0_state(s, m, label))
    del ref2["params"]  # AdamW on whole leaves or on shards: not held
    argv = argv_with(ALLREDUCE_ARGV, steps=steps)
    print(f"{label}: {' '.join(argv)}; {cut}; p = 2, not 3 (at 28 layers "
          f"three ranks' full float32 moments, 3 x 13.8 GB, do not fit "
          f"beside the model)")
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
#: phase 9 (c): the elastic shrink drill, qwen3-1.7b full width, depth
#: cut 28 -> 3 layers so that the script, phase 11 included, stays inside
#: its 1200-s limit (PERF.md §4).
DRILL = dict(arch="qwen3-1.7b", scale_down=False, steps=5, seq_len=2048,
             global_batch=6, world=3, shrink_at_step=4, fail_rank=1,
             ckpt_every=3, keep_last=1, device="cuda", n_layers=3)


def drill_cfg():
    """The drill's config: every width of ``DRILL["arch"]`` at its
    depth."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(DRILL["arch"]),
                               n_layers=DRILL["n_layers"])


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

        def counted(model, comm, opt_cfg, sync, device=None, ep_world=None,
                    tp=None):
            self.builds += 1
            self.plans += len(collective_specs(sync, model.cfg, ep_world))
            return orig(model, comm, opt_cfg, sync, device, ep_world, tp=tp)

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
    from repro_torch.models.transformer import leaf_dtype, param_shapes
    from repro_torch.optim.zero1 import (GradSyncConfig, Zero1State,
                                         resize_zero1_state)
    cfg = drill_cfg()
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
    from repro_torch.launch.elastic import run_drill
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.zero1 import is_zero_leaf
    cfg = drill_cfg()
    shapes = [s for _, s in T.flatten(param_shapes(cfg))]
    w, w2 = DRILL["world"], DRILL["world"] - 1
    n_zero = {p: sum(is_zero_leaf(s, p, 1024) for s in shapes)
              for p in (w, w2)}
    print(f"elastic drill: run_drill({DRILL}); {cfg.name} full width, "
          f"{cfg.n_layers} layers; reduced: depth 28 -> {cfg.n_layers} "
          f"(every width kept)")
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


# ---------------------------------------------------------------------------
# Phase 10: serving (KV-cache prefill and decode, paged continuous batching,
# the broadcast weight fan-out to replicas, expert-parallel decode)
# ---------------------------------------------------------------------------

#: phase 10 (a): the one-shot serving path through the launcher's argv.
SERVE_ARGV = ["--arch", "qwen3-1.7b", "--batch", "8", "--prompt-len", "2048",
              "--max-new", "128", "--device", "cuda"]
#: phase 10 (b): the float32 parity run (the same config's widths).
SERVE_PARITY = dict(batch=2, prompt=2048, new=16)
#: the largest |decode - teacher-forced forward| logit gap (b) accepts, in
#: float32 with TF32 off (logits are O(1)).
SERVE_LOGIT_TOL = 1e-3
#: phase 10 (c): requests for the scheduler.  Prompt lengths are multiples
#: of 64 from 256 to 2048: flash attention's tile is the largest divisor
#: of S not above 512, so a prime length would run S tiles of one row.
SCHED = dict(n=16, max_batch=8, block=16, prompt_len=2048, max_new=128)
#: phase 10 (c) float32: the depth of the model the scheduler's tokens are
#: held on against one-shot runs (every width; cut from 28 for the
#: script's time limit, PERF.md §4).
SCHED_F32_LAYERS = 2
#: phase 10 (d): replicas of the broadcast fan-out, and their depth
#: (every width; cut from 28 for the script's time limit, PERF.md §4).
SERVE_REPLICAS, REPLICA_LAYERS = 3, 2
#: phase 10 (e): expert-parallel decode, phi-3.5-MoE every width.
EP_SERVE = dict(arch=EP_ARCH, moe_dispatch="ep", ep_devices=2, n_layers=8,
                batch=2, prompt=2048, new=32)


def tree_bytes(params) -> int:
    from repro_torch import tree as T
    return sum(x.numel() * x.element_size() for x in T.leaves(params))


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def free_cuda() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def check_none_launched(counts: dict, label: str) -> None:
    """The dense serving path runs none of the port's kernels."""
    check(not any(counts.values()), f"{label}: the dense path launched "
          f"kernels: {counts}")


def sched_requests(vocab: int):
    """Phase 10 (c)'s 16 requests from seed 0: prompt lengths 256-2048 (in
    steps of 64) and max_new 16-128."""
    rng = np.random.default_rng(0)
    lens = rng.integers(4, 33, SCHED["n"]) * 64
    new = rng.integers(16, SCHED["max_new"] + 1, SCHED["n"])
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), int(m))
            for n, m in zip(lens, new)]


def serve_oneshot(smi: str):
    """Phase 10 (a): ``python -m repro_torch.launch.serve`` at full width
    through its argv; two generate calls (the second is steady state)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.transformer import kv_bytes_per_token
    print(f"serving (a): serve.main({SERVE_ARGV})")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = serve.main(SERVE_ARGV)
    counts = read_counts()
    check_none_launched(counts, "serving (a)")
    peak = torch.cuda.max_memory_allocated()
    sess, out = run.session, run.tokens
    cfg = sess.cfg
    b, s, new = 8, 2048, 128
    check(out.shape == (b, new) and out.min() >= 0
          and out.max() < cfg.vocab_size, f"serving (a): tokens {out.shape} "
          f"in [{out.min()}, {out.max()}]")
    t = sess.engine.timings
    for label, kind, seq, sec in (("10a-prefill", "prefill", s, t["ttft_s"]),
                                  ("10a-decode", "decode", s + new,
                                   pct(t["step_s"], 50) / 1e3)):
        MEASURED[label] = dict(arch=cfg.name, kind=kind, seq=seq, batch=b,
                               ranks=1, local=True, mode="serve",
                               measured_s=sec, peak=peak)
    kv = b * (s + new) * kv_bytes_per_token(cfg)
    w = tree_bytes(sess.params)
    bound = (w + kv) / HBM_BYTES_PER_S * 1e3
    print(f"serving (a): {cfg.name} {cfg.n_layers} layers, {cfg.dtype}; "
          f"weights {w} bytes, KV cache {kv} bytes")
    print(f"serving (a): time to first token (prefill of {b} x {s}) "
          f"{t['ttft_s'] * 1e3:.1f} ms; decode step p50 "
          f"{pct(t['step_s'], 50):.3f} ms, p99 {pct(t['step_s'], 99):.3f} ms "
          f"over {len(t['step_s'])} (byte bound {bound:.3f} ms: weights + "
          f"the whole cache at 3.35 TB/s); first call {run.seconds:.2f} s, "
          f"steady state {b * new / run.steady_seconds:.1f} tok/s "
          f"({run.steady_seconds:.2f} s); peak memory allocated "
          f"{peak / 2**30:.2f} GiB; launches {counts} ({smi})")
    return counts, sess


def serve_scheduler_timing(sess, smi: str) -> dict:
    """Phase 10 (c), bfloat16: the 16 requests through ``Scheduler``
    (``--max-batch 8 --kv-block-size 16``), timed per decode boundary."""
    import torch
    from repro_torch.serve import ServeEngine, Scheduler
    reqs = sched_requests(sess.cfg.vocab_size)
    eng = ServeEngine(sess.model, sess.params,
                      SCHED["prompt_len"] + SCHED["max_new"])
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    sched = Scheduler(eng, max_batch=SCHED["max_batch"],
                      kv_block_size=SCHED["block"])
    t0 = time.perf_counter()
    rids = [sched.submit(p, m) for p, m in reqs]
    done = sched.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check_none_launched(counts, "serving (c) bf16")
    total = sum(len(done[r]) for r in rids)
    check(all(len(done[r]) == m for r, (_, m) in zip(rids, reqs)),
          "serving (c): a request returned the wrong number of tokens")
    pool = sched.kv.k.numel() * sched.kv.k.element_size() * 2
    print(f"serving (c) bf16: {len(reqs)} requests (prompts "
          f"{[len(p) for p, _ in reqs]}, max_new {[m for _, m in reqs]}), "
          f"{total} tokens in {dt:.2f} s = {total / dt:.1f} tok/s; "
          f"{sched.n_decode_steps} decode steps, {sched.n_prefills} prefills; "
          f"decode boundary p50 {pct(sched.boundary_s, 50):.3f} ms, p99 "
          f"{pct(sched.boundary_s, 99):.3f} ms (admissions' prefills "
          f"included); paged pool {pool} bytes; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return counts


def f32_qwen3(n_layers: int | None = None):
    """qwen3-1.7b in float32, every width (``n_layers``: depth cut), its
    model and random parameters from seed 0 on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build(cfg, remat=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    return model, params


def serve_parity(smi: str):
    """Phase 10 (b): float32, full width: every decode step's logits
    against ``forward_logits`` over the teacher-forced sequence, greedy
    tokens equal, and ``generate`` the same tokens as the loop."""
    import torch
    from repro_torch.serve import ServeEngine
    model, params = f32_qwen3()
    cfg = model.cfg
    b, s, new = (SERVE_PARITY[k] for k in ("batch", "prompt", "new"))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.no_grad():
        cache, logits = model.prefill(params, toks, s + new)
        steps, out = [logits], []
        for i in range(new):
            nxt = torch.argmax(steps[-1], dim=-1).to(torch.int32)
            out.append(nxt)
            if i < new - 1:
                cache, logits = model.decode_step(params, cache, nxt, s + i)
                steps.append(logits)
        del cache
        seq = torch.cat([toks, torch.stack(out, 1)], 1)   # (b, s + new)
        full = model.forward_logits(params, seq)
        gap, margin, flips = 0.0, float("inf"), 0
        for i, lg in enumerate(steps):
            ref = full[:, s - 1 + i]
            gap = max(gap, float((lg - ref).abs().max()))
            top2 = torch.topk(ref, 2, dim=-1).values
            margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
            flips += int((torch.argmax(ref, -1).to(torch.int32)
                          != out[i]).sum())
        scale = float(full.abs().max())
        del full
    eng = ServeEngine(model, params, s + new)
    gen = eng.generate(prompts, new)
    loop = torch.stack(out, 1).cpu().numpy()
    print(f"serving (b) f32: {b} x {s} prompt, {new} tokens: max |decode - "
          f"teacher-forced forward| logits {gap:.3e} (limit "
          f"{SERVE_LOGIT_TOL:g}; max |logit| {scale:.3f}); smallest top-2 "
          f"margin {margin:.3e}; greedy tokens differing {flips}; generate "
          f"== the loop: {np.array_equal(gen, loop)} ({smi})")
    check(gap <= SERVE_LOGIT_TOL, f"serving (b): logits gap {gap}")
    check(flips == 0, f"serving (b): {flips} greedy tokens differ from the "
          f"teacher-forced forward's argmax")
    check(np.array_equal(gen, loop), "serving (b): generate differs from "
          "the prefill + decode loop")
    return model, params


def serve_scheduler_parity(model, params, smi: str) -> None:
    """Phase 10 (c), float32: every request's scheduler tokens against a
    one-shot B=1 ``generate`` of that request alone.  A request may split
    only where the one-shot run's top-2 margin at its first differing
    token is below the logits gap measured there (GEMMs of other batch
    shapes round differently on the card)."""
    import torch
    from repro_torch.serve import ServeEngine, Scheduler
    max_len = SCHED["prompt_len"] + SCHED["max_new"]
    reqs = sched_requests(model.cfg.vocab_size)
    eng = ServeEngine(model, params, max_len)
    sched = Scheduler(eng, max_batch=SCHED["max_batch"],
                      kv_block_size=SCHED["block"])
    rec: dict = {}
    prefill_fn, decode_fn = eng.prefill_fn, eng.decode_fn

    def rec_prefill(p, tokens, extras=None):
        # Admission is FCFS, so the k-th prefill is request k's.
        cache, logits = prefill_fn(p, tokens, extras)
        rec[len(rec)] = [logits[0].clone()]
        return cache, logits

    def rec_decode(p, cache, token, pos):
        cache, logits = decode_fn(p, cache, token, pos)
        for i, req in enumerate(sched.slots):
            if req is not None:
                rec[req.rid].append(logits[i].clone())
        return cache, logits

    eng.prefill_fn, eng.decode_fn = rec_prefill, rec_decode
    t0 = time.perf_counter()
    rids = [sched.submit(p, m) for p, m in reqs]
    got = sched.run()
    t_sched = time.perf_counter() - t0
    eng.prefill_fn, eng.decode_fn = prefill_fn, decode_fn
    same, splits = 0, []
    t0 = time.perf_counter()
    for rid, (prompt, m) in zip(rids, reqs):
        one = eng.generate(prompt[None], m)[0]
        if np.array_equal(got[rid], one):
            same += 1
            continue
        j = int(np.nonzero(got[rid] != one)[0][0])
        with torch.no_grad():
            cache, lg = model.prefill(
                params, torch.as_tensor(prompt[None], device="cuda"), max_len)
            for i in range(j):
                cache, lg = model.decode_step(
                    params, cache, torch.as_tensor(one[i:i + 1],
                                                   device="cuda"),
                    len(prompt) + i)
            top2 = torch.topk(lg[0], 2).values
            margin = float(top2[0] - top2[1])
            gap = float((rec[rid][j] - lg[0]).abs().max())
        del cache
        splits.append((rid, j, margin, gap))
    print(f"serving (c) f32, {model.cfg.n_layers} layers (reduced: depth "
          f"28 -> {model.cfg.n_layers}, every width kept): {same} of "
          f"{len(reqs)} requests bitwise a "
          f"one-shot B=1 generate ({sched.n_decode_steps} decode steps, "
          f"{sched.n_prefills} prefills; scheduler {t_sched:.1f} s, one-shot "
          f"runs {time.perf_counter() - t0:.1f} s); splits (rid, first "
          f"differing step, one-shot top-2 margin there, logits gap there): "
          f"{splits} ({smi})")
    for rid, j, margin, gap in splits:
        check(margin < gap, f"serving (c): request {rid} splits at step {j} "
              f"with a top-2 margin {margin} above the logits gap {gap}")
    del rec


def serve_replicas(smi: str) -> dict:
    """Phase 10 (d): ``--replicas 3`` at (a)'s shapes through
    ``build_serve_session``: the fan-out bitwise with 14 x 2 exchanges;
    each replica's rows bitwise a single engine's on the same rows."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core import ceil_log2
    from repro_torch.launch import bootstrap
    from repro_torch.serve import ServeEngine
    b, s, new = 8, 2048, 128
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    sess = bootstrap.build_serve_session(
        arch="qwen3-1.7b", max_len=s + new, replicas=SERVE_REPLICAS,
        device="cuda", n_layers=REPLICA_LAYERS)
    st = sess.push_stats
    want = st["n_leaves"] * ceil_log2(SERVE_REPLICAS)
    check(st["n_leaves"] == 14 and st["exchanges"] == want,
          f"serving (d): {st['exchanges']} exchanges for {st['n_leaves']} "
          f"leaves, expected {want}")
    src = T.leaves(sess.params)
    for e in sess.replica_set.engines:
        check(all(same_bits(a, c) for a, c in zip(src, T.leaves(e.params))),
              "serving (d): a replica's weights differ from the source's")
    prompts = np.random.default_rng(0).integers(
        0, sess.cfg.vocab_size, (b, s)).astype(np.int32)
    t0 = time.perf_counter()
    out = sess.replica_set.generate(prompts, new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check_none_launched(counts, "serving (d)")
    single = ServeEngine(sess.model, sess.params, s + new)
    for r in range(SERVE_REPLICAS):
        rows = list(range(r, b, SERVE_REPLICAS))
        check(np.array_equal(out[rows], single.generate(prompts[rows], new)),
              f"serving (d): replica {r}'s tokens differ from a single "
              f"engine's on rows {rows}")
    print(f"serving (d): {sess.cfg.n_layers} layers (reduced: depth 28 -> "
          f"{REPLICA_LAYERS}, every width kept); broadcast fan-out to "
          f"{SERVE_REPLICAS} replicas: "
          f"{st['n_leaves']} leaves, {st['bytes']} bytes, {st['rounds']} "
          f"rounds, {st['exchanges']} exchanges, {st['seconds']:.3f} s; "
          f"every replica's weights bitwise the source's; {b} x {new} "
          f"tokens round-robin in {dt:.2f} s, each replica's rows bitwise a "
          f"single engine's; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    del sess, single
    free_cuda()
    return counts


def generate_logits(eng, prompts, new: int):
    """``eng.generate(prompts, new)`` and a copy of the logits of each of
    its prefill and decode calls."""
    kept = []
    prefill_fn, decode_fn = eng.prefill_fn, eng.decode_fn

    def prefill(p, tokens, extras=None):
        cache, logits = prefill_fn(p, tokens, extras)
        kept.append(logits.clone())
        return cache, logits

    def decode(p, cache, token, pos):
        cache, logits = decode_fn(p, cache, token, pos)
        kept.append(logits.clone())
        return cache, logits

    eng.prefill_fn, eng.decode_fn = prefill, decode
    out = eng.generate(prompts, new)
    del eng.prefill_fn, eng.decode_fn
    return out, kept


def serve_ep(smi: str) -> dict:
    """Phase 10 (e): phi-3.5-MoE expert-parallel decode, every width, depth
    32 -> 8, 2 ranks sharing one parameter tree: ``permute_rows``
    launches exact, every call's logits and the tokens bitwise with the
    kernel on and off, agreement with the global dispatch of the same
    weights."""
    import dataclasses
    import torch
    from repro_torch.launch import bootstrap
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    e = EP_SERVE
    b, s, new, pe = e["batch"], e["prompt"], e["new"], e["ep_devices"]
    print(f"serving (e): build_serve_session({e}); reduced: depth 32 -> "
          f"{e['n_layers']} layers (the 32-layer model is 84 GB of bf16); "
          f"every width kept")
    torch.cuda.reset_peak_memory_stats()
    sess = bootstrap.build_serve_session(
        arch=e["arch"], max_len=s + new, moe_dispatch="ep", ep_devices=pe,
        n_layers=e["n_layers"], device="cuda")
    cfg = sess.cfg
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    zero_counts()
    on, on_logits = generate_logits(sess.engine, prompts, new)
    torch.cuda.synchronize()
    counts = read_counts()
    t = sess.engine.timings
    peak = torch.cuda.max_memory_allocated()
    # 2 permute_rows launches per rank per MoE layer per call (the
    # dispatch's alltoall out and back), over 1 prefill + ``new`` decode
    # calls (a decode follows every sampled token, the last one included).
    want = {name: 0 for name in counters()}
    want["permute_rows"] = 2 * pe * cfg.n_layers * (1 + new)
    for name, n in want.items():
        check(counts[name] == n, f"serving (e): {name} launched "
              f"{counts[name]} times, expected {n}")
    off = ServeEngine(build(cfg, remat=False, ep_comm=sess.ep_comm,
                            use_fused_kernel=False), sess.params, s + new)
    off_tokens, off_logits = generate_logits(off, prompts, new)
    check(len(on_logits) == len(off_logits) == 1 + new
          and all(same_bits(a, c) for a, c in zip(on_logits, off_logits)),
          "serving (e): ep logits differ with permute_rows on and off")
    check(np.array_equal(on, off_tokens), "serving (e): ep tokens differ "
          "with permute_rows on and off")
    del on_logits, off_logits
    glob = ServeEngine(build(dataclasses.replace(cfg, moe_dispatch="global"),
                             remat=False), sess.params, s + new)
    g = glob.generate(prompts, new)
    agree = [int(np.nonzero(on[r] != g[r])[0][0]) if (on[r] != g[r]).any()
             else new for r in range(b)]
    print(f"serving (e): {cfg.name} {cfg.n_layers} layers, weights "
          f"{tree_bytes(sess.params)} bytes shared by {pe} ranks; "
          f"permute_rows {counts['permute_rows']} = 2 x {pe} x "
          f"{cfg.n_layers} x (1 + {new}); the {1 + new} calls' logits and "
          f"the tokens bitwise with the kernel on and off; vs the global dispatch: {int((on == g).sum())} of "
          f"{on.size} tokens equal, rows agree for their first {agree} "
          f"tokens (capacity factor {cfg.capacity_factor}: drops differ); "
          f"time to first token {t['ttft_s'] * 1e3:.1f} ms, decode step p50 "
          f"{pct(t['step_s'], 50):.3f} ms, p99 {pct(t['step_s'], 99):.3f} "
          f"ms; peak memory allocated {peak / 2**30:.2f} GiB ({smi})")
    del sess, off, glob
    free_cuda()
    return counts


def phase_serving(smi: str) -> dict:
    """Phase 10: (a)-(e); returns the launch counts of the driven runs
    ((a), (c)'s bf16 run, (d), (e)), each zeroed just before its run."""
    t10 = time.perf_counter()
    total = {name: 0 for name in counters()}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    counts, sess = serve_oneshot(smi)
    add(counts)
    add(serve_scheduler_timing(sess, smi))
    del sess
    free_cuda()
    print(f"phase 10 (a), (c) bf16 in {time.perf_counter() - t10:.1f} s")
    model, params = serve_parity(smi)
    del model, params
    free_cuda()
    model, params = f32_qwen3(SCHED_F32_LAYERS)
    serve_scheduler_parity(model, params, smi)
    del model, params
    free_cuda()
    print(f"phase 10 (b), (c) f32 in {time.perf_counter() - t10:.1f} s")
    add(serve_replicas(smi))
    add(serve_ep(smi))
    print(f"phase 10 in {time.perf_counter() - t10:.1f} s ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 11: the other architecture families
# ---------------------------------------------------------------------------

#: phase 11 (a): arch -> sequence length of its full-width, full-depth
#: ZeRO-1 run over 3 virtual ranks (hymba past its 1024-token window;
#: Whisper: its 30-s encoder window of 1500 frames, the decoder at its
#: ``dec_len`` of 448 tokens).  xLSTM at 512, not 2048: its sLSTM
#: recurrence runs one Python step a token; at 2048 the script passed its
#: 1200-s limit on a slow host, and with phase 14 added 1024 left it at
#: 1109.8 s (PERF.md §4).  Two steps each (one warm), for the same reason.
#: The script then took over 1200 s on a slower host (973.9 s on the card
#: of PERF.md §6), so xLSTM trains at 128 tokens and hymba at
#: :data:`FAMILY_LAYERS`.
FAMILY_TRAIN = {"hymba-1.5b": 2048, "xlstm-125m": 128,
                "whisper-small": 1500}
#: phase 11 (a): arch -> its depth where cut (every width kept): hymba's
#: Mamba scan took ~14 s a step at 32 layers over 3 virtual ranks.
FAMILY_LAYERS = {"hymba-1.5b": 8}
FAMILY_STEPS = 2
#: phase 11 (a): the int8-wire run (EF off): its arch and steps.
FAMILY_WIRE = ("hymba-1.5b", 2)
#: phase 11 (c): arch -> (batch, prompt, new tokens, depth cut or None).
#: The VLM and Qwen1.5 keep every width; their depth is cut to fit
#: (89.2 B and 111.2 B parameters in full against 80 GB).  hymba's and
#: xLSTM's depth is cut for the script's time limit (their serving took
#: 29.4 and 24.9 s at full depth, bf16 and float32 together).
FAMILY_SERVE = {"hymba-1.5b": (4, 2048, 64, 8),
                "xlstm-125m": (8, 2048, 128, 3),
                "whisper-small": (8, 320, 128, None),
                "llama-3.2-vision-90b": (2, 2048, 32, 5),
                "qwen1.5-110b": (2, 2048, 32, 2)}
#: phase 11 (c): the float32 parity runs' batch and new tokens (the
#: prompt is the bf16 run's).
FAMILY_PARITY = dict(batch=2, new=16)


def family_argv(arch: str, seq: int, **flags) -> list:
    """Phase 4's argv for ``arch`` at sequence ``seq``."""
    return argv_with(MAIN_ARGV, **{"arch": arch, "seq_len": seq,
                                    "steps": FAMILY_STEPS, **flags})


def family_train(arch: str, seq: int) -> tuple:
    """Phase 11 (a): ``arch``'s full-width ZeRO-1 run through the
    launcher's argv, launch counts and sync bytes and exchanges exact,
    then step 0 again with ``--fused-kernel off``: its loss, grad norm
    and the params after it bitwise the run's."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import bootstrap
    cfg = get_config(arch)
    layers = FAMILY_LAYERS.get(arch, cfg.n_layers)
    n_zero = len(wire_leaves(P_MAIN, arch))
    label = f"phase 11 (a) {arch}"
    argv = family_argv(arch, seq)
    print(f"{label}: {cfg.family}, full width, {layers} of {cfg.n_layers} "
          f"layers, {tree_numel(arch, layers) / 1e9:.4f} B params, {n_zero} "
          f"zero leaves at p = {P_MAIN}; train.main({argv})")
    want = {name: 0 for name in counters()}
    want["fused_round"] = FAMILY_STEPS * P_MAIN * n_zero * 2

    def keep(sess, metrics):
        ranks_agree(sess.params, label)
        return {"loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "params": [t.cpu() for t in T.leaves(sess.params[0])]}

    with cut_depth(layers):
        run, counts, peak, _, ref = run_path(
            argv, label, want, P_MAIN, wire=False,
            sync=sync_bytes(P_MAIN, False, arch), exchanges=4 * n_zero,
            at_step0=keep)
    sess = bootstrap.build_session(
        arch=arch, steps=FAMILY_STEPS, seq_len=seq, global_batch=P_MAIN,
        dp=P_MAIN, mode="zero1", use_fused_kernel=False, device="cuda",
        n_layers=layers)
    metrics = bootstrap.run_step(sess, 0)
    check(float(metrics["loss"]) == ref["loss"] == run.losses[0],
          f"{label}: step-0 loss with the kernel off {float(metrics['loss'])}"
          f" != on {ref['loss']}")
    check(float(metrics["grad_norm"]) == ref["grad_norm"],
          f"{label}: step-0 grad norm off {float(metrics['grad_norm'])} != "
          f"on {ref['grad_norm']}")
    for (path, got), want_t in zip(T.flatten(sess.params[0]), ref["params"]):
        check(same_bits(want_t, got.cpu()),
              f"{label}: params after step 1 differ with the kernel off: "
              f"{path}")
    print(f"{label}: fused_round launches {counts['fused_round']} (= "
          f"{FAMILY_STEPS} steps x {P_MAIN} ranks x {n_zero} leaves x 2 "
          f"rounds); --fused-kernel off: step-0 loss, grad norm and the "
          f"params after step 1 bitwise")
    del sess, ref
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    return run, counts, peak


def family_wire() -> tuple:
    """Phase 11 (a): the int8 wire (EF off) on ``FAMILY_WIRE``'s arch:
    ``quantize`` and ``fused_round_dq`` launches, wire bytes and
    exchanges exact, no ``fused_round``."""
    from repro_torch.configs import get_config
    arch, steps = FAMILY_WIRE
    n_zero = len(wire_leaves(P_MAIN, arch))
    argv = family_argv(arch, FAMILY_TRAIN[arch], wire_dtype="int8",
                       no_error_feedback=True, steps=steps)
    label = f"phase 11 (a) {arch} int8 wire"
    layers = FAMILY_LAYERS.get(arch, get_config(arch).n_layers)
    print(f"{label}: {layers} layers; train.main({argv})")
    want = {name: 0 for name in counters()}
    want["quantize"] = want["quantize_rows"] = steps * P_MAIN * n_zero
    want["fused_round_dq"] = steps * P_MAIN * n_zero * 2
    with cut_depth(layers):
        run, counts, peak, _, _ = run_path(
            argv, label, want, P_MAIN, wire=True,
            sync=sync_bytes(P_MAIN, True, arch), exchanges=4 * n_zero)
    return run, counts, peak


def tree_numel(arch: str, n_layers: int | None = None) -> int:
    """Parameters of ``arch`` at full width (``n_layers``: depth cut)."""
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import param_shapes
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return sum(math.prod(s) for _, s in T.flatten(param_shapes(cfg)))


def family_serve(arch: str, smi: str) -> None:
    """Phase 11 (c), bf16: one-shot greedy serving of ``arch``, through
    ``python -m repro_torch.launch.serve``'s argv where the whole depth
    fits, else through the session builder with the depth cut and the
    launcher's inputs; two calls (the second is steady state)."""
    import torch
    from repro_torch.launch import bootstrap, serve
    b, s, new, n_layers = FAMILY_SERVE[arch]
    label = f"phase 11 (c) {arch}"
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    if n_layers is None:
        argv = ["--arch", arch, "--batch", str(b), "--prompt-len", str(s),
                "--max-new", str(new), "--device", "cuda"]
        print(f"{label}: serve.main({argv})")
        run = serve.main(argv)
        sess, out, first, steady = (run.session, run.tokens, run.seconds,
                                    run.steady_seconds)
    else:
        print(f"{label}: build_serve_session(n_layers={n_layers}) and the "
              f"launcher's inputs, batch {b}, prompt {s}, {new} new")
        sess = bootstrap.build_serve_session(arch=arch, max_len=s + new,
                                             n_layers=n_layers, device="cuda")
        prompts, extras = serve.prompts_and_extras(sess.cfg, b, s)
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = sess.engine.generate(prompts, new, extras=extras)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        first, steady = secs
    counts = read_counts()
    check(not any(counts.values()), f"{label}: launched kernels: {counts}")
    peak = torch.cuda.max_memory_allocated()
    cfg = sess.cfg
    check(out.shape == (b, new) and out.min() >= 0
          and out.max() < cfg.vocab_size,
          f"{label}: tokens {out.shape} in [{out.min()}, {out.max()}]")
    t = sess.engine.timings
    print(f"{label}: {cfg.n_layers} layers, {cfg.dtype}, weights "
          f"{tree_bytes(sess.params)} bytes, cache or state "
          f"{t['cache_bytes']} bytes; time to first token (prefill of {b} x "
          f"{s}) {t['ttft_s'] * 1e3:.1f} ms; decode step p50 "
          f"{pct(t['step_s'], 50):.3f} ms, p99 {pct(t['step_s'], 99):.3f} ms "
          f"over {len(t['step_s'])}; first call {first:.2f} s, steady state "
          f"{b * new / steady:.1f} tok/s ({steady:.2f} s); peak memory "
          f"allocated {peak / 2**30:.2f} GiB; no kernel launched ({smi})")
    del sess
    free_cuda()


def family_parity(arch: str, smi: str) -> None:
    """Phase 11 (c), float32: prefill and every decode step's logits
    against ``forward_logits`` over the teacher-forced sequence (within
    ``SERVE_LOGIT_TOL``), greedy tokens equal to its argmax except where
    its top-2 margin is below the logits gap there, and ``generate`` the
    loop's tokens.  The VLM's cross-layer gates are set to 0.5 (zero at
    init, where the image path would not reach the logits)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompts_and_extras
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    _, s, _, n_layers = FAMILY_SERVE[arch]
    b, new = FAMILY_PARITY["batch"], FAMILY_PARITY["new"]
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build(cfg, remat=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.device("cuda"))
    if cfg.family == "vlm":  # zero-initialized gates hide the image path
        for gate in ("gate_attn", "gate_ffn"):
            params["cross_layers"][gate].fill_(0.5)
    prompts, extras = prompts_and_extras(cfg, b, s)
    ex = {k: torch.as_tensor(v, device="cuda") for k, v in extras.items()}
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.no_grad():
        cache, logits = model.prefill(params, toks, s + new, **ex)
        steps, out = [logits], []
        for i in range(new):
            nxt = torch.argmax(steps[-1], dim=-1).to(torch.int32)
            out.append(nxt)
            if i < new - 1:
                cache, logits = model.decode_step(params, cache, nxt, s + i)
                steps.append(logits)
        del cache
        seq = torch.cat([toks, torch.stack(out, 1)], 1)
        full = model.forward_logits(params, seq, **ex)
        gap, margin, flips = 0.0, float("inf"), 0
        for i, lg in enumerate(steps):
            ref = full[:, s - 1 + i]
            diff = (lg - ref).abs().amax(-1)
            gap = max(gap, float(diff.max()))
            top2 = torch.topk(ref, 2, dim=-1).values
            m = top2[:, 0] - top2[:, 1]
            margin = min(margin, float(m.min()))
            flip = torch.argmax(ref, -1).to(torch.int32) != out[i]
            flips += int(flip.sum())
            check(not bool((flip & (m >= diff)).any()),
                  f"phase 11 (c) {arch} f32: step {i}: a greedy token "
                  f"differs where the top-2 margin exceeds the logits gap")
        scale = float(full.abs().max())
        del full
    eng = ServeEngine(model, params, s + new)
    gen = eng.generate(prompts, new, extras=extras)
    loop = torch.stack(out, 1).cpu().numpy()
    print(f"phase 11 (c) {arch} f32: {cfg.n_layers} layers, {b} x {s} "
          f"prompt, {new} tokens: max |decode - teacher-forced forward| "
          f"logits {gap:.3e} (limit {SERVE_LOGIT_TOL:g}; max |logit| "
          f"{scale:.3f}); smallest top-2 margin {margin:.3e}; greedy tokens "
          f"differing {flips}; generate == the loop: "
          f"{np.array_equal(gen, loop)} ({smi})")
    check(gap <= SERVE_LOGIT_TOL, f"phase 11 (c) {arch} f32: logits gap "
          f"{gap}")
    check(np.array_equal(gen, loop), f"phase 11 (c) {arch} f32: generate "
          f"differs from the prefill + decode loop")
    del model, params, eng
    free_cuda()


def phase_families(smi: str) -> dict:
    """Phase 11: (a) ZeRO-1 training of the hybrid, xLSTM and
    encoder-decoder families at full width and depth, and the hybrid on
    the int8 wire; (c) serving of every new family path, bf16 timed and
    float32 held against ``forward_logits``.  Returns the launch counts of
    (a)'s runs, each zeroed just before its run."""
    import torch
    t11 = time.perf_counter()
    total = {name: 0 for name in counters()}
    for arch, seq in FAMILY_TRAIN.items():
        t0 = time.perf_counter()
        run, counts, peak = family_train(arch, seq)
        measured_train(f"11a-{arch.split('-')[0]}", arch, seq, P_MAIN, run,
                       peak, {}, FAMILY_LAYERS.get(arch))
        for k in total:
            total[k] += counts[k]
        print(f"phase 11 (a) {arch}: seq {seq}, step seconds "
              f"{[round(x, 3) for x in run.step_seconds]}, peak "
              f"{peak / 2**30:.2f} GiB, {time.perf_counter() - t0:.1f} s "
              f"({smi})")
    t0 = time.perf_counter()
    run, counts, peak = family_wire()
    measured_train("11a-hymba-int8", FAMILY_WIRE[0],
                   FAMILY_TRAIN[FAMILY_WIRE[0]], P_MAIN, run, peak,
                   dict(wire_dtype="int8", error_feedback=False),
                   FAMILY_LAYERS.get(FAMILY_WIRE[0]))
    for k in total:
        total[k] += counts[k]
    print(f"phase 11 (a) {FAMILY_WIRE[0]} int8 wire: step seconds "
          f"{[round(x, 3) for x in run.step_seconds]}, peak "
          f"{peak / 2**30:.2f} GiB, {time.perf_counter() - t0:.1f} s ({smi})")
    print(f"phase 11 (a) in {time.perf_counter() - t11:.1f} s")
    for arch in FAMILY_SERVE:
        t0 = time.perf_counter()
        family_serve(arch, smi)
        family_parity(arch, smi)
        torch.cuda.reset_peak_memory_stats()
        print(f"phase 11 (c) {arch} in {time.perf_counter() - t0:.1f} s")
    print(f"phase 11 in {time.perf_counter() - t11:.1f} s ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 13: the roofline of the card's own runs
# ---------------------------------------------------------------------------

#: where phase 13 writes its records (``python -m repro_torch.roofline.report
#: --dir build/roofline --mesh h100`` renders them again)
ROOFLINE_DIR = ROOT / "build" / "roofline"


def measured_train(label: str, arch: str, seq: int, p: int, run, peak: int,
                   sync: dict, layers: int | None = None) -> None:
    """Record a ZeRO-1 run of ``p`` virtual ranks on one card (global
    batch ``p``) for phase 13: its fastest warm step (step 0 builds the
    plans and warms the allocator), the sync bytes and exchanges the
    launcher counted each step, and ``sync``, the ``GradSyncConfig``
    keywords of its argv; ``layers``: the depth where cut."""
    MEASURED[label] = dict(
        arch=arch, layers=layers, kind="train", seq=seq, batch=p, ranks=p,
        local=True,
        mode="zero1" + (" int8" if sync.get("wire_dtype") else ""),
        sync=sync, measured_s=min(run.step_seconds[1:]),
        sync_bytes=run.sync_bytes, exchanges=run.sync_exchanges, peak=peak)


def tp_roofline_counts(label: str, m: dict):
    """A tensor-parallel path's ``CellSpec`` (``tp`` = M) and its two axes'
    counts from ``roofline.tp_counts`` (the data axis's sync on the
    plans, the hooks' calls from the model run on ``meta`` tensors),
    checked equal to what the communicators counted every step:
    ``comm.bytes``, ``comm.exchanges`` and ``comm.natives`` of both
    axes.  Returns the cell and the axes' counts combined."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.bootstrap import FSDP_ARCHS
    from repro_torch.models import ShardingRecipe
    from repro_torch.models import sharding as shd
    from repro_torch.optim.zero1 import GradSyncConfig
    from repro_torch.roofline import CellSpec, combined, tp_counts
    d, mm = m["tp"]
    cfg = get_config(m["arch"])
    if m["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=m["layers"])
    recipe = ShardingRecipe(tp_size=mm, mode=(
        "tp_fsdp" if m["mode"] == "fsdp_auto" and cfg.name in FSDP_ARCHS
        else "tp"))
    t0 = time.perf_counter()
    # phase 16 counted its paths already (the same call, in a worker)
    pc = m.get("counts") or tp_counts(
        cfg, shd.tp_layout(cfg, recipe, (d, mm)), mode=m["mode"],
        batch=m["batch"], seq=m["seq"], sync=GradSyncConfig(**m["sync"]),
        ranks=m["ranks"] if m["local"] else 1)
    want = {a: [c.bytes, c.exchanges, c.natives] for a, c in pc.items()}
    for i, got in enumerate(m["steps"]):
        check(got == want, f"phase 13 ({label}): step {i} counted {got}, "
              f"the plans and the model's calls {want}")
    print(f"phase 13 ({label}): a step, data axis {want['data']} and model "
          f"axis {want['model']} (bytes, exchanges, native calls) counted "
          f"= predicted on every step; the native calls' volume "
          f"{pc['data'].native_bytes:.0f} + {pc['model'].native_bytes:.0f} "
          f"bytes; counted in {time.perf_counter() - t0:.1f} s")
    cell = CellSpec(kind=m["kind"], seq=m["seq"], batch=m["batch"],
                    n_chips=m["ranks"], tp=mm, dp_world=d)
    return cell, combined(pc["data"], pc["model"])


def phase_roofline(smi: str, mesh: str = "h100") -> None:
    """Phase 13: every measured path of :data:`MEASURED` against its
    roofline bound (``repro_torch.roofline``; nothing runs on the card).
    Each path's ``CellSpec`` at full width (``p`` ranks: on one card
    virtual ranks, whose compute and memory the card does p times and
    whose exchanges are HBM copies; over NCCL one rank a card, the sync
    on NVLink), its three terms, the bound (the largest), measured ÷
    bound and ``mfu``; the sync's bytes and exchanges counted from the
    plans beside those the launcher counted, which must be equal; no
    measured time may be below its bound.  One JSON record a path in
    ``build/roofline`` (``<arch>_phase<label>_<mesh>.json``), then the
    rendered table."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.optim.zero1 import GradSyncConfig
    from repro_torch.roofline import CellSpec, analyze, report, sync_counts
    t13 = time.perf_counter()
    ROOFLINE_DIR.mkdir(parents=True, exist_ok=True)
    rows = []
    for label, m in MEASURED.items():
        cfg = get_config(m["arch"])
        if m.get("layers"):
            cfg = dataclasses.replace(cfg, n_layers=m["layers"])
        p = m["ranks"]
        cell = CellSpec(kind=m["kind"], seq=m["seq"], batch=m["batch"],
                        n_chips=p, tp=1, dp_world=p)
        sync = None
        if "tp" in m:
            cell, sync = tp_roofline_counts(label, m)
        elif "sync" in m:
            sync = sync_counts(cfg, GradSyncConfig(**m["sync"]), p,
                               ranks=p if m["local"] else 1)
            check(all(b == sync.bytes for b in m["sync_bytes"]) and
                  all(x == sync.exchanges for x in m["exchanges"]),
                  f"phase 13 ({label}): the plans count {sync.bytes} bytes "
                  f"and {sync.exchanges} exchanges a step, the launcher "
                  f"{m['sync_bytes']} and {m['exchanges']}")
        rl = analyze(cfg, cell, sync=sync, local=m["local"],
                     measured_s=m["measured_s"])
        where = (f"{p} cards, one rank each" if not m["local"] else
                 "one card" if p == 1 else f"one card, {p} virtual ranks")
        print(f"phase 13 ({label}): {cell} ({where})")
        print(f"phase 13 ({label}): t_compute {rl.t_compute * 1e3:.3f} ms, "
              f"t_memory {rl.t_memory * 1e3:.3f} ms, t_collective "
              f"{rl.t_collective * 1e3:.3f} ms; bound {rl.t_bound * 1e3:.3f}"
              f" ms ({rl.bottleneck}); measured {m['measured_s'] * 1e3:.3f}"
              f" ms = {m['measured_s'] / rl.t_bound:.2f}x the bound; mfu "
              f"{rl.mfu:.5f} ({smi})")
        if sync is not None and "tp" not in m:
            print(f"phase 13 ({label}): sync a step, plans {sync.bytes} bytes"
                  f" / {sync.exchanges} exchanges, counted "
                  f"{m['sync_bytes'][0]} / {m['exchanges'][0]}; bytes by "
                  f"dtype {sync.stats.raw_bytes_by_dtype}")
        check(m["measured_s"] >= rl.t_bound,
              f"phase 13 ({label}): measured {m['measured_s']} s is below "
              f"its bound {rl.t_bound} s: a term counts more work than the "
              f"path does")
        rec = {"arch": m["arch"], "shape": f"phase{label}",
               "mode": m["mode"], "mesh": mesh, "status": "OK",
               "cell": dataclasses.asdict(cell), "card": smi,
               "roofline": rl.as_dict(),
               "memory": {"argument_bytes": m["peak"], "temp_bytes": 0}}
        with open(ROOFLINE_DIR / f"{m['arch']}_phase{label}_{mesh}.json",
                  "w") as f:
            json.dump(rec, f, indent=1)
        rows.append(rec)
    print(report.render(rows))
    print(f"phase 13 in {time.perf_counter() - t13:.2f} s")


# ---------------------------------------------------------------------------
# Phase 14: tensor parallelism (the model axis of --mesh DxM) and fsdp_auto
# ---------------------------------------------------------------------------

#: (a): phase 4's argv on a 2x2 mesh: the circulant RS / AG over the data
#: axis (each model column its own group), TP over the model axis
P14A_ARGV = argv_with(MAIN_ARGV, mesh="2x2", global_batch=2, steps=3)
#: (a)'s depth on one card (every width kept): at 28 layers (a) and its
#: count on ``meta`` tensors for phase 13 took ~60 s of the script's time
P14A_LAYERS = 7
#: the depth of the float32 holds of (a) and (b), and of (c)'s hold
P14_HOLD_LAYERS = 3
#: (b): fsdp_auto on 2x2 (qwen3-1.7b: recipe mode ``tp``)
P14B_ARGV = argv_with(MAIN_ARGV, mesh="2x2", mode="fsdp_auto",
                      global_batch=2)
#: (b) and (d): qwen1.5-110b at full width, fsdp_auto ``tp_fsdp`` on 2x2
P14_BIG_ARGV = argv_with(P14B_ARGV, arch="qwen1.5-110b", steps=3)
P14B_BIG_LAYERS = 1
P14D_BIG_LAYERS = 12
#: (d)'s ranks' allocator setting (``PYTORCH_CUDA_ALLOC_CONF``): run 3 of
#: the phase ran out of memory at 12 layers with 9.49 GiB reserved but
#: unallocated
P14D_ALLOC_CONF = "expandable_segments:True"
#: the float32 holds: loss relative, params rtol / atol.  ``atol`` is a
#: third of the last step's learning rate (3e-5): an element whose
#: gradient sits near AdamW's eps (1e-8) takes its update's size from the
#: float32 noise of the sums the two layouts order differently (run 1 of
#: the phase: one ``wv`` element 1.01x an atol of 1e-6 past rtol 1e-4).
P14_HOLD = dict(loss=1e-5, rtol=1e-4, atol=1e-5)


class f32_configs:
    """Within the block, every session the launchers build in this process
    has its config in float32 (the launchers have no dtype flag)."""

    def __enter__(self):
        import dataclasses
        from repro_torch.launch import bootstrap
        self.resolve = resolve = bootstrap.resolve_cfg

        def f32(*args, **kw):
            return dataclasses.replace(resolve(*args, **kw), dtype="float32")

        bootstrap.resolve_cfg = f32

    def __exit__(self, *exc):
        from repro_torch.launch import bootstrap
        bootstrap.resolve_cfg = self.resolve


def tp_steps(sess) -> dict:
    """The counters of a tensor-parallel session's two axes:
    ``(bytes, exchanges, natives)`` of the data axis and of the model
    axis."""
    return {axis: (c.bytes, c.exchanges, c.natives) for axis, c in
            (("data", sess.comm), ("model", sess.tp.axis.comm))}


def tp_zero_leaves(argv, n_layers: int | None = None) -> int:
    """Zero leaves of one rank's blocks in ``argv``'s tensor-parallel
    zero1 session (the sync's per-leaf reduce-scatters a rank), its depth
    cut to ``n_layers``."""
    from repro_torch.launch import bootstrap
    from repro_torch.launch import train as trainer
    from repro_torch.models import ShardingRecipe
    from repro_torch.models import sharding as shd
    from repro_torch.optim.zero1 import GradSyncConfig, zero_flags
    args = trainer._parser().parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    cfg = bootstrap.resolve_cfg(args.arch, scale_down=args.scale_down,
                                n_layers=n_layers)
    lay = shd.tp_layout(cfg, ShardingRecipe(tp_size=m), (d, m))
    return sum(zero_flags(lay.local_shapes(), d, GradSyncConfig()))


def tp_main(argv, label: str, *, keep_whole: bool = False,
            profile: bool = False, dev=None) -> dict:
    """``launch.train.main(argv)`` of a tensor-parallel session, every
    launch count set to 0 just before: per step the loss, grad norm and
    both axes' counters a step, after step 0 the digest of every local
    rank's blocks; at the last step the launches and the peak, then
    (``profile``) one unprofiled and one profiled warm step of the same
    session, and (``keep_whole``, in process) the whole parameters."""
    import torch
    from repro_torch.launch import bootstrap
    from repro_torch.launch import train as trainer
    last_step = trainer._parser().parse_args(argv).steps - 1
    rec = {"gnorm": [], "steps": []}
    last = [None]

    def on_step(step, sess, metrics):
        if dev is not None:
            on_card(sess.params[0], dev, label)
        now = tp_steps(sess)
        prev = last[0] or {a: (0, 0, 0) for a in now}
        rec["steps"].append({a: [x - y for x, y in zip(now[a], prev[a])]
                             for a in now})
        last[0] = now
        rec["gnorm"].append(float(metrics["grad_norm"]))
        if step == 0:
            rec["digest"] = digest(sess.params)
        if step != last_step:
            return
        rec["counts"] = read_counts()
        rec["peak"] = torch.cuda.max_memory_allocated()
        if keep_whole:
            rec["whole"] = bootstrap.whole_params(sess, sess.params)
        if profile:
            warm = timed_step(lambda: bootstrap.run_step(sess, step + 1))
            rec["warm_ms"] = warm
            profiled_step(lambda: bootstrap.run_step(sess, step + 2),
                          f"{label}, a warm step", warm,
                          ranks=len(sess.comm.ranks))

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = trainer.main(argv, on_step=on_step)
    rec.update(losses=run.losses, step_seconds=run.step_seconds,
               sync_bytes=run.sync_bytes, exchanges=run.sync_exchanges)
    check(all(math.isfinite(x) for x in run.losses),
          f"{label}: non-finite loss {run.losses}")
    free_cuda()
    return rec


def held(got: dict, want: dict, label: str, rtol: float, atol: float
         ) -> float:
    """Every leaf of ``got`` within ``rtol`` / ``atol`` of ``want``'s;
    returns the largest ``|got - want| / (atol + rtol |want|)`` and
    prints how many elements are past ``rtol`` alone."""
    from repro_torch import tree as T
    worst, past, total = 0.0, 0, 0
    for path, a in T.flatten(got):
        b = T.get(want, path).to(a.device, a.dtype)
        diff = (a - b).abs()
        r = float((diff / (atol + rtol * b.abs())).max())
        past += int((diff > rtol * b.abs()).sum())
        total += b.numel()
        check(r <= 1.0, f"{label}: {'.'.join(map(str, path))} beyond rtol "
              f"{rtol} / "
              f"atol {atol} ({r:.3f} of the bound)")
        worst = max(worst, r)
    print(f"{label}: {past} of {total} elements past rtol {rtol} alone, "
          f"the largest {worst:.3f} of rtol {rtol} / atol {atol}")
    return worst


def loss_held(got: list, want: list, label: str, rel: float) -> None:
    bad = [(a, b) for a, b in zip(got, want) if abs(a - b) > rel * abs(b)]
    check(not bad, f"{label}: losses {got} vs {want} beyond {rel} relative")


def print_tp_run(label: str, rec: dict, smi: str) -> None:
    print(f"{label}: losses {rec['losses']}, grad norms {rec['gnorm']}")
    print(f"{label}: step seconds {[round(t, 4) for t in rec['step_seconds']]}"
          f" (host clock to device sync); peak "
          f"{rec['peak'] / 2**30:.2f} GiB; launches {rec['counts']}")
    s = rec["steps"][0]
    print(f"{label}: a step: data axis {s['data'][0]} bytes, {s['data'][1]} "
          f"exchanges, {s['data'][2]} native calls; model axis "
          f"{s['model'][2]} native calls ({smi})")


def measured_tp(label: str, arch: str, argv, rec: dict, *, local: bool,
                layers: int | None = None, world_s=None, counts=None
                ) -> None:
    """Record a tensor-parallel run for phase 13: both axes' counts a step
    and its fastest warm step (``world_s``: the world's step, its slowest
    rank's); ``counts``: its ``roofline.tp_counts`` if already made."""
    from repro_torch.launch import train as trainer
    args = trainer._parser().parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    secs = world_s or rec["step_seconds"]
    MEASURED[label] = dict(
        arch=arch, kind="train", seq=args.seq_len, batch=args.global_batch,
        ranks=d * m, local=local, mode=args.mode or "zero1",
        sync={"wire_dtype": args.wire_dtype} if args.wire_dtype else {},
        tp=(d, m), layers=layers, measured_s=min(secs[1:]),
        steps=rec["steps"], peak=rec["peak"], counts=counts)


def phase_tensor_parallel(smi: str) -> dict:
    """Phase 14 (a) and (b) on one card."""
    from repro_torch.configs import get_config
    from repro_torch.core import ceil_log2
    t14 = time.perf_counter()
    # (a) the main path tensor parallel, full width
    n_zero = tp_zero_leaves(P14A_ARGV, P14A_LAYERS)
    print(f"phase 14 (a): {' '.join(P14A_ARGV)}: qwen3-1.7b full width, "
          f"{P14A_LAYERS} of 28 layers, bf16, 4 virtual ranks on one card (2 "
          f"data x 2 model: each model column's blocks synced over its data "
          f"group, {n_zero} zero leaves a rank); reduced: depth 28 -> "
          f"{P14A_LAYERS}")
    with cut_depth(P14A_LAYERS):
        a = tp_main(P14A_ARGV, "phase 14 (a)", profile=True)
    want = {name: 0 for name in counters()}
    steps = len(a["losses"])
    want["fused_round"] = steps * 4 * n_zero * ceil_log2(2)
    check(a["counts"] == want, f"phase 14 (a): launches {a['counts']}, "
          f"expected {want} (= {steps} steps x 4 ranks x {n_zero} zero "
          f"leaves x 1 round)")
    print_tp_run("phase 14 (a)", a, smi)
    print(f"phase 14 (a): fused_round launches {a['counts']['fused_round']} "
          f"= {steps} steps x 4 ranks x {n_zero} zero leaves of the blocks "
          f"x 1 round; warm step {a['warm_ms']:.1f} ms")
    with cut_depth(P14A_LAYERS):
        off = tp_main(argv_with(P14A_ARGV, steps=1, fused_kernel="off"),
                      "phase 14 (a), kernels off")
    check(not any(off["counts"].values()), f"phase 14 (a) off: "
          f"{off['counts']}")
    check(off["losses"][0] == a["losses"][0] and off["gnorm"][0] ==
          a["gnorm"][0] and off["digest"] == a["digest"],
          "phase 14 (a): kernels on and off differ in step 0's loss or grad "
          "norm or the params after it")
    print("phase 14 (a): --fused-kernel off gives a bitwise-equal step-0 "
          "loss and grad norm and bitwise-equal params (every rank's "
          "blocks) after step 0")
    measured_tp("14a", "qwen3-1.7b", P14A_ARGV, a, local=True,
                layers=P14A_LAYERS)
    # (a)'s hold: 2x2 against 2x1 in float32 at 3 layers
    with cut_depth(P14_HOLD_LAYERS), f32_configs():
        tp = tp_main(argv_with(P14A_ARGV, steps=2), "phase 14 (a) hold 2x2",
                     keep_whole=True)
        dp = hold_run(argv_with(P14A_ARGV, steps=2, mesh="2x1"))
    loss_held(tp["losses"], dp["losses"], "phase 14 (a) hold",
              P14_HOLD["loss"])
    worst = held(tp["whole"], dp["whole"], "phase 14 (a) hold",
                 P14_HOLD["rtol"], P14_HOLD["atol"])
    print(f"phase 14 (a): float32 at {P14_HOLD_LAYERS} layers, 2x2 vs 2x1 "
          f"(phase 4's path at D = 2), 2 steps: losses {tp['losses']} vs "
          f"{dp['losses']} (within {P14_HOLD['loss']} relative), params "
          f"within rtol {P14_HOLD['rtol']} / atol {P14_HOLD['atol']} (the "
          f"largest {worst:.3f} of the bound)")
    del tp, dp
    free_cuda()
    # (b) fsdp_auto: 2x2 against single in float32 at 3 layers
    with cut_depth(P14_HOLD_LAYERS), f32_configs():
        fs = tp_main(argv_with(P14B_ARGV, steps=2), "phase 14 (b) fsdp_auto",
                     keep_whole=True)
        single = hold_run(argv_with(P14B_ARGV, steps=2, mesh="1x1",
                                    mode="single"))
    check(not any(fs["counts"].values()), f"phase 14 (b): fsdp_auto "
          f"launched {fs['counts']} (it runs the native calls only)")
    loss_held(fs["losses"], single["losses"], "phase 14 (b)",
              P14_HOLD["loss"])
    worst = held(fs["whole"], single["whole"], "phase 14 (b)",
                 P14_HOLD["rtol"], P14_HOLD["atol"])
    print(f"phase 14 (b): --mode fsdp_auto on 2x2 (recipe tp), float32 at "
          f"{P14_HOLD_LAYERS} layers vs mode single at global batch 2: "
          f"losses {fs['losses']} vs {single['losses']}, params the largest "
          f"{worst:.3f} of the bound")
    del fs, single
    free_cuda()
    big = get_config("qwen1.5-110b")
    layer = (big.param_count() - 2 * big.vocab_size * big.d_model) \
        / big.n_layers
    embed = 2 * big.vocab_size * big.d_model
    n = embed + P14B_BIG_LAYERS * layer
    print(f"phase 14 (b): qwen1.5-110b full width, fsdp_auto tp_fsdp on "
          f"2x2, {P14B_BIG_LAYERS} of {big.n_layers} layers: 12 B a "
          f"parameter (bf16 leaf and gradient, float32 m and v) x "
          f"({embed / 1e9:.2f} B embed + lm_head + {P14B_BIG_LAYERS} x "
          f"{layer / 1e9:.2f} B) = {12 * n / 1e9:.1f} GB on the card, "
          f"activations apart; reduced: depth {big.n_layers} -> "
          f"{P14B_BIG_LAYERS}")
    with cut_depth(P14B_BIG_LAYERS):
        b = tp_main(P14_BIG_ARGV, "phase 14 (b) qwen1.5-110b")
    check(not any(b["counts"].values()), f"phase 14 (b): {b['counts']}")
    print_tp_run("phase 14 (b) qwen1.5-110b", b, smi)
    print(f"phase 14 in {time.perf_counter() - t14:.1f} s ({smi})")
    return {"14a": {k: a["counts"][k] + off["counts"][k] for k in a["counts"]},
            "14b": b["counts"]}


def hold_run(argv) -> dict:
    """``launch.train.main(argv)`` of a session without a model axis: its
    losses and rank 0's parameters after the last step."""
    from repro_torch import tree as T
    from repro_torch.launch import train as trainer
    keep = {}

    def on_step(step, sess, metrics):
        p = sess.params[0] if isinstance(sess.params, list) else sess.params
        keep["whole"] = T.map_leaves(lambda x: x.detach().clone(), p)

    run = trainer.main(argv, on_step=on_step)
    keep["losses"] = run.losses
    return keep


# ---------------------------------------------------------------------------
# Phase 15: tensor parallelism and fsdp_auto of the MoE and VLM families
# ---------------------------------------------------------------------------

#: (a): phi-3.5-MoE, global dispatch, on 2x2 (ZeRO-1 over data, each model
#: rank its 8 of the 16 experts), full width at ``P15A_LAYERS`` layers
P15A_ARGV = argv_with(MAIN_ARGV, arch=EP_ARCH, mesh="2x2", global_batch=2,
                      steps=3)
P15A_LAYERS = 2
#: (b): the same at --moe-dispatch rowwise, 2 steps
P15B_ARGV = argv_with(P15A_ARGV, moe_dispatch="rowwise", steps=2)
#: (a)'s and (b)'s float32 holds, 1x2 against mode single at 1 layer:
#: the 2x1 path's two whole float32 replicas with their moments do not fit
#: 80 GB (at 1 layer the stacked leaves' one row pads to D = 2, so ZeRO-1
#: halves nothing: it ran out of memory on an 80 GB H100)
P15_HOLD_LAYERS = 1
P15_HOLD_MESH = dict(mesh="1x2", global_batch=1, steps=2)
#: (d), (e): the depth of each arch on four cards, the most layers (the
#: VLM's in groups of 5) whose measured peak leaves 10 GiB of the card
#: free: grok-1 peaks at 54.80 GiB a card at 3 layers and 71.55 at 4; the
#: VLM at 56.10 at 15 and 68.05 at 20 (NVIDIA H100 80GB HBM3, 700 W).
#: (c) and their holds run each at its scale-down config (float32), 2x2,
#: 2 steps
P15_BIG = {"grok-1-314b": 3, "llama-3.2-vision-90b": 20}


def p15_small_argv(arch: str) -> list:
    return argv_with(MAIN_ARGV, arch=arch, scale_down=True, mesh="2x2",
                     mode="fsdp_auto", global_batch=4, seq_len=64, steps=2)


def p15_big_argv(arch: str) -> list:
    """(d), (e): fsdp_auto ``tp_fsdp`` on 2x2 at full width, bf16."""
    return argv_with(MAIN_ARGV, arch=arch, mesh="2x2", mode="fsdp_auto",
                     global_batch=2, steps=3)


def p15_reckoning(arch: str, layers: int, cards: int) -> str:
    """The 12-bytes-a-parameter reckoning of ``arch`` at ``layers``
    layers over ``cards`` cards (``ModelConfig.param_count``'s
    embedding, head and per-layer terms)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    emb = 2 * cfg.vocab_size * cfg.d_model
    layer = (cfg.param_count() - emb) / cfg.n_layers
    n = dataclasses.replace(cfg, n_layers=layers).param_count()
    return (f"12 B a parameter (bf16 leaf and gradient, float32 m and v) x "
            f"({emb / 1e9:.2f} B embed + lm_head + {layers} x "
            f"{layer / 1e9:.3f} B) / {cards} card(s) = "
            f"{12 * n / cards / 1e9:.1f} GB a card, activations and a "
            f"layer's gathered weights apart; reduced: depth "
            f"{cfg.n_layers} -> {layers}")


def p15_tp_run(label: str, argv, layers: int, smi: str) -> dict:
    """(a) or (b): ``argv`` at ``layers`` layers with a profiled warm step,
    then step 0 with ``--fused-kernel off``; the launch counts exact, on
    and off bitwise."""
    from repro_torch.core import ceil_log2
    n_zero = tp_zero_leaves(argv, layers)
    print(f"phase 15 ({label}): {' '.join(argv)}: phi-3.5-MoE full width, "
          f"bf16, 4 virtual ranks on one card (each model rank its 8 of 16 "
          f"experts' slots, {n_zero} zero leaves a rank); reduced: depth 32 "
          f"-> {layers}", flush=True)
    with cut_depth(layers):
        run = tp_main(argv, f"phase 15 ({label})", profile=True)
        off = tp_main(argv_with(argv, steps=1, fused_kernel="off"),
                      f"phase 15 ({label}), kernels off")
    want = {name: 0 for name in counters()}
    steps = len(run["losses"])
    want["fused_round"] = steps * 4 * n_zero * ceil_log2(2)
    check(run["counts"] == want, f"phase 15 ({label}): launches "
          f"{run['counts']}, expected {want} (= {steps} steps x 4 ranks x "
          f"{n_zero} zero leaves x 1 round)")
    print_tp_run(f"phase 15 ({label})", run, smi)
    print(f"phase 15 ({label}): fused_round launches "
          f"{run['counts']['fused_round']} = {steps} steps x 4 ranks x "
          f"{n_zero} zero leaves of the blocks x 1 round; warm step "
          f"{run['warm_ms']:.1f} ms")
    check(not any(off["counts"].values()), f"phase 15 ({label}) off: "
          f"{off['counts']}")
    check(off["losses"][0] == run["losses"][0] and off["gnorm"][0] ==
          run["gnorm"][0] and off["digest"] == run["digest"],
          f"phase 15 ({label}): kernels on and off differ in step 0's loss "
          f"or grad norm or the params after it")
    print(f"phase 15 ({label}): --fused-kernel off gives a bitwise-equal "
          f"step-0 loss and grad norm and bitwise-equal params (every "
          f"rank's blocks) after step 0")
    run["counts"] = {k: run["counts"][k] + off["counts"][k]
                     for k in run["counts"]}
    return run


def p15_hold(label: str, argv, against: dict, what: str,
             fsdp: bool = False, phase: int = 15) -> None:
    """``argv`` (a model axis, float32) held against the same argv with
    ``against``'s flags, 2 steps: losses within ``P14_HOLD["loss"]``
    relative, the whole params within its rtol / atol; ``fsdp``: no
    kernel launched."""
    tag = f"phase {phase} ({label})"
    tp = tp_main(argv, f"{tag} hold", keep_whole=True)
    ref = hold_run(argv_with(argv, **against))
    loss_held(tp["losses"], ref["losses"], f"{tag} hold", P14_HOLD["loss"])
    worst = held(tp["whole"], ref["whole"], f"{tag} hold",
                 P14_HOLD["rtol"], P14_HOLD["atol"])
    check(not fsdp or not any(tp["counts"].values()),
          f"{tag}: fsdp_auto launched {tp['counts']}")
    print(f"{tag}: {what}, float32, 2 steps: losses "
          f"{tp['losses']} vs {ref['losses']} (within {P14_HOLD['loss']} "
          f"relative), params within rtol {P14_HOLD['rtol']} / atol "
          f"{P14_HOLD['atol']} (the largest {worst:.3f} of the bound)")
    del tp, ref
    free_cuda()


def phase_tp_families(smi: str) -> dict:
    """Phase 15 (a)-(c) on one card."""
    t15 = time.perf_counter()
    a = p15_tp_run("a", P15A_ARGV, P15A_LAYERS, smi)
    measured_tp("15a", EP_ARCH, P15A_ARGV, a, local=True,
                layers=P15A_LAYERS)
    del a["digest"]
    single = {"mesh": "1x1", "mode": "single"}
    with cut_depth(P15_HOLD_LAYERS), f32_configs():
        p15_hold("a", argv_with(P15A_ARGV, **P15_HOLD_MESH), single,
                 f"1x2 vs single (no model axis) at {P15_HOLD_LAYERS} "
                 f"layer, global batch 1")
    b = p15_tp_run("b", P15B_ARGV, P15A_LAYERS, smi)
    with cut_depth(P15_HOLD_LAYERS), f32_configs():
        p15_hold("b", argv_with(P15B_ARGV, **P15_HOLD_MESH), single,
                 f"rowwise 1x2 vs single at {P15_HOLD_LAYERS} layer, "
                 f"global batch 1")
    for arch in P15_BIG:
        p15_hold("c", p15_small_argv(arch), single,
                 f"{arch} scaled down, fsdp_auto tp_fsdp 2x2 vs single at "
                 f"global batch 4, no kernel launched", fsdp=True)
    print(f"phase 15 in {time.perf_counter() - t15:.1f} s ({smi})")
    return {"15a": a["counts"], "15b": b["counts"]}


def p15_big_rank(spec, dev) -> dict:
    """15 (d) or (e)'s rank: ``spec["arch"]`` fsdp_auto ``tp_fsdp`` on a
    2x2 ``DistMesh``, full width at ``spec["layers"]`` layers, with a
    profiled warm step; then the scale-down config's 2 steps, this rank's
    blocks written for the parent's hold."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import train as trainer
    with cut_depth(spec["layers"]):
        on = tp_main(p15_big_argv(spec["arch"]), f"15 ({spec['label']})",
                     dev=dev, profile=True)
    keep = {}

    def on_step(step, sess, metrics):
        keep["params"] = T.map_leaves(lambda x: x.detach().cpu(),
                                      sess.params[0])

    run = trainer.main(p15_small_argv(spec["arch"]), on_step=on_step)
    torch.save(keep["params"],
               P12_DIR / f"{spec['label']}.params.{dev.index}.pt")
    return {"on": on, "hold_losses": run.losses}


def phase_tp_families_on_cards(smi: str) -> dict:
    """Phase 15 (d) and (e) on four cards, one rank a card over NCCL."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import train as trainer
    t0 = time.perf_counter()
    out = {}
    for part, (arch, layers) in zip("de", P15_BIG.items()):
        label = "15" + part
        print(f"phase 15 ({part}): {' '.join(p15_big_argv(arch))} on a 2x2 "
              f"DistMesh, one rank a card over NCCL: {arch} full width, "
              f"fsdp_auto tp_fsdp; " + p15_reckoning(arch, layers, 4),
              flush=True)
        res = torchrun(4, "15big", label, arch=arch, layers=layers,
                       alloc_conf=P14D_ALLOC_CONF)
        on = [x["on"] for x in res]
        for r, x in enumerate(on):
            check(not any(x["counts"].values()), f"({label}) rank {r}: "
                  f"{x['counts']}")
            check(x["losses"] == on[0]["losses"], f"({label}) rank {r}'s "
                  f"losses {x['losses']} vs rank 0's {on[0]['losses']}")
            check(x["steps"] == on[0]["steps"], f"({label}) ranks counted "
                  f"different calls")
            print(f"phase 15 ({part}) rank {r}: step seconds "
                  f"{[round(t, 4) for t in x['step_seconds']]}, warm step "
                  f"{x['warm_ms']:.1f} ms, peak {x['peak'] / 2**30:.2f} "
                  f"GiB, a step: data axis {x['steps'][0]['data']}, model "
                  f"axis {x['steps'][0]['model']} ({smi})")
        world_s = [max(x["step_seconds"][i] for x in on)
                   for i in range(len(on[0]["step_seconds"]))]
        steps_s = [round(t, 4) for t in world_s]
        peaks = [round(x["peak"] / 2**30, 2) for x in on]
        print(f"phase 15 ({part}): losses {on[0]['losses']}, grad norms "
              f"{on[0]['gnorm']}; the world's step {steps_s} s; peak a "
              f"card {peaks} GiB")
        MEASURED[label] = dict(
            arch=arch, kind="train", seq=2048, batch=2, ranks=4, local=False,
            mode="fsdp_auto", sync={}, tp=(2, 2), layers=layers,
            measured_s=min(world_s[1:]), steps=on[0]["steps"],
            peak=max(x["peak"] for x in on))
        # the hold: the scale-down config's 2 steps in process (4 virtual
        # ranks on card 0)
        keep = {}

        def on_step(step, sess, metrics):
            keep["params"] = [T.map_leaves(lambda x: x.detach().cpu(), p)
                              for p in sess.params]

        run = trainer.main(p15_small_argv(arch), on_step=on_step)
        loss_held(res[0]["hold_losses"], run.losses, f"({label}) hold", 1e-5)
        worst, bitwise = 0.0, run.losses == res[0]["hold_losses"]
        for r in range(4):
            path = P12_DIR / f"{label}.params.{r}.pt"
            got = torch.load(path)
            worst = max(worst, held(got, keep["params"][r],
                                    f"({label}) hold rank {r}", 1e-5, 1e-5))
            bitwise = bitwise and all(
                same_bits(a, b) for a, b in zip(
                    T.leaves(got), T.leaves(keep["params"][r])))
            path.unlink()
        print(f"phase 15 ({part}): {arch} scaled down, 2 steps: 4 processes "
              f"over NCCL vs 4 virtual ranks on one card: losses "
              f"{res[0]['hold_losses']} vs {run.losses}; every rank's blocks "
              f"within rtol 1e-5 / atol 1e-5 (the largest {worst:.3f} of "
              f"the bound); bitwise: {bitwise}")
        out[label] = {k: sum(x["counts"][k] for x in on) for k in counters()}
        free_cuda()
    print(f"phase 15 (d), (e) in {time.perf_counter() - t0:.1f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# Phase 16: tensor parallelism and fsdp_auto of the hybrid, xLSTM and
# encoder-decoder families
# ---------------------------------------------------------------------------

#: (a)-(c) on one card: each family's arch, sequence (whisper's frames;
#: its 448 decoder tokens follow) and depth (``None``: the config's);
#: zero1 on 2x2, bf16, full width, global batch 2, 2 steps.  hymba's
#: depth and the xLSTM's sequence are cut for the phase's time: a hymba
#: layer costs ≈ 0.4 s a step of host dispatch for four ranks, and the
#: sLSTM's step loop runs once a token (136,766 kernels a step at seq
#: 256, whose profile alone took ≈ 14 s of host time; 77,378 at 128).  (c) syncs on the
#: int8 wire (``P16_WIRE``; no EF residuals, whose compensation quantizes
#: on the card whatever ``--fused-kernel`` says, as phase 5 (a)):
#: ``quantize`` and ``fused_round_dq`` in place of ``fused_round``.  Then
#: whisper in fsdp_auto (``tp``), the same shape.
P16 = {"a": ("hymba-1.5b", 2048, 3), "b": ("xlstm-125m", 64, None),
       "c": ("whisper-small", 1500, None)}
P16_WIRE = {"c": "int8"}
#: (d), (e) on four cards, one rank a card over NCCL: arch, sequence and
#: depth.  hymba's depth is cut for the phase's time: its step's
#: model-axis calls, counted on ``meta`` tensors (``roofline.tp_counts``),
#: take ≈ 3.7 s of host time a layer (the chunked flash attention's ops)
P16_CARDS = {"d": ("hymba-1.5b", 2048, 16), "e": ("whisper-small", 1500,
                                                   None)}


class p16_counting:
    """``p16_counts`` of every job (key -> its arguments) in worker
    processes, started on entry, beside the card's work: each count runs
    the model on ``meta`` tensors, seconds to minutes of host time.
    ``get(key)`` waits for one; the workers end on exit."""

    def __init__(self, jobs: dict):
        self.jobs = jobs

    def __enter__(self):
        import concurrent.futures as cf
        import multiprocessing as mp
        self.pool = cf.ProcessPoolExecutor(
            max_workers=len(self.jobs), mp_context=mp.get_context("spawn"))
        self.futures = {k: self.pool.submit(p16_counts, *args)
                        for k, args in self.jobs.items()}
        return self

    def get(self, key):
        return self.futures[key].result()

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)


def p16_argv(arch: str, seq: int, **flags) -> list:
    return argv_with(MAIN_ARGV, arch=arch, mesh="2x2", global_batch=2,
                     steps=2, seq_len=seq, **flags)


def p16_small_argv(arch: str, **flags) -> list:
    """The holds: the scale-down config (float32), 2x2, seq 64, global
    batch 4, 2 steps."""
    return argv_with(MAIN_ARGV, arch=arch, scale_down=True, mesh="2x2",
                     global_batch=4, seq_len=64, steps=2, **flags)


def p16_counts(arch: str, seq: int, layers, ranks: int,
               wire: str | None = None):
    """``roofline.tp_counts`` of one zero1 step of ``arch`` on 2x2 at full
    width (``layers`` deep, the sync on ``wire``), for a process of
    ``ranks`` ranks."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ShardingRecipe
    from repro_torch.models import sharding as shd
    from repro_torch.optim.zero1 import GradSyncConfig
    from repro_torch.roofline import tp_counts
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    lay = shd.tp_layout(cfg, ShardingRecipe(tp_size=2), (2, 2))
    return tp_counts(cfg, lay, mode="zero1", batch=2, seq=seq,
                     sync=GradSyncConfig(wire_dtype=wire), ranks=ranks)


def p16_launches(label: str, counts: dict, steps: int, ranks: int, pc,
                 n_zero: int, wire: str | None = None) -> None:
    """``fused_round`` launched once a rank for each reduce-scatter round
    ``tp_counts`` puts on the data axis (D = 2: one round a zero leaf,
    half the axis's exchanges), nothing else; on the int8 wire (no EF)
    ``fused_round_dq`` in its place, and round 0's ``quantize`` and
    ``quantize_rows``."""
    want = {name: 0 for name in counters()}
    rounds = steps * ranks * pc["data"].exchanges // 2
    if wire:
        want.update(fused_round_dq=rounds, quantize=rounds,
                    quantize_rows=rounds)
    else:
        want["fused_round"] = rounds
    check(counts == want and pc["data"].exchanges == 2 * n_zero,
          f"{label}: launches {counts}, expected {want} (= {steps} steps x "
          f"{ranks} ranks x {pc['data'].exchanges} / 2 data-axis exchanges "
          f"of tp_counts, {n_zero} zero leaves a rank)")


def p16_run(part: str, smi: str, counting) -> dict:
    """(a), (b) or (c): zero1 on 2x2 with a profiled warm step, then step
    0 with ``--fused-kernel off``: launches as ``tp_counts`` (from
    ``counting``) predicts, on and off bitwise."""
    from repro_torch.configs import get_config
    arch, seq, layers = P16[part]
    label = f"phase 16 ({part})"
    wire = P16_WIRE.get(part)
    argv = p16_argv(arch, seq, **({"wire_dtype": wire,
                                   "no_error_feedback": True}
                                  if wire else {}))
    n_zero = tp_zero_leaves(argv, layers)
    full = get_config(arch).n_layers
    cut = [f"depth {full} -> {layers}"] if layers else []
    cut += [f"seq 2048 -> {seq}"] if arch == "xlstm-125m" else []
    print(f"{label}: {' '.join(argv)}: {arch} full width, bf16, 4 virtual "
          f"ranks on one card ({n_zero} zero leaves a rank); reduced: "
          f"{', '.join(cut) or 'none'}", flush=True)
    with cut_depth(layers):
        run = tp_main(argv, label, profile=True)
        off = tp_main(argv_with(argv, steps=1, fused_kernel="off"),
                      f"{label}, kernels off")
    steps = len(run["losses"])
    pc = counting.get(part)
    p16_launches(label, run["counts"], steps, 4, pc, n_zero, wire)
    print_tp_run(label, run, smi)
    print(f"{label}: launches as {steps} steps x 4 ranks x "
          f"{pc['data'].exchanges // 2} reduce-scatter rounds of tp_counts "
          f"give them{' on the int8 wire' if wire else ''}; warm step "
          f"{run['warm_ms']:.1f} ms")
    check(not any(off["counts"].values()), f"{label} off: {off['counts']}")
    check(off["losses"][0] == run["losses"][0] and off["gnorm"][0] ==
          run["gnorm"][0] and off["digest"] == run["digest"],
          f"{label}: kernels on and off differ in step 0's loss or grad "
          f"norm or the params after it")
    print(f"{label}: --fused-kernel off gives a bitwise-equal step-0 loss "
          f"and grad norm and bitwise-equal params (every rank's blocks) "
          f"after step 0")
    measured_tp("16" + part, arch, argv, run, local=True, layers=layers,
                counts=pc)
    del run["digest"]
    run["counts"] = {k: run["counts"][k] + off["counts"][k]
                     for k in run["counts"]}
    return run


def p16_jobs() -> dict:
    """:class:`p16_counting`'s jobs for phase 16 (a)-(c)."""
    return {part: (arch, seq, layers, 4, P16_WIRE.get(part))
            for part, (arch, seq, layers) in P16.items()}


def phase_tp_more_families(smi: str, counting: p16_counting) -> dict:
    """Phase 16 (a)-(c) on one card, whisper's fsdp_auto, and the float32
    holds of the three families scaled down against mode single;
    ``counting``: :class:`p16_counting` of :func:`p16_jobs`, entered by
    the caller (its workers count beside the phases before)."""
    t16 = time.perf_counter()
    out = {}
    for part in P16:
        t0 = time.perf_counter()
        out["16" + part] = p16_run(part, smi, counting)["counts"]
        print(f"phase 16 ({part}) in {time.perf_counter() - t0:.1f} s",
              flush=True)
    arch, seq, layers = P16["c"]
    argv = p16_argv(arch, seq, mode="fsdp_auto")
    fs = tp_main(argv, "phase 16 (c) fsdp_auto")
    check(not any(fs["counts"].values()), f"phase 16 (c) fsdp_auto: "
          f"launched {fs['counts']} (it runs the native calls only)")
    print_tp_run("phase 16 (c) fsdp_auto", fs, smi)
    single = {"mesh": "1x1", "mode": "single"}
    for arch, mode in (("hymba-1.5b", "zero1"), ("xlstm-125m", "fsdp_auto"),
                       ("whisper-small", "zero1")):
        p15_hold(arch, p16_small_argv(arch, mode=mode), single,
                 f"{arch} scaled down, {mode} 2x2 vs single at global batch "
                 f"4", fsdp=mode == "fsdp_auto", phase=16)
    print(f"phase 16 in {time.perf_counter() - t16:.1f} s ({smi})")
    return out


def p16_rank(spec, dev) -> dict:
    """16 (d) or (e)'s rank: ``spec["arch"]`` zero1 on a 2x2 ``DistMesh``,
    full width, with a profiled warm step; then the scale-down config's
    2 steps, this rank's blocks written for the parent's hold."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import train as trainer
    with cut_depth(spec["layers"]):
        on = tp_main(p16_argv(spec["arch"], spec["seq"]),
                     f"16 ({spec['label']})", dev=dev, profile=True)
    keep = {}

    def on_step(step, sess, metrics):
        keep["params"] = T.map_leaves(lambda x: x.detach().cpu(),
                                      sess.params[0])

    run = trainer.main(p16_small_argv(spec["arch"]), on_step=on_step)
    torch.save(keep["params"],
               P12_DIR / f"{spec['label']}.params.{dev.index}.pt")
    del on["digest"]
    return {"on": on, "hold_losses": run.losses}


def phase_tp_more_families_on_cards(smi: str) -> dict:
    """Phase 16 (d) and (e) on four cards, one rank a card over NCCL, each
    with its scale-down run held bitwise against 4 virtual ranks on one
    card."""
    t0 = time.perf_counter()
    out = {}
    with p16_counting({part: (arch, seq, layers, 1) for part, (
            arch, seq, layers) in P16_CARDS.items()}) as counting:
        for part in P16_CARDS:
            out["16" + part] = p16_on_cards(part, smi, counting)
    print(f"phase 16 (d), (e) in {time.perf_counter() - t0:.1f} s ({smi})")
    return out


def p16_on_cards(part: str, smi: str, counting) -> dict:
    """(d) or (e): the world, its launches against ``tp_counts``, its
    phase-13 record and its scale-down hold; returns its launches."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import train as trainer
    arch, seq, layers = P16_CARDS[part]
    label = "16" + part
    argv = p16_argv(arch, seq)
    n_zero = tp_zero_leaves(argv, layers)
    full = get_config(arch).n_layers
    print(f"phase 16 ({part}): {' '.join(argv)} on a 2x2 DistMesh, one "
          f"rank a card over NCCL: {arch} full width, zero1 ({n_zero} zero "
          f"leaves a rank); reduced: "
          f"{f'depth {full} -> {layers}' if layers else 'none'}",
          flush=True)
    res = torchrun(4, "16big", label, arch=arch, seq=seq, layers=layers)
    on = [x["on"] for x in res]
    pc = counting.get(part)
    for r, x in enumerate(on):
        p16_launches(f"({label}) rank {r}", x["counts"],
                     len(x["losses"]), 1, pc, n_zero)
        check(x["losses"] == on[0]["losses"], f"({label}) rank {r}'s "
              f"losses {x['losses']} vs rank 0's {on[0]['losses']}")
        print(f"phase 16 ({part}) rank {r}: step seconds "
              f"{[round(t, 4) for t in x['step_seconds']]}, warm step "
              f"{x['warm_ms']:.1f} ms, peak {x['peak'] / 2**30:.2f} "
              f"GiB, launches {x['counts']}, a step: data axis "
              f"{x['steps'][0]['data']}, model axis "
              f"{x['steps'][0]['model']} ({smi})")
    world_s = [max(x["step_seconds"][i] for x in on)
               for i in range(len(on[0]["step_seconds"]))]
    print(f"phase 16 ({part}): losses {on[0]['losses']}, grad norms "
          f"{on[0]['gnorm']}; the world's step "
          f"{[round(t, 4) for t in world_s]} s; peak a card "
          f"{[round(x['peak'] / 2**30, 2) for x in on]} GiB")
    MEASURED[label] = dict(
        arch=arch, kind="train", seq=seq, batch=2, ranks=4, local=False,
        mode="zero1", sync={}, tp=(2, 2), layers=layers,
        measured_s=min(world_s[1:]), steps=on[0]["steps"],
        peak=max(x["peak"] for x in on), counts=pc)
    keep = {}

    def on_step(step, sess, metrics):
        keep["params"] = [T.map_leaves(lambda x: x.detach().cpu(), p)
                          for p in sess.params]

    run = trainer.main(p16_small_argv(arch), on_step=on_step)
    bitwise = run.losses == res[0]["hold_losses"]
    for r in range(4):
        path = P12_DIR / f"{label}.params.{r}.pt"
        got = torch.load(path)
        bitwise = bitwise and all(
            same_bits(a, b) for a, b in zip(
                T.leaves(got), T.leaves(keep["params"][r])))
        path.unlink()
    check(bitwise, f"({label}) hold: the scale-down run over NCCL "
          f"({res[0]['hold_losses']}) is not bitwise the in-process "
          f"run ({run.losses}) in its losses or every rank's blocks")
    print(f"phase 16 ({part}): {arch} scaled down, 2 steps: 4 processes "
          f"over NCCL bitwise 4 virtual ranks on one card (losses "
          f"{run.losses}, every rank's blocks)")
    free_cuda()
    return {k: sum(x["counts"][k] for x in on) for k in counters()}


# ---------------------------------------------------------------------------
# Phase 12: one rank per card, over NCCL, started by torchrun
# ---------------------------------------------------------------------------

#: argument that makes this script one rank of a phase-12 world, started
#: by ``python -m torch.distributed.run`` (see :func:`torchrun`).
RANK_CHILD = "--rank-child"
#: the mode that runs phase 12 (b)-(g): ``python3 chip_smoke.py --cards 4``.
CARDS = "--cards"
P12_CARDS = 4
#: seconds a phase-12 world may run before the parent kills it: a hang
#: fails its phase in minutes, not at the call's limit.
P12_TIMEOUT_S = 480
P12_DIR = ROOT / "build" / "phase12"
#: (a): the launcher on one card, one process, at 3 of 28 layers.
P12A_ARGV = argv_with(MAIN_ARGV, mesh="1x1", steps=2, global_batch=1)
P12A_LAYERS = 3
#: (b): payload bytes per rank, calls timed per point.
P12B_BYTES = [1 << k for k in range(10, 29, 2)]
P12B_CALLS = 20
#: (b): the payload whose results are held bitwise against a LocalComm.
P12B_CHECK_BYTES = 1 << 22
#: (c): the main path at p = 4, full width and depth.
P12C_ARGV = argv_with(MAIN_ARGV, mesh="4x1", global_batch=4)
#: (c): depth of the runs held against 4 virtual ranks on one card.
P12C_CROSS_LAYERS = 3
#: (d): the int8 wire with EF at p = 3, full width and depth.
P12D_ARGV = argv_with(MAIN_ARGV, wire_dtype="int8", steps=2)
#: (e): ep phi-3.5-MoE on a 2x2 DistMesh, every width, depth 32 -> 2.
P12E = dict(EP_MAIN, dp=2, mp=2, global_batch=2, n_layers=2, steps=2)
#: (f): ep decode at pe = 4, depth 32 -> 16 (a whole replica a card:
#: weights and the initializer's one float32 temporary of a stacked
#: expert leaf); the scheduler's requests.
P12F_EP4 = dict(EP_SERVE, ep_devices=4, n_layers=16)
P12F_SCHED = dict(n=4, max_batch=2, block=16)
#: (f): the fan-out's replicas (qwen3-1.7b, every width and layer).
P12F_REPLICAS = 4
#: (g): (c)'s config at 3 layers, global batch 12 (p = 4 and p' = 3).
P12G_ARGV = argv_with(MAIN_ARGV, mesh="4x1", global_batch=12, steps=4)
P12G_LAYERS = 3


class cut_depth:
    """Within the block, every session the launchers build in this process
    has ``n_layers`` layers (the session builder's ``n_layers=``; the
    launchers have no depth flag)."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers

    def __enter__(self):
        import functools
        from repro_torch.launch import bootstrap
        self.build = bootstrap.build_session
        bootstrap.build_session = functools.partial(self.build,
                                                    n_layers=self.n_layers)

    def __exit__(self, *exc):
        from repro_torch.launch import bootstrap
        bootstrap.build_session = self.build


def digest(tree) -> list:
    """Per leaf (flatten order), two integers of its raw bits: their sum
    and their sum weighted by position (``i % 65521 + 1``), in int64 on
    the card: equal trees give equal digests, and a changed bit changes
    both."""
    import torch
    from repro_torch import tree as T
    out = []
    for leaf in T.leaves(tree):
        b = bits(leaf.detach()).reshape(-1)
        s1 = s2 = 0
        for lo in range(0, b.numel(), 1 << 24):
            chunk = b[lo:lo + (1 << 24)].to(torch.int64)
            w = torch.arange(lo, lo + chunk.numel(), device=chunk.device,
                             dtype=torch.int64) % 65521 + 1
            s1 += int(chunk.sum())
            s2 += int((chunk * w).sum())
        out.append([s1, s2])
    return out


def gathered(obj) -> list:
    """Every rank's ``obj``, in rank order (``all_gather_object``)."""
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def on_card(sess_params, dev, label: str) -> None:
    """Every leaf of this rank's parameters lies on its own card."""
    from repro_torch import tree as T
    where = {str(x.device) for x in T.leaves(sess_params)}
    check(where == {str(dev)}, f"{label}: parameters on {where}, this rank "
          f"is pinned to {dev}")


def torchrun(n: int, phase: str, label: str, **spec) -> list:
    """Run ``phase`` as a world of ``n`` processes, one per card, each this
    script as ``--rank-child`` under ``python -m torch.distributed.run
    --standalone``: rank 0's lines reach this output, the others' go to
    ``build/phase12/<label>.rank<r>.log``.  Kills the world's process
    group after ``P12_TIMEOUT_S`` (a hang fails the phase); fails unless
    every rank exits 0 on a card of its own.  Returns each rank's result
    (its ``<label>.<r>.json``)."""
    import os
    import signal
    P12_DIR.mkdir(parents=True, exist_ok=True)
    for old in P12_DIR.glob(f"{label}.*"):
        old.unlink()
    spec = dict(spec, phase=phase, label=label)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"),
           RANK_CHILD, json.dumps(spec)]
    print(f"phase 12 {label}: {n} process(es): python -m "
          f"torch.distributed.run --standalone --nproc-per-node {n} "
          f"chip_smoke.py {RANK_CHILD} '{json.dumps(spec)}'", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True)
    try:
        rc = proc.wait(timeout=P12_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        fail(f"phase 12 {label}: the world of {n} did not end within "
             f"{P12_TIMEOUT_S} s; killed")
    check(rc == 0, f"phase 12 {label}: the world of {n} exited {rc}")
    res = [json.loads((P12_DIR / f"{label}.{r}.json").read_text())
           for r in range(n)]
    cards = [r["card"] for r in res]
    check([c["index"] for c in cards] == list(range(n))
          and len({c["uuid"] for c in cards}) == n,
          f"phase 12 {label}: ranks on cards {cards}")
    print(f"phase 12 {label}: rank r on card r for every r < {n}, "
          f"{time.perf_counter() - t0:.1f} s with the processes' start",
          flush=True)
    return res


def rank_child(spec_json: str) -> int:
    """One rank of a phase-12 world: join torchrun's world (the card
    pinned first), run the phase, write the result."""
    import os
    import torch
    import torch.distributed as dist
    spec = json.loads(spec_json)
    if spec.get("alloc_conf"):  # before the first allocation on the card
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = spec["alloc_conf"]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh
    rank = int(os.environ["RANK"])
    if rank:
        sys.stdout = open(P12_DIR / f"{spec['label']}.rank{rank}.log", "w",
                          buffering=1)
    dev = mesh.init_world("cuda")
    check(dev.index == int(os.environ["LOCAL_RANK"])
          == torch.cuda.current_device(),
          f"rank {rank}: pinned to {dev}, current device "
          f"{torch.cuda.current_device()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = P12_PHASES[spec["phase"]](spec, dev)
    res["card"] = {"index": dev.index,
                   "uuid": str(torch.cuda.get_device_properties(dev).uuid)}
    with open(P12_DIR / f"{spec['label']}.{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_recorded(argv, label: str, dev) -> dict:
    """``launch.train.main(argv)`` in this rank, launch counts set to 0
    just before and read just after: losses, grad norms, step seconds,
    sync bytes and exchanges, this rank's parameter digests after every
    step (checked equal on every rank of the data axis when the session
    has no model axis), peak memory and the counts."""
    import torch
    from repro_torch.launch import train as trainer
    rec = {"gnorm": [], "digests": []}

    def on_step(step, sess, metrics):
        on_card(sess.params[0], dev, label)
        rec["gnorm"].append(float(metrics["grad_norm"]))
        d = digest(sess.params[0])
        if sess.ep_comm is None and sess.tp is None:
            check(all(x == d for x in gathered(d)),
                  f"{label}: ranks' params differ after step {step}")
        rec["digests"].append(d)

    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    run = trainer.main(argv, on_step=on_step)
    rec.update(counts=read_counts(), losses=run.losses,
               step_seconds=run.step_seconds, sync_bytes=run.sync_bytes,
               exchanges=run.sync_exchanges,
               peak=torch.cuda.max_memory_allocated(dev))
    free_cuda()
    return rec


def p12_launcher_one_card(spec, dev) -> dict:
    """(a)'s rank: the launcher's argv at 3 layers."""
    with cut_depth(P12A_LAYERS):
        return run_recorded(spec["argv"], "phase 12 (a)", dev)


def p12_collectives(spec, dev) -> dict:
    """(b)'s rank: RS and AR of every algorithm over a ``DistComm`` of the
    world: exchanges, natives and bytes of one call against
    ``ceil(log2 p)`` (ring ``p - 1``) rounds and p - 1 blocks; the
    results bitwise a ``LocalComm``'s on the same inputs (every rank's
    made on this card from the same seeds); the device ms of each call
    on each rank (CUDA events, the ranks aligned by a barrier before
    every call), for every payload of ``P12B_BYTES``."""
    import torch
    import torch.distributed as dist
    from repro_torch.comm import DistComm, LocalComm
    from repro_torch.core import plan
    p, rank = dist.get_world_size(), dist.get_rank()
    comm = DistComm()

    def inputs(n):
        return [torch.randn(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(1200 + q)) for q in range(p)]

    n = P12B_CHECK_BYTES // 4 // p * p
    xs = inputs(n)
    res = {"counts": {}, "ms": {}}
    for coll in ("RS", "AR"):
        for name, cs in rs_algorithms(p).items():
            if coll == "AR" and name == "recursive halving":
                continue
            pl = plan(cs, p=p)
            run = pl.reduce_scatter if coll == "RS" else pl.allreduce
            x0, b0, n0 = comm.exchanges, comm.bytes, comm.natives
            got = run([xs[rank]], comm)[0]
            counts = (comm.exchanges - x0, comm.natives - n0,
                      comm.bytes - b0)
            ex, nat = algo_counts(name, coll, p)
            nbytes = 0 if name == "native" else \
                (p - 1) * (n // p) * 4 * (2 if coll == "AR" else 1)
            check(counts == (ex, nat, nbytes), f"(b) {coll} {name} p={p}: "
                  f"exchanges, natives, bytes {counts}, want "
                  f"{(ex, nat, nbytes)}")
            res["counts"][f"{coll} {name}"] = counts
            if name != "native":
                want = run(xs, LocalComm(p))[rank]
                check(same_bits(got, want), f"(b) {coll} {name} p={p} rank "
                      f"{rank}: differs from the LocalComm result")
            for nb in P12B_BYTES:
                m = max(p, nb // 4 // p * p)
                x = [torch.randn(m, device=dev, generator=torch.Generator(
                    device=dev).manual_seed(1300 + rank))]

                def call(run=run, x=x):
                    run(x, comm)

                for _ in range(2):
                    call()
                torch.cuda.synchronize(dev)
                evs = []
                for _ in range(P12B_CALLS):
                    dist.barrier()
                    a, b = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                    a.record()
                    call()
                    b.record()
                    evs.append((a, b))
                torch.cuda.synchronize(dev)
                mine = [a.elapsed_time(b) for a, b in evs]
                slowest = [max(c) for c in zip(*gathered(mine))]
                res["ms"][f"{coll} {name} {m}"] = statistics.median(slowest)
                del x
    return res


def p12_main_path(spec, dev) -> dict:
    """(c)'s rank: the launcher at p = 4, kernels on (4 steps, full width
    and depth) and off (2 steps); one profiled warm step; 2 steps at 3
    layers, held against 4 virtual ranks on one card by the parent."""
    from repro_torch.core import ceil_log2
    from repro_torch.launch import bootstrap
    from repro_torch.launch import train as trainer
    p = 4
    n_zero = len(wire_leaves(p))
    on = run_recorded(P12C_ARGV, "(c) kernels on", dev)
    steps = len(on["losses"])
    want = {name: 0 for name in counters()}
    want["fused_round"] = steps * n_zero * ceil_log2(p)
    check(on["counts"] == want, f"(c) launches {on['counts']}, want {want}")
    rs, ag = sync_bytes(p, wire=False)
    check(all(b == (rs + ag) // p for b in on["sync_bytes"]) and
          all(x == 2 * n_zero * ceil_log2(p) for x in on["exchanges"]),
          f"(c) sync bytes {on['sync_bytes']} (want {(rs + ag) // p}), "
          f"exchanges {on['exchanges']}")
    off = run_recorded(argv_with(P12C_ARGV, steps=2, fused_kernel="off"),
                       "(c) kernels off", dev)
    check(not any(off["counts"].values()), f"(c) off: {off['counts']}")
    check(off["losses"][0] == on["losses"][0] and off["gnorm"][0] ==
          on["gnorm"][0] and off["digests"][1] == on["digests"][1],
          "(c) kernels on and off differ in step 0's loss or grad norm or "
          "the params after step 1")
    _, sess = trainer.build(argv_with(P12C_ARGV, steps=3))
    bootstrap.run_step(sess, 0)
    wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
    profiled_step(lambda: bootstrap.run_step(sess, 2),
                  f"phase 12 (c) rank {dev.index}, warm step 2", wall_1,
                  ranks=1)
    del sess
    free_cuda()
    with cut_depth(P12C_CROSS_LAYERS):
        cross = run_recorded(argv_with(P12C_ARGV, steps=2), "(c) 3 layers",
                             dev)
    return {"on": on, "off": off, "warm_ms": wall_1, "cross": cross}


def p12_wire(spec, dev) -> dict:
    """(d)'s rank: the int8 wire with EF at p = 3, kernels on and off (2
    steps each), and one exact step of the same config."""
    p = 3
    n_zero = len(wire_leaves(p))
    on = run_recorded(P12D_ARGV, "(d) kernels on", dev)
    steps = len(on["losses"])
    want = {name: 0 for name in counters()}
    want.update(quantize=steps * n_zero * 2, quantize_rows=steps * n_zero,
                fused_round_dq=steps * n_zero * 2)
    check(on["counts"] == want, f"(d) launches {on['counts']}, want {want}")
    off = run_recorded(argv_with(P12D_ARGV, fused_kernel="off"),
                       "(d) kernels off", dev)
    want = {name: 0 for name in counters()}
    want["quantize"] = steps * n_zero  # EF rounds on the int8 grid always
    check(off["counts"] == want, f"(d) off: {off['counts']}, want {want}")
    check(off["losses"] == on["losses"] and off["gnorm"] == on["gnorm"]
          and off["digests"] == on["digests"],
          "(d) kernels on and off differ")
    exact = run_recorded(argv_with(MAIN_ARGV, steps=1), "(d) exact", dev)
    gn_w, gn_x = on["gnorm"][0], exact["gnorm"][0]
    check(abs(gn_w - gn_x) <= WIRE_RTOL * gn_x, f"(d) step-0 grad norm "
          f"{gn_w} on the wire vs {gn_x} exact")
    return {"on": on, "off": off, "exact": exact}


def ep_run(kw: dict, fused, dev, label: str) -> dict:
    """An ep session of ``kw`` (build_session's kwargs) in this world,
    driven for its steps: losses, grad norms, this rank's digests, step
    seconds, counts and peak."""
    import torch
    from repro_torch.launch import bootstrap
    torch.cuda.reset_peak_memory_stats(dev)
    sess = bootstrap.build_session(use_fused_kernel=fused, **kw)
    on_card(sess.params[0], dev, label)
    zero_counts()
    rec = {"losses": [], "gnorm": [], "step_seconds": []}
    for step in range(kw["steps"]):
        t0 = time.perf_counter()
        m = bootstrap.run_step(sess, step)
        rec["losses"].append(float(m["loss"]))
        rec["gnorm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize(dev)
        rec["step_seconds"].append(time.perf_counter() - t0)
    rec.update(counts=read_counts(), digest=digest(sess.params[0]),
               peak=torch.cuda.max_memory_allocated(dev),
               exchanges=[sess.comm.exchanges, sess.ep_comm.exchanges],
               n_layers=sess.cfg.n_layers)
    del sess
    free_cuda()
    return rec


def p12_ep(spec, dev) -> dict:
    """(e)'s rank: ep phi-3.5-MoE on a 2x2 DistMesh at every width and
    ``P12E``'s depth, kernels on and off; then the scaled-down 2x2
    config of phase 6 (b), held by the parent against its in-process
    run."""
    from repro_torch.core import ceil_log2
    on = ep_run(P12E, None, dev, "(e) kernels on")
    off = ep_run(P12E, False, dev, "(e) kernels off")
    steps, layers = P12E["steps"], P12E["n_layers"]
    check(on["counts"]["permute_rows"] == steps * layers * 6,
          f"(e) permute_rows {on['counts']['permute_rows']}, want "
          f"{steps * layers * 6} = {steps} steps x {layers} layers x 6")
    check(on["counts"]["fused_round"] > 0 and not any(off["counts"].values()),
          f"(e) on {on['counts']}, off {off['counts']}")
    check(on["losses"] == off["losses"] and on["gnorm"] == off["gnorm"] and
          on["digest"] == off["digest"], "(e) kernels on and off differ")
    check(on["exchanges"][1] == steps * layers * 8 * ceil_log2(2),
          f"(e) model-axis exchanges {on['exchanges'][1]}")
    small = ep_run({k: v for k, v in EP_SMALL.items()}, None, dev,
                   "(e) scaled down")
    return {"on": on, "off": off, "small": small}


def serve_logits_path(label: str, rank: int):
    return P12_DIR / f"{label}.logits.{rank}.pt"


def p12_serve_ep2(spec, dev) -> dict:
    """(f)'s 2-rank world: phase 10 (e)'s ep decode (pe = 2, 8 layers)
    with one rank per card (every call's logits saved for the parent);
    then the scheduler over that engine."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import bootstrap
    e = EP_SERVE
    b, s, new = e["batch"], e["prompt"], e["new"]
    torch.cuda.reset_peak_memory_stats(dev)
    sess = bootstrap.build_serve_session(
        arch=e["arch"], max_len=s + new, moe_dispatch="ep",
        ep_devices=e["ep_devices"], n_layers=e["n_layers"], device="cuda")
    on_card(sess.params, dev, "(f) pe = 2")
    prompts = np.random.default_rng(0).integers(
        0, sess.cfg.vocab_size, (b, s)).astype(np.int32)
    zero_counts()
    tokens, logits = generate_logits(sess.engine, prompts, new)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    want = 2 * e["n_layers"] * (1 + new)
    check(counts["permute_rows"] == want, f"(f) pe = 2: permute_rows "
          f"{counts['permute_rows']}, want {want}")
    torch.save(torch.stack([x.cpu() for x in logits]),
               serve_logits_path(spec["label"], dist.get_rank()))
    t = sess.engine.timings
    sched = p12_scheduler(sess.engine, sess.cfg.vocab_size)
    return {"tokens": tokens.tolist(), "counts": counts,
            "ttft_ms": t["ttft_s"] * 1e3, "p50": pct(t["step_s"], 50),
            "p99": pct(t["step_s"], 99), "sched": sched,
            "peak": torch.cuda.max_memory_allocated(dev)}


def p12_sched_requests(vocab: int):
    """(f)'s scheduler requests from seed 12: prompt lengths 256-1024 in
    steps of 64, 8-24 new tokens."""
    rng = np.random.default_rng(12)
    lens = rng.integers(4, 17, P12F_SCHED["n"]) * 64
    new = rng.integers(8, 25, P12F_SCHED["n"])
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), int(m))
            for n, m in zip(lens, new)]


def p12_scheduler(engine, vocab: int) -> dict:
    """The scheduler over ``engine`` (one paged cache per rank): each
    request's tokens, how many equal a one-shot run of it alone, and the
    decode-boundary p50 / p99."""
    from repro_torch.serve import Scheduler
    reqs = p12_sched_requests(vocab)
    sched = Scheduler(engine, max_batch=P12F_SCHED["max_batch"],
                      kv_block_size=P12F_SCHED["block"])
    rids = [sched.submit(toks, n) for toks, n in reqs]
    done = sched.run()
    got = [done[r].tolist() for r in rids]
    alone = [engine.generate(toks[None], n)[0].tolist() for toks, n in reqs]
    same = sum(a == b for g, o in zip(got, alone) for a, b in zip(g, o))
    return {"tokens": got, "equal_one_shot": same,
            "total": sum(len(g) for g in got),
            "p50": pct(sched.boundary_s, 50), "p99": pct(sched.boundary_s, 99)}


def p12_serve_4(spec, dev) -> dict:
    """(f)'s 4-rank world: ep decode at pe = 4 (16 layers; a warm call
    timed for tokens/s); then the broadcast fan-out of qwen3-1.7b to 4
    replicas, one a card."""
    import torch
    from repro_torch import tree as T
    from repro_torch.core import ceil_log2
    from repro_torch.launch import bootstrap
    e = P12F_EP4
    b, s, new = e["batch"], e["prompt"], e["new"]
    torch.cuda.reset_peak_memory_stats(dev)
    sess = bootstrap.build_serve_session(
        arch=e["arch"], max_len=s + new, moe_dispatch="ep",
        ep_devices=e["ep_devices"], n_layers=e["n_layers"], device="cuda")
    on_card(sess.params, dev, "(f) pe = 4")
    prompts = np.random.default_rng(0).integers(
        0, sess.cfg.vocab_size, (b, s)).astype(np.int32)
    sess.engine.generate(prompts, new)
    zero_counts()
    t0 = time.perf_counter()
    tokens = sess.engine.generate(prompts, new)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = 2 * e["n_layers"] * (1 + new)
    check(counts["permute_rows"] == want, f"(f) pe = 4: permute_rows "
          f"{counts['permute_rows']}, want {want}")
    t = sess.engine.timings
    ep = {"tokens": tokens.tolist(), "counts": counts,
          "ttft_ms": t["ttft_s"] * 1e3, "p50": pct(t["step_s"], 50),
          "p99": pct(t["step_s"], 99), "tok_s": b * new / wall,
          "peak": torch.cuda.max_memory_allocated(dev),
          "weights": tree_bytes(sess.params)}
    del sess
    free_cuda()
    sess = bootstrap.build_serve_session(
        arch="qwen3-1.7b", max_len=128, replicas=P12F_REPLICAS,
        device="cuda")
    st = sess.push_stats
    check(st["rounds"] == ceil_log2(P12F_REPLICAS) and
          st["exchanges"] == st["n_leaves"] * st["rounds"],
          f"(f) fan-out: {st}")
    on_card(sess.replica_set.engines[0].params, dev, "(f) fan-out")
    check(all(same_bits(a, c) for a, c in zip(
        T.leaves(sess.params), T.leaves(sess.replica_set.engines[0].params))),
        "(f) fan-out: this replica's weights differ from the source's")
    prompts = np.random.default_rng(0).integers(
        0, sess.cfg.vocab_size, (P12F_REPLICAS * 2, 64)).astype(np.int32)
    out = sess.replica_set.generate(prompts, 8)
    return {"ep": ep, "fanout": {k: st[k] for k in
                                 ("n_leaves", "bytes", "rounds", "exchanges",
                                  "seconds")},
            "replica_tokens": out.tolist()}


def timed_manager(writes: list, restores: list):
    """``CheckpointManager`` keeping the ``last_write`` of each write in
    ``writes`` and the seconds of each restore in ``restores`` (g)."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        def _write(self, snap):
            super()._write(snap)
            writes.append(self.last_write)

        def restore(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().restore(*args, **kwargs)
            restores.append(time.perf_counter() - t0)
            return out

    return Timed


def p12_checkpoint(spec, dev) -> dict:
    """(g)'s worlds: at 4 ranks the uninterrupted run, the run that fails
    at step 2 (checkpointed at step 2) and its resumption; rank 0 copies
    the step-2 checkpoint for the 3-rank world, which resumes from it."""
    import shutil
    import torch.distributed as dist
    from repro_torch.ft import SimulatedFailure
    from repro_torch.launch import train as trainer
    out = {"writes": [], "restores": []}
    trainer.CheckpointManager = timed_manager(out["writes"], out["restores"])
    a_dir, b_dir = P12_DIR / "ckpt_a", P12_DIR / "ckpt_b"
    ck = ["--ckpt-every", "2"]
    with cut_depth(P12G_LAYERS):
        if dist.get_world_size() == 4:
            out["uninterrupted"] = trainer.main(P12G_ARGV).losses
            try:
                trainer.main(P12G_ARGV + ck + ["--ckpt-dir", str(a_dir),
                                               "--fail-at-step", "2"])
                fail("(g): no failure injected at step 2")
            except SimulatedFailure:
                pass
            if dist.get_rank() == 0:
                shutil.copytree(a_dir / "step_2", b_dir / "step_2")
            dist.barrier()
            out["resumed"] = trainer.main(
                P12G_ARGV + ck + ["--ckpt-dir", str(a_dir)]).losses
        else:
            out["resumed"] = trainer.main(argv_with(
                P12G_ARGV + ck, mesh="3x1", ckpt_dir=str(b_dir))).losses
    return out


def p14_tp_rank(spec, dev) -> dict:
    """14 (c)'s rank: phase 14 (a)'s argv on a 2x2 ``DistMesh`` over NCCL,
    full depth, kernels on, and a profiled warm step; then 2 steps at 3
    layers, this rank's blocks written for the parent's hold."""
    import torch
    from repro_torch import tree as T
    from repro_torch.launch import train as trainer
    on = tp_main(P14A_ARGV, "14 (c)", dev=dev, profile=True)
    keep = {}

    def on_step(step, sess, metrics):
        keep["params"] = T.map_leaves(lambda x: x.detach().cpu(),
                                      sess.params[0])

    with cut_depth(P14_HOLD_LAYERS):
        run = trainer.main(argv_with(P14A_ARGV, steps=2), on_step=on_step)
    torch.save(keep["params"], P12_DIR / f"14c.params.{dev.index}.pt")
    return {"on": on, "warm_ms": on["warm_ms"], "hold_losses": run.losses}


def p14_fsdp_rank(spec, dev) -> dict:
    """14 (d)'s rank: qwen1.5-110b fsdp_auto (``tp_fsdp``) on a 2x2
    ``DistMesh``, full width, at ``P14D_BIG_LAYERS`` layers."""
    with cut_depth(P14D_BIG_LAYERS):
        return tp_main(P14_BIG_ARGV, "14 (d)", dev=dev)


def phase_tp_on_cards(smi: str) -> dict:
    """Phase 14 (c) and (d) on four cards, one rank a card over NCCL."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import ceil_log2
    from repro_torch.launch import train as trainer
    t0 = time.perf_counter()
    # (c)
    n_zero = tp_zero_leaves(P14A_ARGV)
    print(f"phase 14 (c): {' '.join(P14A_ARGV)} on a 2x2 DistMesh, one rank "
          f"a card over NCCL; reduced: none")
    res = torchrun(4, "14c", "14c")
    on = [x["on"] for x in res]
    want = {name: 0 for name in counters()}
    want["fused_round"] = len(on[0]["losses"]) * n_zero * ceil_log2(2)
    for r, x in enumerate(on):
        check(x["counts"] == want, f"(14c) rank {r}: launches "
              f"{x['counts']}, expected {want}")
        check(x["losses"] == on[0]["losses"], f"(14c) rank {r}'s losses "
              f"{x['losses']} vs rank 0's {on[0]['losses']}")
    world_s = [max(x["step_seconds"][i] for x in on)
               for i in range(len(on[0]["step_seconds"]))]
    for r, x in enumerate(on):
        print(f"phase 14 (c) rank {r}: step seconds "
              f"{[round(t, 4) for t in x['step_seconds']]}, warm step "
              f"{res[r]['warm_ms']:.1f} ms, peak {x['peak'] / 2**30:.2f} "
              f"GiB, launches {x['counts']}, a step: data axis "
              f"{x['steps'][0]['data']}, model axis {x['steps'][0]['model']}"
              f" ({smi})")
    print(f"phase 14 (c): losses {on[0]['losses']}, grad norms "
          f"{on[0]['gnorm']}; the world's step (its slowest rank) "
          f"{[round(t, 4) for t in world_s]} s")
    MEASURED["14c"] = dict(
        arch="qwen3-1.7b", kind="train", seq=2048, batch=2, ranks=4,
        local=False, mode="zero1", sync={}, tp=(2, 2), layers=None,
        measured_s=min(world_s[1:]), steps=on[0]["steps"],
        peak=max(x["peak"] for x in on))
    for x in on[1:]:
        check(x["steps"] == on[0]["steps"], "(14c) ranks counted "
              "different calls")
    # (c)'s hold: the same 2 steps at 3 layers in process (phase 14 (a)'s
    # 4 virtual ranks)
    keep = {}

    def on_step(step, sess, metrics):
        keep["params"] = [T.map_leaves(lambda x: x.detach().cpu(), p)
                          for p in sess.params]

    with cut_depth(P14_HOLD_LAYERS):
        run = trainer.main(argv_with(P14A_ARGV, steps=2), on_step=on_step)
    loss_held(res[0]["hold_losses"], run.losses, "(14c) hold", 1e-5)
    worst, bitwise = 0.0, run.losses == res[0]["hold_losses"]
    for r in range(4):
        got = torch.load(P12_DIR / f"14c.params.{r}.pt")
        worst = max(worst, held(got, keep["params"][r], f"(14c) hold rank "
                                f"{r}", 1e-5, 1e-5))
        bitwise = bitwise and all(
            same_bits(a, b) for a, b in zip(T.leaves(got),
                                            T.leaves(keep["params"][r])))
        (P12_DIR / f"14c.params.{r}.pt").unlink()
    print(f"phase 14 (c): at {P14_HOLD_LAYERS} layers, 2 steps: 4 processes "
          f"over NCCL vs 4 virtual ranks on one card: losses "
          f"{res[0]['hold_losses']} vs {run.losses}; every rank's blocks "
          f"within rtol 1e-5 / atol 1e-5 (the largest {worst:.3f} of the "
          f"bound): the model axis sums with NCCL's all_reduce; bitwise: "
          f"{bitwise}")
    free_cuda()
    # (d)
    big = get_config("qwen1.5-110b")
    layer = (big.param_count() - 2 * big.vocab_size * big.d_model) \
        / big.n_layers
    embed = 2 * big.vocab_size * big.d_model
    n = embed + P14D_BIG_LAYERS * layer
    print(f"phase 14 (d): qwen1.5-110b full width, fsdp_auto tp_fsdp on a "
          f"2x2 DistMesh, {P14D_BIG_LAYERS} of {big.n_layers} layers: 12 B a "
          f"parameter x ({embed / 1e9:.2f} B + {P14D_BIG_LAYERS} x "
          f"{layer / 1e9:.2f} B) / 4 cards = {12 * n / 4e9:.1f} GB a card, "
          f"activations and a layer's gathered weights apart; reduced: "
          f"depth {big.n_layers} -> {P14D_BIG_LAYERS}")
    # a step's blocks come and go in many sizes (a layer's gathered
    # weights, the vocab-split logits): segments that grow keep the free
    # memory usable
    big_res = torchrun(4, "14d", "14d", alloc_conf=P14D_ALLOC_CONF)
    for r, x in enumerate(big_res):
        check(not any(x["counts"].values()), f"(14d) rank {r}: "
              f"{x['counts']}")
        print_tp_run(f"phase 14 (d) rank {r}", x, smi)
    world_d = [max(x["step_seconds"][i] for x in big_res)
               for i in range(len(big_res[0]["step_seconds"]))]
    MEASURED["14d"] = dict(
        arch="qwen1.5-110b", kind="train", seq=2048, batch=2, ranks=4,
        local=False, mode="fsdp_auto", sync={}, tp=(2, 2),
        layers=P14D_BIG_LAYERS, measured_s=min(world_d[1:]),
        steps=big_res[0]["steps"], peak=max(x["peak"] for x in big_res))
    print(f"phase 14 (d): the world's step {[round(t, 4) for t in world_d]}"
          f" s; peak a card {[round(x['peak'] / 2**30, 2) for x in big_res]}"
          f" GiB")
    print(f"phase 14 (c), (d) in {time.perf_counter() - t0:.1f} s ({smi})")
    return {"14c": {k: sum(x["counts"][k] for x in on) for k in counters()},
            "14d": {k: sum(x["counts"][k] for x in big_res)
                    for k in counters()}}


P12_PHASES = {"a": p12_launcher_one_card, "b": p12_collectives,
              "c": p12_main_path, "d": p12_wire, "e": p12_ep,
              "f2": p12_serve_ep2, "f4": p12_serve_4, "g": p12_checkpoint,
              "14c": p14_tp_rank, "14d": p14_fsdp_rank,
              "15big": p15_big_rank, "16big": p16_rank}


def phase_launcher_one_card(smi: str) -> dict:
    """Phase 12 (a): the train launcher under torchrun on one card (one
    process, NCCL, ``cuda:0`` pinned), its losses bitwise those of the
    in-process launcher's same argv, both at 3 of 28 layers."""
    import torch
    from repro_torch.launch import train as trainer
    t0 = time.perf_counter()
    print(f"phase 12 (a): {' '.join(P12A_ARGV)}; reduced: depth 28 -> "
          f"{P12A_LAYERS}")
    [child] = torchrun(1, "a", "a", argv=P12A_ARGV)
    with cut_depth(P12A_LAYERS):
        run = trainer.main(P12A_ARGV)
    check(child["losses"] == run.losses, f"phase 12 (a): losses over NCCL "
          f"{child['losses']} vs in process {run.losses}")
    print(f"phase 12 (a): losses {child['losses']} bitwise the in-process "
          f"run's; step seconds {[round(x, 4) for x in child['step_seconds']]}"
          f"; peak {child['peak'] / 2**30:.2f} GiB; launches "
          f"{child['counts']} (p = 1: no round); "
          f"{time.perf_counter() - t0:.1f} s ({smi})")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    return child["counts"]


def alpha_beta(times: dict, p: int):
    """α and β (seconds, seconds per element, the fold folded in) fitted
    by least squares to the ring reduce-scatter's medians: ``t = (p - 1)
    (α + β m / p)`` for m elements per rank."""
    rows = [(m, t / 1e3) for m, t in times.items()]
    a = np.array([[p - 1, (p - 1) * m / p] for m, _ in rows])
    y = np.array([t for _, t in rows])
    (alpha, beta), *_ = np.linalg.lstsq(a, y, rcond=None)
    return float(alpha), float(beta)


def phase_collectives_on_links(smi: str) -> None:
    """Phase 12 (b): RS and AR by every algorithm over NCCL at p = 2, 3,
    4, one rank per card."""
    from repro_torch.core import cost_model as cm
    for p in (2, 3, 4):
        [r0, *_] = torchrun(p, "b", f"b{p}")
        for key, c in r0["counts"].items():
            print(f"(b) p={p} {key}: {c[0]} exchanges, {c[1]} native calls, "
                  f"{c[2]} bytes sent per rank per call at "
                  f"{P12B_CHECK_BYTES} bytes per rank")
        by = {}
        for key, ms in r0["ms"].items():
            coll, *name, m = key.split()
            by.setdefault((coll, " ".join(name)), {})[int(m)] = ms
        alpha, beta = alpha_beta(by[("RS", "ring")], p)
        model = cm.CommModel(alpha=alpha, beta=beta, gamma=0.0)
        print(f"(b) p={p}: α-β fit to the ring RS: α {alpha * 1e6:.2f} µs, "
              f"β {beta * 1e12:.3f} ps per f32 element "
              f"({4 / beta / 1e9:.1f} GB/s); data, not a gate")
        sizes = sorted({m for pts in by.values() for m in pts})
        print(f"(b) p={p}: ms per call (median of {P12B_CALLS}, slowest "
              f"rank) at {[m * 4 for m in sizes]} bytes f32 a rank ({smi})")
        for (coll, name), pts in sorted(by.items()):
            fn = None
            if name.startswith("circulant"):
                fn = cm.t_reduce_scatter if coll == "RS" else cm.t_allreduce
            elif name == "ring":
                fn = cm.t_ring_reduce_scatter if coll == "RS" else \
                    cm.t_ring_allreduce
            print(f"(b) p={p} {coll} {name}: "
                  + " ".join(f"{pts[m]:.4f}" for m in sizes)
                  + ("" if fn is None else "; α-β model " + " ".join(
                      f"{fn(m, p, model) * 1e3:.4f}" for m in sizes)))


def phase_main_path_on_cards(smi: str) -> dict:
    """Phase 12 (c), the parent's half: the 3-layer run of 4 virtual ranks
    on card 0, held against the world's."""
    from repro_torch.launch import train as trainer
    res = torchrun(4, "c", "c")
    c = res[0]
    on = c["on"]
    for x in res[1:]:
        check(x["on"]["sync_bytes"] == on["sync_bytes"] and
              x["on"]["exchanges"] == on["exchanges"],
              "(c) ranks counted different sync bytes or exchanges")
    # a world's step ends with its slowest rank
    world_s = [max(x["on"]["step_seconds"][i] for x in res)
               for i in range(len(on["step_seconds"]))]
    MEASURED["12c"] = dict(
        arch="qwen3-1.7b", kind="train", seq=2048, batch=4, ranks=4,
        local=False, mode="zero1", sync={}, measured_s=min(world_s[1:]),
        sync_bytes=on["sync_bytes"], exchanges=on["exchanges"],
        peak=max(x["on"]["peak"] for x in res))
    print(f"(c) {' '.join(P12C_ARGV)}; reduced: none")
    print(f"(c) losses {on['losses']}, grad norms {on['gnorm']}; every "
          f"rank's params bitwise equal after every step; kernels off: "
          f"step-0 loss, grad norm and params after step 1 bitwise")
    for r, x in enumerate(res):
        print(f"(c) rank {r}: step seconds "
              f"{[round(t, 4) for t in x['on']['step_seconds']]}, warm "
              f"step 1 of the profiled session {x['warm_ms']:.1f} ms, sync "
              f"bytes {x['on']['sync_bytes'][0]} and {x['on']['exchanges'][0]}"
              f" exchanges per step, fused_round "
              f"{x['on']['counts']['fused_round']} launches, peak "
              f"{x['on']['peak'] / 2**30:.2f} GiB ({smi})")
    rec = {"gnorm": [], "digests": []}

    def on_step(step, sess, metrics):
        rec["gnorm"].append(float(metrics["grad_norm"]))
        rec["digests"].append(digest(sess.params[0]))

    with cut_depth(P12C_CROSS_LAYERS):
        run = trainer.main(argv_with(P12C_ARGV, steps=2), on_step=on_step)
    cross = c["cross"]
    check(run.losses[0] == cross["losses"][0] and
          rec["digests"][1] == cross["digests"][1],
          f"(c) at {P12C_CROSS_LAYERS} layers: 4 processes and 4 virtual "
          f"ranks differ in step 0's loss ({cross['losses'][0]} vs "
          f"{run.losses[0]}) or the params after step 1")
    print(f"(c) at {P12C_CROSS_LAYERS} layers (both worlds; 4 virtual "
          f"ranks of the full depth were not tried on one card): step-0 "
          f"loss {run.losses[0]} and the params after step 1 bitwise "
          f"between 4 processes on 4 cards and 4 virtual ranks on one")
    free_cuda()
    return {k: sum(x["on"]["counts"][k] + x["off"]["counts"][k] +
                   x["cross"]["counts"][k] for x in res) for k in counters()}


def phase_wire_on_cards(smi: str) -> dict:
    res = torchrun(3, "d", "d")
    on = res[0]["on"]
    print(f"(d) {' '.join(P12D_ARGV)}; reduced: none (three ranks of it "
          f"do not fit one card: phase 5 (b) runs EF at p = 2)")
    for r, x in enumerate(res):
        print(f"(d) rank {r}: losses {x['on']['losses']}, grad norm "
              f"{x['on']['gnorm']} (exact {x['exact']['gnorm'][0]}), step "
              f"seconds {[round(t, 4) for t in x['on']['step_seconds']]}, "
              f"sync bytes {x['on']['sync_bytes'][0]}, launches "
              f"{x['on']['counts']}, peak {x['on']['peak'] / 2**30:.2f} GiB "
              f"({smi})")
    print(f"(d) kernels on and off bitwise; step-0 grad norm {on['gnorm'][0]}"
          f" within {WIRE_RTOL} of the exact step's "
          f"{res[0]['exact']['gnorm'][0]}")
    return {k: sum(x["on"]["counts"][k] + x["off"]["counts"][k] +
                   x["exact"]["counts"][k] for x in res) for k in counters()}


def phase_ep_on_cards(smi: str) -> dict:
    from repro_torch.launch import bootstrap
    res = torchrun(4, "e", "e")
    for r, x in enumerate(res):
        print(f"(e) rank {r}: {x['on']['n_layers']} layers, losses "
              f"{x['on']['losses']}, step seconds "
              f"{[round(t, 4) for t in x['on']['step_seconds']]}, launches "
              f"{x['on']['counts']}, exchanges data / model "
              f"{x['on']['exchanges']}, peak {x['on']['peak'] / 2**30:.2f} "
              f"GiB ({smi})")
    print(f"(e) {P12E}; reduced: depth 32 -> {P12E['n_layers']}; kernels on "
          f"and off bitwise on every rank")
    sess = bootstrap.build_session(**EP_SMALL)
    for step in range(EP_SMALL["steps"]):
        bootstrap.run_step(sess, step)
    for g, x in enumerate(res):
        check(digest(sess.params[g]) == x["small"]["digest"],
              f"(e) scaled down: rank {g}'s params differ from the "
              f"in-process 2x2 run's")
    print(f"(e) scaled-down 2x2 (phase 6 (b)'s session): every rank's "
          f"params after {EP_SMALL['steps']} steps bitwise the in-process "
          f"LocalMesh run's; losses {res[0]['small']['losses']}")
    del sess
    free_cuda()
    return {k: sum(x["on"]["counts"][k] + x["off"]["counts"][k] +
                   x["small"]["counts"][k] for x in res) for k in counters()}


def phase_serving_on_cards(smi: str) -> dict:
    """Phase 12 (f): the 2-rank world (ep decode at pe = 2 held against
    phase 10 (e)'s in-process run, the scheduler over it), then the
    4-rank one (ep decode at pe = 4, the fan-out)."""
    two, four = serving_two_cards(smi), serving_four_cards(smi)
    return {k: two[k] + four[k] for k in counters()}


def serving_two_cards(smi: str) -> dict:
    import torch
    from repro_torch.launch import bootstrap
    e = EP_SERVE
    res2 = torchrun(2, "f2", "f2")
    b, s, new = e["batch"], e["prompt"], e["new"]
    sess = bootstrap.build_serve_session(
        arch=e["arch"], max_len=s + new, moe_dispatch="ep",
        ep_devices=e["ep_devices"], n_layers=e["n_layers"], device="cuda")
    prompts = np.random.default_rng(0).integers(
        0, sess.cfg.vocab_size, (b, s)).astype(np.int32)
    tokens, logits = generate_logits(sess.engine, prompts, new)
    want = torch.stack([x.cpu() for x in logits])
    for r, x in enumerate(res2):
        got = torch.load(serve_logits_path("f2", r))
        check(same_bits(got, want) and x["tokens"] == tokens.tolist(),
              f"(f) pe = 2: rank {r}'s logits or tokens differ from phase "
              f"10 (e)'s in-process run")
    local = p12_scheduler(sess.engine, sess.cfg.vocab_size)
    check(local["tokens"] == res2[0]["sched"]["tokens"],
          "(f) the scheduler over the ep engine: tokens over 2 processes "
          "differ from the in-process scheduler's")
    x = res2[0]
    print(f"(f) pe = 2, {e['n_layers']} layers (phase 10 (e)'s config): "
          f"{1 + new} calls' logits and the tokens bitwise the in-process "
          f"run's on both ranks; time to first token {x['ttft_ms']:.1f} ms, "
          f"decode p50 {x['p50']:.3f} ms, p99 {x['p99']:.3f} ms; "
          f"permute_rows {x['counts']['permute_rows']} per rank; peak "
          f"{x['peak'] / 2**30:.2f} GiB ({smi})")
    sc = x["sched"]
    print(f"(f) scheduler over the ep engine (pe = 2, {P12F_SCHED}): "
          f"tokens bitwise the in-process scheduler's; {sc['equal_one_shot']}"
          f" of {sc['total']} equal to one-shot runs alone; decode "
          f"boundaries p50 {sc['p50']:.3f} ms, p99 {sc['p99']:.3f} ms")
    del sess, logits, want
    free_cuda()
    return {k: sum(r["counts"][k] for r in res2) for k in counters()}


def serving_four_cards(smi: str) -> dict:
    res4 = torchrun(4, "f4", "f4")
    x = res4[0]["ep"]
    print(f"(f) pe = 4, {P12F_EP4['n_layers']} layers (reduced: depth 32 -> "
          f"{P12F_EP4['n_layers']}; weights {x['weights']} bytes a rank): "
          f"time to first token {x['ttft_ms']:.1f} ms, decode p50 "
          f"{x['p50']:.3f} ms, p99 {x['p99']:.3f} ms, {x['tok_s']:.1f} tok/s "
          f"warm; peak {x['peak'] / 2**30:.2f} GiB ({smi})")
    check(all(r["ep"]["tokens"] == x["tokens"] for r in res4),
          "(f) pe = 4: ranks' tokens differ")
    secs = max(r["fanout"]["seconds"] for r in res4)
    st = res4[0]["fanout"]
    check(all(r["replica_tokens"] == res4[0]["replica_tokens"]
              for r in res4), "(f) fan-out: replicas' gathered tokens differ")
    print(f"(f) fan-out to {P12F_REPLICAS} replicas over NCCL: "
          f"{st['n_leaves']} leaves, {st['bytes']} bytes, {st['rounds']} "
          f"rounds, {st['exchanges']} exchanges a rank, {secs:.4f} s (the "
          f"slowest rank), {st['bytes'] / secs / 1e9:.2f} GB/s of weights; "
          f"every replica bitwise the source (phase 10 (d): the fan-out "
          f"on one card) ({smi})")
    return {k: sum(r["ep"]["counts"][k] for r in res4) for k in counters()}


def phase_checkpoint_on_cards(smi: str) -> None:
    import shutil
    from repro_torch.launch import train as trainer
    for d in ("ckpt_a", "ckpt_b", "ckpt_c"):
        shutil.rmtree(P12_DIR / d, ignore_errors=True)
    g4 = torchrun(4, "g", "g4")
    g3 = torchrun(3, "g", "g3")
    un, res = g4[0]["uninterrupted"], g4[0]["resumed"]
    check(res == un[2:], f"(g) resumed at 4 ranks {res} vs uninterrupted "
          f"{un}")
    shutil.copytree(P12_DIR / "ckpt_b" / "step_2",
                    P12_DIR / "ckpt_c" / "step_2")
    with cut_depth(P12G_LAYERS):
        ref = trainer.main(argv_with(P12G_ARGV + ["--ckpt-every", "2"],
                                     mesh="3x1",
                                     ckpt_dir=str(P12_DIR / "ckpt_c")))
    check(g3[0]["resumed"] == ref.losses, f"(g) resumed at 3 ranks "
          f"{g3[0]['resumed']} vs the p' run {ref.losses}")
    w = g4[0]["writes"][0]
    print(f"(g) {' '.join(P12G_ARGV)} at {P12G_LAYERS} layers (reduced: "
          f"depth 28 -> {P12G_LAYERS}, global batch 4 -> 12 for p' = 3): "
          f"resumed at 4 ranks bitwise the uninterrupted run ({un}); the "
          f"step-2 checkpoint resumed by 3 ranks bitwise the in-process p' "
          f"run ({ref.losses}); write {w['s']:.2f} s for {w['bytes']} bytes "
          f"by rank 0; restores {[round(t, 2) for t in g4[0]['restores']]} "
          f"s at 4 ranks (rank 0), {[round(t, 2) for t in g3[0]['restores']]}"
          f" s at 3 ({smi})")
    for d in ("ckpt_a", "ckpt_b", "ckpt_c"):
        shutil.rmtree(P12_DIR / d, ignore_errors=True)
    free_cuda()


def phase_multi_card(smi: str, parts: str = "bcdefg") -> dict:
    """Phase 12 (b)-(g) on four cards (the parts named in ``parts``);
    returns the launches on the workload paths, by path."""
    import torch
    check(torch.cuda.device_count() >= P12_CARDS,
          f"phase 12 needs {P12_CARDS} cards, this machine shows "
          f"{torch.cuda.device_count()}")
    t12 = time.perf_counter()
    out = {}
    steps = {"b": phase_collectives_on_links, "c": phase_main_path_on_cards,
             "d": phase_wire_on_cards, "e": phase_ep_on_cards,
             "f": phase_serving_on_cards, "g": phase_checkpoint_on_cards}
    for part in parts:
        t0 = time.perf_counter()
        counts = steps[part](smi)
        if counts is not None:
            out["12" + part] = counts
        print(f"phase 12 ({part}) in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"phase 12 in {time.perf_counter() - t12:.1f} s ({smi})")
    return out


def cards_main() -> int:
    """``python3 chip_smoke.py --cards 4``: phase 1 for every card, then
    phase 12 (b)-(g), phase 14 (c), (d), phase 15 (d), (e), phase 13, the
    kernels line and the verdict."""
    import torch
    check(torch.cuda.device_count() >= P12_CARDS,
          f"--cards {P12_CARDS} needs {P12_CARDS} cards, this machine shows "
          f"{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    smi = phase_card_and_build()
    every = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"cards:\n{every}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True).stdout
    print(f"nvidia-smi topo -m:\n{topo}")
    print(f"NCCL {torch.cuda.nccl.version()}", flush=True)
    by_path = phase_multi_card(smi)
    by_path.update(phase_tp_on_cards(smi))
    by_path.update(phase_tp_families_on_cards(smi))
    by_path.update(phase_tp_more_families_on_cards(smi))
    phase_roofline(smi, mesh="h100x4")
    names = {"fused_round": ("src/repro_torch/csrc/fused_round.cu",
                             "src/repro/kernels/fused_round.py:109"),
             "fused_round_dq": ("src/repro_torch/csrc/fused_round_dq.cu",
                                "src/repro/kernels/fused_round.py:228"),
             "quantize": ("src/repro_torch/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:83"),
             "dequant_add": ("src/repro_torch/csrc/quantize.cu",
                             "src/repro/kernels/quantize.py:131"),
             "block_reduce": ("src/repro_torch/csrc/block_reduce.cu",
                              "src/repro/kernels/block_reduce.py:40"),
             "permute_rows": ("src/repro_torch/csrc/permute_rows.cu",
                              "src/repro/kernels/fused_round.py:319")}
    # the kernels' times, bounds and plain versions are the default run's
    # (phase 2); this mode counts the launches of the phase-12 paths
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(c[n] for c in by_path.values()),
         "launches_by_path": {k: c[n] for k, c in by_path.items()},
         "max_abs_err": None, "ms": None, "plain_ms": None,
         "bound_ms": None, "bound_by": "bytes", "library_ms": None}
        for n, (src, rep) in names.items()]}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    if len(sys.argv) == 3 and sys.argv[1] == RANK_CHILD:
        return rank_child(sys.argv[2])  # pins its own card first
    torch.cuda.set_device(0)
    if sys.argv[1:] == [CARDS, str(P12_CARDS)]:
        return cards_main()
    if len(sys.argv) == 3 and sys.argv[1] == AGAINST:
        return against_report(sys.argv[2])
    t_all = time.perf_counter()
    smi = timed("phase 1", phase_card_and_build)
    max_err, step = timed("phase 2 fused_round", phase_kernel_vs_plain)
    wire_errs, wire = timed("phase 2 wire kernels", phase_wire_kernels)
    br_err, br = timed("phase 2 block_reduce", phase_block_reduce)
    perm_err, perm = timed("phase 2 permute_rows", phase_permute_rows)
    timed("phase 3 collectives", phase_collectives)
    timed("phase 3 wire collectives", phase_wire_collectives)
    timed("phase 3 alltoall", phase_alltoall)
    with Preflight("main path"):
        counts, f32_rs_bytes = timed("phase 4", phase_main_path)
    paths = timed("phase 5", phase_wire_path, f32_rs_bytes)
    ep_a, ep_b = timed("phase 6", phase_ep_path)
    sweep = timed("phase 7 (a)", phase_conformance, smi)
    timed("phase 7 (b)", phase_nonuniform, smi)
    timed("phase 7 (c)", phase_nonuniform_timing, smi)
    t8 = time.perf_counter()
    phase_paper_comparison(smi)
    phase_broadcast_hierarchical(smi)
    print(f"phase 8 (a), (b) in {time.perf_counter() - t8:.1f} s")
    syncs = phase_grad_syncs(smi)
    SECONDS["phase 8"] = round(time.perf_counter() - t8, 1)
    print(f"phase 8 in {SECONDS['phase 8']} s ({smi})")
    t9 = time.perf_counter()
    phase_verifier()
    rowwise = phase_rowwise()
    drill = phase_elastic_drill(smi)
    SECONDS["phase 9"] = round(time.perf_counter() - t9, 1)
    print(f"phase 9 in {SECONDS['phase 9']} s ({smi})")
    serving = timed("phase 10", phase_serving, smi)
    families = timed("phase 11", phase_families, smi)
    launcher = timed("phase 12 (a)", phase_launcher_one_card, smi)
    with p16_counting(p16_jobs()) as counting:
        tensor_parallel = timed("phase 14", phase_tensor_parallel, smi)
        tensor_parallel.update(timed("phase 15", phase_tp_families, smi))
        tensor_parallel.update(timed("phase 16", phase_tp_more_families, smi,
                                     counting))
    timed("phase 13", phase_roofline, smi)
    print(f"seconds by phase: {json.dumps(SECONDS)}")
    print("phase 12 (b)-(g), one rank per card over NCCL (the collectives "
          "on the links, the main path at p = 4, the int8 wire with EF at "
          "p = 3, ep training and serving, the fan-out, checkpoints across "
          "processes), runs under python3 chip_smoke.py --cards 4")
    by_path = {"4": counts, "5a": paths["a"][1], "5b": paths["b"][1],
               "6a": ep_a[1], "6b": ep_b[1], "7a": sweep, **syncs,
               "9b": rowwise, "9c": drill, "10": serving, "11": families,
               "12a": launcher, **tensor_parallel}

    def row(name, source, replaces, st, err):
        n = {path: c[name] for path, c in by_path.items()}
        # ``launches`` counts the workload paths (4 to 6, 8 to 11) only:
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
