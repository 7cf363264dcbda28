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
   main path's shapes beside its byte bound and the plain version;
3. collectives on the card: circulant reduce-scatter and allreduce of
   64M-element float32 payloads per rank on a ``LocalComm``, p in
   {3, 4, 8}, fused bitwise equal to eager, with exact exchange and
   launch counts;
4. the main path: ``python -m repro_torch.launch.train --arch qwen3-1.7b
   --mesh 3x1 --mode zero1 --grad-sync circulant --steps 4 --seq-len 2048
   --global-batch 3`` (full width, 28 layers, bf16 parameters, random
   weights from seed 0), with the kernel's launches counted over exactly
   that run, then one step each with the kernel on and off from the same
   seed, which must agree bitwise; the kernel-on session then takes one
   unprofiled and one profiled warm step (``torch.profiler``, device
   activity only: device busy and idle share of that step, time by
   kernel).

Prints the card line, one ``{"kernels": [...]}`` JSON line and, last, the
verdict ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)
MAIN_ARGV = ["--arch", "qwen3-1.7b", "--mesh", "3x1", "--mode", "zero1",
             "--grad-sync", "circulant", "--steps", "4", "--seq-len", "2048",
             "--global-batch", "3", "--log-every", "1", "--device", "cuda"]
STEPS, P_MAIN = 4, 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bits(t):
    import torch
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.int32: torch.int32}[t.dtype])


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(bits(a), bits(b))


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
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


def main_path_rounds():
    """Every ``(leaf, lo, nb, next_lo, cols)`` fused_round launch shape of
    one main-path step on one rank (f32 payload, halving at p = 3)."""
    from repro_torch.configs import get_config
    from repro_torch import tree as T
    from repro_torch.core import reduce_scatter_plan
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.zero1 import is_zero_leaf
    rounds = reduce_scatter_plan(P_MAIN)
    out = []
    for path, shape in T.flatten(param_shapes(get_config("qwen3-1.7b"))):
        if not is_zero_leaf(shape, P_MAIN, 1024):
            continue
        ld_pad = shape[0] + (-shape[0]) % P_MAIN
        cols = ld_pad // P_MAIN * math.prod(shape[1:])
        for k, rnd in enumerate(rounds):
            nxt = rounds[k + 1].lo if k + 1 < len(rounds) else rnd.lo
            out.append((".".join(path), rnd.lo, rnd.nblocks, nxt, cols))
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


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def timed_step(step) -> float:
    """Wall milliseconds of ``step()``, host clock to device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profiled_step(step, label: str, unprofiled_ms: float) -> None:
    """Run ``step()`` (one warm main-path step) under ``torch.profiler``,
    recording device activity only (host-op recording would stretch the
    step's wall time several-fold), and print where the device time goes:
    busy vs the same step's wall time (the idle share), time by kernel
    family, and the top kernels.  ``unprofiled_ms`` is the previous
    step's wall time without the profiler, printed beside it to show the
    profiler's own cost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = timed_step(step)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile ({label}): no device events recorded (device time "
              f"not measured)")
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
    families = {"fused_round": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (ms, _) in by_name.items():
        fam = ("fused_round" if "fused_round" in name else
               "gemm" if any(k in name.lower() for k in
                             ("gemm", "nvjet", "xmma", "cutlass", "cublas"))
               else "other")
        families[fam] += ms
    busy_ms = busy_us / 1e3
    print(f"profile ({label}, {P_MAIN} ranks): wall {wall_ms:.1f} ms "
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


def phase_main_path():
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_round
    from repro_torch.launch import bootstrap
    from repro_torch.launch import train as trainer
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.zero1 import is_zero_leaf

    cfg = get_config("qwen3-1.7b")
    n_zero = sum(is_zero_leaf(s, P_MAIN, 1024)
                 for _, s in T.flatten(param_shapes(cfg)))
    print(f"main path: {cfg.name} full width, {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params, {n_zero} zero leaves")
    print("reduced: none (every width and all 28 layers)")
    torch.cuda.reset_peak_memory_stats()
    fused_round.launches = 0
    run = trainer.main(MAIN_ARGV)
    launches = fused_round.launches
    peak = torch.cuda.max_memory_allocated()
    want = STEPS * P_MAIN * n_zero * 2
    check(launches == want, f"fused_round launched {launches} times on the "
          f"main path, expected {want}")
    check(all(math.isfinite(x) for x in run.losses),
          f"non-finite loss {run.losses}")
    print(f"main path: losses {run.losses}")
    print(f"main path: step seconds {[round(t, 4) for t in run.step_seconds]}"
          f" (host clock to device sync)")
    print(f"main path: fused_round launches {launches} "
          f"(= {STEPS} steps x {P_MAIN} ranks x {n_zero} leaves x 2 rounds)")
    print(f"main path: peak memory allocated {peak / 2**30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()

    def one_step(fused):
        sess = bootstrap.build_session(
            arch="qwen3-1.7b", steps=STEPS, seq_len=2048, global_batch=3,
            dp=P_MAIN, mode="zero1", use_fused_kernel=fused, device="cuda")
        return float(bootstrap.run_step(sess, 0)["loss"]), sess

    loss_on, sess = one_step(True)
    snapshot = [(p, t.cpu()) for p, t in T.flatten(sess.params[0])]
    for other in sess.params[1:]:
        for (path, t0_), t in zip(snapshot, T.leaves(other)):
            check(same_bits(t0_, t.cpu()), f"ranks disagree on {path}")
    # Two more steps of this session: step 1 unprofiled, step 2 profiled,
    # so the idle share is read on one warm step against its own wall time.
    wall_1 = timed_step(lambda: bootstrap.run_step(sess, 1))
    profiled_step(lambda: bootstrap.run_step(sess, 2),
                  "warm step 2 of a kernel-on session", wall_1)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    loss_off, sess = one_step(False)
    check(loss_on == run.losses[0], f"step-0 loss {loss_on} != main path's "
          f"{run.losses[0]}")
    check(loss_on == loss_off, f"step-0 loss fused {loss_on} != off {loss_off}")
    for (path, want_t), got in zip(snapshot, T.leaves(sess.params[0])):
        check(same_bits(want_t, got.cpu()),
              f"params after step 1 differ with the kernel off: {path}")
    print("main path: --fused-kernel off gives a bitwise-equal step-0 loss "
          "and bitwise-equal params after step 1")
    del sess, snapshot
    gc.collect()
    torch.cuda.empty_cache()
    return launches, run, peak


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no src/repro_torch: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    t_all = time.perf_counter()
    phase_card_and_build()
    max_err, step = phase_kernel_vs_plain()
    phase_collectives()
    launches, run, peak = phase_main_path()
    print(json.dumps({"kernels": [{
        "name": "fused_round", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_round.cu",
        "replaces": "src/repro/kernels/fused_round.py:109",
        "launches": launches, "max_abs_err": max_err,
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
