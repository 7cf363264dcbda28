"""Training launcher of the port, ported from ``repro/launch/train.py``.

Runs on the card unless asked for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --mesh 3x1 --mode zero1 --grad-sync circulant --steps 4 \\
        --seq-len 2048 --global-batch 3

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --scale-down --device cpu --mesh 3x1 --mode zero1 --steps 2 \\
        --seq-len 16 --global-batch 3 --wire-dtype int8

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3.5-moe-42b-a6.6b --scale-down --device cpu --mesh 2x2 \\
        --mode zero1 --moe-dispatch ep --steps 2 --seq-len 16 \\
        --global-batch 2

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --scale-down --device cpu --mesh 3x1 --mode zero1 --steps 2 \\
        --seq-len 16 --global-batch 3 --bucket-bytes 100000

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --scale-down --device cpu --mesh 3x1 --mode zero1 --steps 6 \\
        --seq-len 16 --global-batch 3 --ckpt-dir /tmp/ck --ckpt-every 2 \\
        --fail-at-step 4      # dies at step 4; rerun without the flag

One rank per process (per card over NCCL, or over gloo with ``--device
cpu``), started by torchrun with the same flags; ``--mesh DxM`` must
hold as many ranks as torchrun starts::

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-1.7b \\
        --mesh 4x1 --mode zero1 --steps 4 --seq-len 2048 --global-batch 4

The flags are the reference's plus ``--device``.
``--grad-sync`` picks the gradient sync: ``circulant`` (the paper's),
the baselines ``ring`` and ``xla`` (the native collectives), or
``allreduce`` (no ZeRO: full optimizer state on every rank).
``--bucket-bytes B`` (circulant only) syncs the gradients in buckets of
about B bytes, the rounds pipelined across buckets.  ``--wire-dtype
int8`` puts the gradient reduce-scatter on the int8 wire (with EF-SGD
residuals unless ``--no-error-feedback``; ``--compress`` is its
deprecated alias).  ``--moe-dispatch ep`` trains a MoE arch expert
parallel over the mesh's model axis (``--mesh DxM``: D·M virtual ranks,
zero1 over D, the dispatch's alltoall over M); ``--moe-dispatch
rowwise`` dispatches each sequence's tokens in a pool of its own.
``--ckpt-dir`` resumes from the newest checkpoint there, if any, and
saves one every ``--ckpt-every`` steps (in the background; restorable at
any world size); ``--fail-at-step N`` injects a crash at step N (the
restart drill: rerun with the same ``--ckpt-dir`` to resume on the same
trajectory).  Each step's time feeds the straggler watchdog, whose
verdict ends the step's log line.  ``--mesh DxM`` with M > 1 and a dense,
MoE (``--moe-dispatch global`` or ``rowwise``: each model rank runs its
experts' slots) or VLM arch trains tensor parallel over the model axis
(zero1 over D, TP over M), and ``--mode fsdp_auto`` trains the
reference's pure-GSPMD mode (blocks over the model axis, and for
qwen1.5-110b, grok-1 and llama-3.2-vision also over the data axis,
gathered a layer at a time; the MoE's global dispatch pools every data
rank's tokens, as the reference's global batch does)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --scale-down --device cpu --mesh 2x2 --steps 3 --seq-len 16 \\
        --global-batch 4 [--mode fsdp_auto]
    # or --arch phi3.5-moe-42b-a6.6b [--moe-dispatch rowwise],
    # grok-1-314b --mode fsdp_auto, llama-3.2-vision-90b, hymba-1.5b,
    # xlstm-125m, whisper-small

A checkpoint holds the reference's global arrays whatever the mesh
and mode (``bootstrap.opt_flat``), so a run resumes from one written
on any ``--mesh DxM`` and mode the reference restores it on: a
tensor-parallel, fsdp_auto or expert-parallel run's too, resharded
(``bootstrap.restore_session``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --scale-down --device cpu --mesh 2x2 --steps 4 --seq-len 16 \
        --global-batch 4 --ckpt-dir /tmp/ck --ckpt-every 2
    # then resume the same run on four data ranks: --mesh 4x1, --steps 6

Under torchrun every process trains its rank; rank 0 prints the log
lines (the loss and grad norm are the global ones, folded in rank order:
the bits of the in-process run of the same flags) and writes the
checkpoints, gathered from every rank; every process reads them to
resume, at the same world or another.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..checkpoint import CheckpointManager, config_fingerprint
from ..configs import ALIASES
from ..ft import FailureInjector, Watchdog
from . import bootstrap
from . import mesh as meshlib


class TrainRun(NamedTuple):
    """What a run returns, per step from ``first_step`` on (0, or the step a
    checkpoint resumed at): losses, wall seconds (each step timed to the
    end of its work on the device), and the bytes and exchanges of the
    gradient and parameter sync (``comm.bytes`` / ``comm.exchanges`` of
    the data axis; 0 in single mode)."""
    losses: list
    step_seconds: list
    sync_bytes: list
    sync_exchanges: list
    first_step: int = 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(ALIASES), required=True)
    ap.add_argument("--scale-down", action="store_true",
                    help="reduced same-family config (CPU runs)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM (data x model); M > 1: tensor parallelism "
                         "(dense archs) or --moe-dispatch ep")
    ap.add_argument("--mode", default=None,
                    choices=[None, "single", "zero1", "fsdp_auto"])
    ap.add_argument("--grad-sync", default="circulant",
                    choices=["circulant", "ring", "xla", "allreduce"])
    ap.add_argument("--schedule", default="halving")
    ap.add_argument("--wire-dtype", default=None, choices=[None, "int8"],
                    help="int8 wire for the circulant gradient "
                         "reduce-scatter (quantize-on-send, fused "
                         "dequant-fold-requant rounds, error feedback)")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the EF-SGD residual for compressed sync")
    ap.add_argument("--compress", default=None, choices=[None, "int8"],
                    help="DEPRECATED alias for --wire-dtype (warns)")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="bucketed, pipelined gradient sync with buckets "
                         "of about this many bytes (circulant only)")
    ap.add_argument("--fused-kernel", default="auto",
                    choices=["auto", "on", "off"],
                    help="fused_round CUDA kernel for every reduce-scatter "
                         "round, or on the int8 wire the quantize and "
                         "fused_round_dq kernels, and permute_rows in the "
                         "MoE dispatch's alltoall (auto = on when the run "
                         "is on the card)")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "global", "rowwise", "ep"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="failure injection (restart drill)")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def build(argv=None):
    """Parse ``argv`` and build the session it asks for: ``(args,
    session)``, as :func:`main` trains it."""
    args = _parser().parse_args(argv)
    if args.ckpt_every < 1:
        raise SystemExit(f"--ckpt-every must be positive, got "
                         f"{args.ckpt_every}")
    if args.fail_at_step is not None and args.fail_at_step < 0:
        raise SystemExit(f"--fail-at-step must be >= 0, got "
                         f"{args.fail_at_step}")
    d, m = (int(x) for x in args.mesh.split("x"))
    try:
        sess = bootstrap.build_session(
            arch=args.arch, scale_down=args.scale_down, steps=args.steps,
            seq_len=args.seq_len, global_batch=args.global_batch,
            dp=d, mp=m, mode=args.mode, grad_sync=args.grad_sync,
            schedule=args.schedule, wire_dtype=args.wire_dtype,
            error_feedback=not args.no_error_feedback,
            compress=args.compress,  # deprecated alias; warns
            use_fused_kernel={"auto": None, "on": True,
                              "off": False}[args.fused_kernel],
            bucket_bytes=args.bucket_bytes, moe_dispatch=args.moe_dispatch,
            lr=args.lr, warmup=args.warmup, device=args.device)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from e
    return args, sess


def main(argv=None, on_step=None) -> TrainRun:
    """Parse ``argv``, build the session, train; returns a :class:`TrainRun`.
    ``on_step(step, sess, metrics)``, when given, is called after each
    step, once the step is timed.  With ``--fail-at-step`` the injected
    crash propagates (``ft.SimulatedFailure``), as a real one would."""
    args, sess = build(argv)
    say = print if sess.lead else (lambda *a, **k: None)
    say(f"{sess.cfg.name}: mesh {args.mesh}, {meshlib.describe()}, on "
        f"{sess.device}")
    start, mgr = 0, None
    try:
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir)
            if mgr.latest_step() is not None:
                start, man = bootstrap.restore_session(sess, mgr)
                say(f"resumed from step {start} "
                    f"(manifest cursor {man.get('data_cursor')})")
        return _loop(args, sess, on_step, start, mgr, say)
    finally:
        if mgr:
            mgr.wait()
        if sess.proc is not None:  # every rank waits for rank 0's write
            import torch.distributed as dist
            dist.barrier()


def _loop(args, sess, on_step, start, mgr, say) -> TrainRun:
    """The step loop of :func:`main` from ``start``."""
    cuda, comm = sess.device.type == "cuda", sess.comm
    injector = FailureInjector(fail_at_step=args.fail_at_step)
    wd = Watchdog()
    losses, times, nbytes, nexch = [], [], [], []
    for step in range(start, args.steps):
        injector.check(step)
        b0 = comm.bytes if comm is not None else 0
        x0 = comm.exchanges if comm is not None else 0
        t0 = time.perf_counter()
        metrics = bootstrap.run_step(sess, step)
        loss = float(metrics["loss"])
        if cuda:
            torch.cuda.synchronize(sess.device)
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        nbytes.append((comm.bytes if comm is not None else 0) - b0)
        nexch.append((comm.exchanges if comm is not None else 0) - x0)
        status = wd.observe(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  {dt * 1e3:.0f}ms "
                f"[{status}]", flush=True)
        if on_step is not None:
            on_step(step, sess, metrics)
        if mgr and (step + 1) % args.ckpt_every == 0:
            # every rank: collectives over the mesh
            params = bootstrap.params_whole(sess)
            opt = bootstrap.opt_flat(sess)
            if sess.lead:
                mgr.save_async(
                    step + 1, params, opt,
                    {"data_cursor": step + 1,
                     "config": config_fingerprint(sess.cfg),
                     "mesh": args.mesh, "arch": args.arch,
                     "world": sess.world})
            del params, opt
    if losses:
        say(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")
    return TrainRun(losses=losses, step_seconds=times, sync_bytes=nbytes,
                    sync_exchanges=nexch, first_step=start)


if __name__ == "__main__":
    main()
