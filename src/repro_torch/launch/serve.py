"""Serving launcher of the port, ported from ``repro/launch/serve.py``:
one-shot batched generation, continuous batching, and multi-replica
weight fan-out, on the shared session bootstrap.  Runs on the card
unless asked for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch 8 --prompt-len 2048 --max-new 128

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --scale-down --device cpu --batch 4 --prompt-len 16 --max-new 16

The flags are the reference's plus ``--device``.  ``--max-batch``
switches to the continuous-batching scheduler (paged KV cache sized by
``--kv-block-size``); ``--replicas N`` serves data-parallel over N
replicas whose weights were fanned out through the ``kind="broadcast"``
plan (N virtual ranks of a ``LocalComm``); ``--moe-dispatch ep`` serves
a MoE arch expert parallel over ``--ep-devices`` virtual ranks, with
``--max-batch`` too (one paged cache per rank).  Under torchrun each
process is one of those ranks or replicas, one per card (NCCL) or over
gloo with ``--device cpu``, and ``--ep-devices`` or ``--replicas`` must
equal the world; rank 0 prints::

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch phi3.5-moe-42b-a6.6b --scale-down --device cpu \\
        --moe-dispatch ep --ep-devices 2 --batch 2 --prompt-len 8

Prompts
are drawn from ``np.random.default_rng(0)``, as the reference draws
them, and after them the encoder-decoder family's ``frames`` ``(batch,
prompt_len, d_model)`` or the VLM's ``image_embeds`` ``(batch,
n_image_tokens, d_model)``; those families serve one-shot on one
replica, as in the reference (``--max-batch`` and ``--replicas`` are
refused with them).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..configs import ALIASES
from ..serve import Scheduler
from ..serve.engine import cache_bytes
from . import bootstrap
from . import mesh as meshlib


class ServeRun(NamedTuple):
    """What a run returns: the session, the prompts, the tokens (``(B,
    max_new)``, or ``{rid: tokens}`` with ``--max-batch``), the first
    call's seconds (host clock to device sync), the second call's in the
    one-shot modes (else ``None``), and the scheduler in ``--max-batch``
    mode."""
    session: Any
    prompts: np.ndarray
    tokens: Any
    seconds: float
    steady_seconds: float | None
    scheduler: Any = None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=sorted(ALIASES), required=True)
    ap.add_argument("--scale-down", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "global", "rowwise", "ep"],
                    help="MoE dispatch layout (MoE archs only); 'ep' "
                         "serves with experts split over --ep-devices "
                         "ranks, exchanging dispatch buffers through the "
                         "circulant alltoall plan")
    ap.add_argument("--ep-devices", type=int, default=2,
                    help="ranks for --moe-dispatch ep")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel serving replicas; weights are "
                         "fanned out through the broadcast plan")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="> 0: continuous-batching scheduler with this "
                         "many decode slots (instead of one-shot "
                         "generate)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="paged KV cache block size (--max-batch mode; "
                         "must divide prompt-len + max-new)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def prompts_and_extras(cfg, batch: int, prompt_len: int):
    """The launcher's inputs, drawn from ``default_rng(0)`` in the
    reference's order: ``(batch, prompt_len)`` prompts, then the
    encoder-decoder's ``frames`` ``(batch, prompt_len, d_model)`` or the
    VLM's ``image_embeds`` ``(batch, n_image_tokens, d_model)``."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extras["image_embeds"] = rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return prompts, extras


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(xs) -> str:
    if not len(xs):
        return "n/a"
    a = np.asarray(xs) * 1e3
    return (f"p50 {np.percentile(a, 50):.3f} ms, p99 "
            f"{np.percentile(a, 99):.3f} ms over {a.size}")


def main(argv=None) -> ServeRun:
    args = _parser().parse_args(argv)
    max_len = args.prompt_len + args.max_new
    try:
        sess = bootstrap.build_serve_session(
            arch=args.arch, max_len=max_len, scale_down=args.scale_down,
            temperature=args.temperature, moe_dispatch=args.moe_dispatch,
            ep_devices=args.ep_devices, replicas=args.replicas,
            device=args.device)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        raise SystemExit(str(e)) from e
    cfg, dev = sess.cfg, sess.device
    say = print if sess.proc in (None, 0) else (lambda *a, **k: None)
    say(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}, on {dev}, {meshlib.describe()}")
    if args.replicas > 1:
        st = sess.push_stats
        say(f"broadcast weight fan-out: {st['n_leaves']} leaves, "
            f"{st['bytes']} bytes, {st['rounds']} rounds x "
            f"{args.replicas} replicas, {st['exchanges']} exchanges, "
            f"{st['seconds']:.3f} s")

    prompts, extras = prompts_and_extras(cfg, args.batch, args.prompt_len)
    if extras and args.max_batch > 0:
        raise SystemExit("--max-batch covers decoder-only archs (no "
                         "prefill extras)")
    if extras and args.replicas > 1:
        raise SystemExit("--replicas covers decoder-only archs (batched "
                         "prefill extras don't split)")

    if args.max_batch > 0:
        try:
            sched = Scheduler(sess.engine, max_batch=args.max_batch,
                              kv_block_size=args.kv_block_size)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(str(e)) from e
        say(f"paged KV cache: {sched.kv.num_blocks} blocks of "
            f"{args.kv_block_size} rows, "
            f"{cache_bytes([sched.kv.k, sched.kv.v])} bytes")
        t0 = time.perf_counter()
        rids = [sched.submit(prompts[b], args.max_new)
                for b in range(args.batch)]
        done = sched.run()
        _sync(dev)
        dt = time.perf_counter() - t0
        total = sum(len(done[r]) for r in rids)
        say(f"scheduler: {args.batch} requests, {total} tokens in "
            f"{dt:.2f}s ({total / dt:.1f} tok/s; {sched.n_decode_steps} "
            f"decode steps, {sched.n_prefills} prefills); decode "
            f"boundaries {_ms(sched.boundary_s)}")
        for r in rids[:2]:
            say(f"  req{r}: {done[r][:12].tolist()}")
        return ServeRun(sess, prompts, done, dt, None, sched)

    if args.replicas > 1:
        gen = sess.replica_set.generate
    else:
        def gen(tokens, max_new):
            return sess.engine.generate(tokens, max_new, extras=extras)
    t0 = time.perf_counter()
    out = gen(prompts, args.max_new)
    _sync(dev)
    dt = time.perf_counter() - t0
    say(f"generated {out.shape} in {dt:.2f}s "
        f"({args.batch * args.max_new / dt:.1f} tok/s incl. warm-up); "
        f"cache {sess.engine.timings.get('cache_bytes')} bytes "
        f"({args.batch} x {max_len} positions)")
    for b in range(min(2, args.batch)):
        say(f"  seq{b}: {out[b][:12].tolist()}")
    t0 = time.perf_counter()
    gen(prompts, args.max_new)
    _sync(dev)
    dt2 = time.perf_counter() - t0
    say(f"steady-state: {args.batch * args.max_new / dt2:.1f} tok/s")
    for r, eng in enumerate(sess.replica_set.engines):
        t = eng.timings
        if t:
            say(f"  engine {r}: time to first token "
                f"{t['ttft_s'] * 1e3:.3f} ms; decode steps "
                f"{_ms(t['step_s'])}")
    return ServeRun(sess, prompts, out, dt, dt2)


if __name__ == "__main__":
    main()
