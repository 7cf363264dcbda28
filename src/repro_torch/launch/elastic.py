"""Elastic drill harness: injected rank faults → live world resize.
Ported from ``repro/launch/elastic.py``.

A mid-run SHRINK (a rank dies, the survivors continue at p−1) or GROW
(capacity arrives, resume at a larger p) without abandoning the run:
drain to the last step boundary, re-plan every active collective at the
new p (statically verified before any data moves), reshard the ZeRO-1
state, resume.  Runs on the card unless asked for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch qwen3-1.7b \\
        --scale-down --device cpu --steps 9 --world 4 --shrink-at-step 5 \\
        --fail-rank 2 --seq-len 16 --global-batch 12 --ckpt-every 3

The flags are the reference's plus ``--device``; ``--mp M`` runs each
world as a ``D x M`` tensor-parallel mesh and resizes its data axis
(2x2 -> 1x2 with ``--world 2 --mp 2 --shrink-at-step 5``).  The
circulant plans are
what make this cheap: they are round-optimal at ANY p (paper Theorem
1/2), so 4 → 3 is as good a world as 4.

``run_drill`` is the programmatic entry; it returns the pre/post
trajectories, the controller's :class:`~repro_torch.ft.RecoveryReport`
and, with ``compare_ref=True``, an uninterrupted REFERENCE run at p′
restored from the same checkpoint through the same resize path, so the
resumed trajectory can be held against it (f32: bitwise).

Both worlds' ranks are virtual ranks of a ``LocalComm`` on one device,
so the drill never holds two worlds' state at once: the drain frees the
old world's parameters and optimizer state once its checkpoint is on
disk, and the resumed session's are freed before the reference run is
built (only the losses are compared).  On the card it records the peak
memory of each world, and the seconds and bytes of the checkpoint's
write and restores.
"""
from __future__ import annotations

import argparse
import gc
import shutil
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager, config_fingerprint
from ..configs import ALIASES
from ..ft import (ElasticConfig, ElasticController, FailurePlan, FaultEvent,
                  RankFailure, Watchdog, WatchdogConfig, active_specs)
from . import bootstrap
from . import mesh as meshlib


def _ckpt_extra(sess, step: int, arch: str) -> dict:
    return {"data_cursor": step, "config": config_fingerprint(sess.cfg),
            "world": sess.world, "arch": arch}


def _train_range(sess, start: int, stop: int, *, mgr=None, ckpt_every=None,
                 fplan: FailurePlan | None = None, watchdog=None,
                 arch: str = "", out=None) -> list[tuple[int, float]]:
    """Run steps [start, stop) on ``sess``; returns (step, loss) pairs.
    Raises :class:`RankFailure` at the step a ``rank_loss`` fault fires
    (the step does NOT execute — the rank is gone); rows accumulated so
    far survive in the caller-supplied ``out`` list."""
    if out is None:
        out = []
    for step in range(start, stop):
        if fplan is not None:
            fplan.check(step)
        t0 = time.time()
        metrics = bootstrap.run_step(sess, step)
        loss = float(metrics["loss"])  # blocks: the step really ran
        dt = time.time() - t0
        if watchdog is not None:
            slow = fplan.slow_delay(step) if fplan is not None else 0.0
            watchdog.observe(step, dt + slow)
        out.append((step, loss))
        if mgr is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, bootstrap.params_whole(sess),
                           bootstrap.opt_flat(sess),
                           _ckpt_extra(sess, step + 1, arch))
    return out


def _free(sess) -> None:
    """Drop a session's parameters and optimizer state (device memory)."""
    sess.params = sess.opt = None
    gc.collect()
    if sess.device.type == "cuda":
        torch.cuda.empty_cache()


def _peak(dev: torch.device) -> int | None:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def run_drill(*, arch: str = "qwen3-1.7b", scale_down: bool = True,
              steps: int = 9, seq_len: int = 16, global_batch: int = 12,
              world: int = 4, mp: int = 1,
              shrink_at_step: int | None = None, fail_rank: int = 0,
              grow_at_step: int | None = None, grow_to: int | None = None,
              ckpt_every: int = 3, ckpt_dir: str | None = None,
              keep_last: int = 3,
              schedule: str = "halving", wire_dtype: str | None = None,
              lr: float = 1e-3, warmup: int = 2,
              io_faults: int = 0, io_retries: int = 3,
              io_backoff_s: float = 0.01, recovery_deadline_s: float = 600.0,
              slow_link: tuple[int, float, int] | None = None,
              compare_ref: bool = True, device="cuda",
              verbose: bool = False, n_layers: int | None = None) -> dict:
    """One full drill: train at ``world``, resize at the event step,
    resume to ``steps``.  Exactly one of ``shrink_at_step`` /
    ``grow_at_step`` must be given (shrink kills ``fail_rank`` → p−1;
    grow resumes at ``grow_to``).  ``io_faults`` transient checkpoint-IO
    failures are injected at the drain for the controller's retry/backoff
    to absorb; ``keep_last`` is the checkpoints kept.  Returns the
    trajectories, the recovery report, the reference comparison and, per
    world, the peak device memory (``peaks``, ``None`` on the CPU) and
    the checkpoint's write and restore timings (``ckpt``).  ``n_layers``
    cuts the config's depth (no CLI flag: for runs of a full-width config
    on one card).  ``mp > 1`` runs each world as a ``D x mp`` mesh,
    tensor parallel over its model axis (zero1 over the data axis, as
    the reference's drill with ``--mp``): the event resizes the data
    axis, and the checkpoint (the reference's global arrays) is
    resharded onto the new mesh.  Under torchrun it refuses: over
    processes the loss of a rank needs a new communicator of the
    survivors (ROADMAP.md queue 1 item 11.2)."""
    if meshlib.is_process_world():
        raise NotImplementedError(
            "the elastic drill runs its worlds as virtual ranks in one "
            "process; over processes the loss of a rank needs a new "
            "communicator of the survivors, which is not ported (ROADMAP.md "
            "queue 1 item 11.2): run it without torchrun")
    if mp < 1:
        raise ValueError(f"mp must be positive, got {mp}")
    if (shrink_at_step is None) == (grow_at_step is None):
        raise ValueError("give exactly one of shrink_at_step/grow_at_step")
    event_step = shrink_at_step if shrink_at_step is not None \
        else grow_at_step
    if not 0 < event_step < steps:
        raise ValueError(f"event step {event_step} outside (0, {steps})")
    if shrink_at_step is not None:
        new_world = world - 1
        if not 0 <= fail_rank < world:
            raise ValueError(f"fail_rank {fail_rank} outside world {world}")
    else:
        if grow_to is None or grow_to <= world:
            raise ValueError(f"grow needs grow_to > world, got {grow_to}")
        new_world = grow_to

    tmp = None
    if ckpt_dir is None:
        tmp = ckpt_dir = tempfile.mkdtemp(prefix="elastic_drill_")
    try:
        return _run_drill(
            arch=arch, scale_down=scale_down, steps=steps, seq_len=seq_len,
            global_batch=global_batch, world=world, event_step=event_step,
            shrink=shrink_at_step is not None, fail_rank=fail_rank,
            new_world=new_world, mp=mp, ckpt_every=ckpt_every,
            ckpt_dir=ckpt_dir, keep_last=keep_last, schedule=schedule, wire_dtype=wire_dtype,
            lr=lr, warmup=warmup, io_faults=io_faults, io_retries=io_retries,
            io_backoff_s=io_backoff_s,
            recovery_deadline_s=recovery_deadline_s, slow_link=slow_link,
            compare_ref=compare_ref, device=device, verbose=verbose,
            n_layers=n_layers)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _run_drill(*, arch, scale_down, steps, seq_len, global_batch, world,
               event_step, shrink, fail_rank, new_world, mp, ckpt_every,
               ckpt_dir, keep_last, schedule, wire_dtype, lr, warmup,
               io_faults, io_retries, io_backoff_s, recovery_deadline_s,
               slow_link, compare_ref, device, verbose, n_layers) -> dict:
    events = []
    if shrink:
        events.append(FaultEvent(step=event_step, kind="rank_loss",
                                 rank=fail_rank))
    if slow_link is not None:
        s, delay, dur = slow_link
        events.append(FaultEvent(step=s, kind="slow_link", delay_s=delay,
                                 duration=dur))
    fplan = FailurePlan(events=tuple(events))

    stragglers: list[int] = []
    wd = Watchdog(cfg=WatchdogConfig(),
                  on_straggler=lambda step, dt: stragglers.append(step))

    def session_at(w, init_state=True):
        return bootstrap.build_session(
            arch=arch, scale_down=scale_down, steps=steps, seq_len=seq_len,
            global_batch=global_batch, dp=w, mp=mp, mode="zero1",
            schedule=schedule, wire_dtype=wire_dtype, lr=lr, warmup=warmup,
            device=device, init_state=init_state, n_layers=n_layers)

    mgr = CheckpointManager(ckpt_dir, keep_last=keep_last)
    sess = session_at(world)
    dev = sess.device
    _reset_peak(dev)
    peaks = {}
    ckpt = {"restore_s": []}
    ctl = ElasticController(world, ElasticConfig(
        min_world=1, max_world=max(world, new_world),
        io_retries=io_retries, io_backoff_s=io_backoff_s,
        recovery_deadline_s=recovery_deadline_s))

    # -- run at the old world until the event fires --------------------------
    # Shrink: run to `steps`; the injected rank_loss interrupts at the
    # event boundary.  Grow: voluntary resize, stop cleanly there.
    pre: list[tuple[int, float]] = []
    detected_at = event_step
    try:
        _train_range(sess, 0, steps if shrink else event_step, mgr=mgr,
                     ckpt_every=ckpt_every, fplan=fplan, watchdog=wd,
                     arch=arch, out=pre)
        if shrink:
            raise AssertionError("shrink drill never hit its rank_loss")
    except RankFailure as e:
        detected_at = e.step
        if verbose:
            print(f"detected: {e}")

    # -- drain / re-plan / reshard / resume ----------------------------------
    # Transient IO faults target the RECOVERY's own checkpoint IO (the
    # drain save / reshard restore), the surface the controller's bounded
    # retry/backoff owns; armed at step 0 so whichever checkpoint step
    # the recovery touches first trips them.
    io_plan = None
    if io_faults:
        io_plan = FailurePlan(events=(
            FaultEvent(step=0, kind="ckpt_io", duration=io_faults),))
        mgr.io_hook = io_plan.io_hook

    def drain(step):
        mgr.wait()  # surfaces a failed in-flight async save (retried)
        if not shrink and sess.params is not None:
            # Grow is voluntary: every rank is alive, so the boundary
            # checkpoints synchronously — zero steps lost.
            mgr.save(step, bootstrap.params_whole(sess),
                     bootstrap.opt_flat(sess), _ckpt_extra(sess, step, arch))
        latest = mgr.latest_step()
        if latest is None:
            raise FileNotFoundError(f"no checkpoint to drain to in "
                                    f"{ckpt_dir}")
        ckpt["write"] = mgr.last_write
        if sess.params is not None:
            # The checkpoint holds the old world now: free its state
            # before the new world's is built.
            peaks["old"] = _peak(dev)
            _free(sess)
        return latest

    resumed = {}

    def reshard(w):
        # The session build is kept across IO retries (only the restore
        # is the flaky part worth re-running).
        if "sess" not in resumed:
            _reset_peak(dev)
            resumed["sess"] = session_at(w, init_state=False)
        t0 = time.perf_counter()
        step, man = bootstrap.restore_session(resumed["sess"], mgr)
        ckpt["restore_s"].append(time.perf_counter() - t0)
        resumed["step"], resumed["manifest"] = step, man
        return resumed["sess"]

    report, new_sess = ctl.recover(
        detected_at, new_world, active_specs(sess.sync),
        drain=drain, reshard=reshard)
    mgr.io_hook = None  # recovery done; post-resume IO is clean
    resumed_step = resumed["step"]
    assert report.drained == resumed_step

    post = _train_range(new_sess, resumed_step, steps, mgr=mgr,
                        ckpt_every=ckpt_every, arch=arch)
    mgr.wait()
    peaks["new"] = _peak(dev)
    _free(new_sess)

    out = {
        "arch": arch, "world": world, "new_world": new_world,
        "kind": "shrink" if shrink else "grow",
        "event_step": event_step, "detected_at": detected_at,
        "resumed_step": resumed_step,
        "lost_steps": detected_at - resumed_step,
        "pre": pre, "post": post, "report": report,
        "stragglers": stragglers,
        "fired": [ev.kind for ev in fplan.fired]
                 + ([ev.kind for ev in io_plan.fired] if io_plan else []),
        "peaks": peaks, "ckpt": ckpt,
    }

    # -- reference: uninterrupted run at p' from the same checkpoint ---------
    if compare_ref:
        _reset_peak(dev)
        ref_sess = session_at(new_world, init_state=False)
        t0 = time.perf_counter()
        ref_step, _ = bootstrap.restore_session(ref_sess, mgr,
                                                step=resumed_step)
        ckpt["restore_s"].append(time.perf_counter() - t0)
        assert ref_step == resumed_step
        ref = _train_range(ref_sess, ref_step, steps)
        peaks["ref"] = _peak(dev)
        _free(ref_sess)
        # post may have fewer rows than ref (a post-resume checkpoint
        # never truncates it; both cover [resumed_step, steps)).
        assert [s for s, _ in ref] == [s for s, _ in post]
        diffs = [abs(a - b) for (_, a), (_, b) in zip(post, ref)]
        out["ref"] = ref
        out["max_abs_diff"] = max(diffs) if diffs else 0.0
        out["bitwise"] = all(a == b for (_, a), (_, b) in zip(post, ref))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.elastic",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ALIASES), default="qwen3-1.7b")
    ap.add_argument("--scale-down", action="store_true")
    ap.add_argument("--steps", type=int, default=9)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--global-batch", type=int, default=12)
    ap.add_argument("--world", type=int, default=4,
                    help="starting data-parallel world size")
    ap.add_argument("--mp", type=int, default=1,
                    help="model-axis size: the worlds are D x mp meshes, "
                         "tensor parallel over the model axis")
    ap.add_argument("--shrink-at-step", type=int, default=None,
                    help="kill --fail-rank at this step; resume at world-1")
    ap.add_argument("--fail-rank", type=int, default=0)
    ap.add_argument("--grow-at-step", type=int, default=None,
                    help="voluntarily resize to --grow-to at this step")
    ap.add_argument("--grow-to", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--schedule", default="halving")
    ap.add_argument("--wire-dtype", default=None, choices=[None, "int8"])
    ap.add_argument("--io-faults", type=int, default=0,
                    help="transient checkpoint-IO failures injected at the "
                         "drain (absorbed by the controller's retry)")
    ap.add_argument("--no-ref", action="store_true",
                    help="skip the uninterrupted reference comparison")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    try:
        res = run_drill(
            arch=args.arch, scale_down=args.scale_down, steps=args.steps,
            seq_len=args.seq_len, global_batch=args.global_batch,
            world=args.world, mp=args.mp,
            shrink_at_step=args.shrink_at_step, fail_rank=args.fail_rank,
            grow_at_step=args.grow_at_step, grow_to=args.grow_to,
            ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
            schedule=args.schedule, wire_dtype=args.wire_dtype,
            io_faults=args.io_faults, compare_ref=not args.no_ref,
            device=args.device, verbose=True)
    except (RuntimeError, ValueError, NotImplementedError) as e:
        raise SystemExit(str(e)) from e

    rep = res["report"]
    print(f"\n{res['kind']}: world {res['world']} -> {res['new_world']} "
          f"at step {res['event_step']} "
          f"(resumed from step {res['resumed_step']}, "
          f"{res['lost_steps']} step(s) lost)")
    print(f"re-planned {len(rep.replans)} spec(s) in {rep.replan_us:.0f}us "
          f"(all verified), evicted {rep.evicted} stale plan(s), "
          f"absorbed {rep.io_failures} IO fault(s)")
    for s, l in res["pre"] + res["post"]:
        print(f"step {s:4d}  loss {l:.6f}")
    if "ref" in res:
        tag = "bitwise" if res["bitwise"] else \
            f"max |dloss| {res['max_abs_diff']:.3g}"
        print(f"post-resize trajectory vs uninterrupted p' reference: {tag}")
    return res


if __name__ == "__main__":
    main()
