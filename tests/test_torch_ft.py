"""Fault tolerance of the port against the reference's.

* the watchdog, failure-plan and elastic-controller scenarios of the
  reference's ``tests/test_ft.py`` run through BOTH packages with the
  same injected clock: the same verdicts, reports (phase names and
  seconds, retries, fallbacks, evictions, re-plans) and backoff sleeps,
  and each holds the reference test's own assertions;
* ``resize_zero1_state`` is bitwise the reference's on the same numpy
  global state, p -> p' for (4, 3), (3, 4), (2, 5), (5, 2), without and
  with EF residuals, and p -> p' -> p is lossless (EF: mass conserved);
* the scaled-down drill (qwen3-1.7b, 8 steps, checkpoints every 3) on
  the CPU: shrink 4 -> 3 and grow 3 -> 4 exact, and shrink 4 -> 3 on the
  int8 wire with EF.  The post-resume losses are bitwise the p'
  reference run's (f32), within 0.05 of it and of the exact drill's
  (int8 + EF, the reference's gate).  The params after the first
  resumed step, restored from the drill's checkpoint, are held against
  the reference's ``zero1_step`` driven directly at p' from the same
  checkpoint read and resized by the reference (worker
  ``_torch_elastic_ref.py``, 4 fake CPU devices): loss 1e-5, params
  ``rtol=1e-5`` with ``atol=1e-9`` exact and, on the int8 wire, a tenth
  of the step's learning rate (``test_torch_zero1.py``'s rule, which
  gives its 6e-6 at lr 6e-5; here lr is 1e-3, and one element of 16,384
  lands 1.75e-5 apart);
* the launcher's restart drill (``--ckpt-dir --ckpt-every
  --fail-at-step``) resumes on the uninterrupted run's trajectory.
"""
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.ft as ref_ft
import repro.optim.zero1 as ref_zero1
from repro.core.plan import plan as ref_plan
import repro_torch.checkpoint as port_ckpt
import repro_torch.ft as port_ft
import repro_torch.optim.zero1 as port_zero1
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.plan import plan as port_plan
from repro_torch.launch import bootstrap, train
from repro_torch.launch.elastic import run_drill
from repro_torch.optim import adamw

HERE = os.path.dirname(os.path.abspath(__file__))
REF = types.SimpleNamespace(ft=ref_ft, ckpt=ref_ckpt, zero1=ref_zero1,
                            clear=ref_plan.clear)
PORT = types.SimpleNamespace(ft=port_ft, ckpt=port_ckpt, zero1=port_zero1,
                             clear=port_plan.invalidate)


# ---------------------------------------------------------------------------
# Watchdog and failure plans: the same traces through both packages
# ---------------------------------------------------------------------------

def _watch(ft, cfg_kw, trace):
    actions = []
    wd = ft.Watchdog(cfg=ft.WatchdogConfig(**cfg_kw),
                     on_straggler=lambda s, dt: actions.append(s))
    statuses = [wd.observe(step, dt) for step, dt in enumerate(trace)]
    return statuses, actions, wd.events, wd.rebaselines, wd.mean, wd.var


def _stragglers():
    rng = np.random.default_rng(0)
    dts = [1.0 + 0.01 * rng.standard_normal() for _ in range(40)]
    return [3.0 if s in (20, 21, 22, 23) else dt for s, dt in enumerate(dts)]


def _regime_shift():
    return [(2.5 if s >= 15 else 1.0) + 0.001 * ((s * 7919) % 13 - 6)
            for s in range(40)]


WATCH = {
    "stragglers": (dict(warmup=3, patience=2), _stragglers()),
    "warmup_spike": (dict(warmup=5), [30.0] + [1.0] * 9),
    "rebaseline": (dict(warmup=3, patience=2), _regime_shift()),
    "sigma_floor": (dict(warmup=5), [1.0] * 5 + [1.02]),
}


@pytest.mark.parametrize("name", sorted(WATCH))
def test_watchdog_matches_reference(name):
    cfg_kw, trace = WATCH[name]
    got = _watch(port_ft, cfg_kw, trace)
    assert got == _watch(ref_ft, cfg_kw, trace)
    statuses, actions, _, rebase, _, _ = got
    if name == "stragglers":
        assert "STRAGGLER" in statuses and actions and statuses[30] == "OK"
    elif name == "warmup_spike":
        assert "STRAGGLER" not in statuses[:5]
    elif name == "rebaseline":
        post = statuses[rebase[0] + 3 + 2:]
        assert actions and rebase and post and all(s == "OK" for s in post)
    else:
        assert statuses[-1] == "OK"


def _plan_events(ft):
    out = []
    fp = ft.FailurePlan(events=(ft.FaultEvent(step=3, kind="rank_loss",
                                              rank=2),))
    fp.check(2)
    try:
        fp.check(3)
    except ft.RankFailure as e:
        out.append(("rank_loss", e.rank, e.step))
    fp.check(3)  # a dead rank stays dead
    out.append(len(fp.fired))
    fp = ft.FailurePlan(events=(
        ft.FaultEvent(step=4, kind="slow_link", delay_s=0.5, duration=3),
        ft.FaultEvent(step=5, kind="slow_link", delay_s=0.25, duration=1)))
    out.append([fp.slow_delay(s) for s in range(3, 8)])
    fp = ft.FailurePlan(events=(ft.FaultEvent(step=2, kind="ckpt_io",
                                              duration=2),))
    for s in (1, 3, 3, 3):
        try:
            fp.io_hook(s)
            out.append("ok")
        except ft.CheckpointIOError:
            out.append("io")
    for bad in (dict(step=1, kind="meteor_strike"), dict(step=-1),
                dict(step=0, kind="slow_link", delay_s=-1.0)):
        try:
            ft.FaultEvent(**bad)
            out.append("accepted")
        except ValueError:
            out.append("refused")
    inj = ft.FailureInjector(fail_at_step=2)
    inj.check(1)
    try:
        inj.check(2)
    except ft.SimulatedFailure:
        out.append("crash")
    return out


def test_failure_plans_match_reference():
    got = _plan_events(port_ft)
    assert got == _plan_events(ref_ft)
    assert got == [("rank_loss", 2, 3), 1, [0.0, 0.5, 0.75, 0.5, 0.0],
                   "ok", "io", "io", "ok", "refused", "refused", "refused",
                   "crash"]


# ---------------------------------------------------------------------------
# The elastic controller with a fake clock, through both packages
# ---------------------------------------------------------------------------

class FakeTime:
    """Injectable clock/sleep: sleep() advances the clock and records."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def clock(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def _summary(ft, ctl, clock, outcome):
    rep = ctl.reports[-1] if ctl.reports else None
    return {
        "outcome": outcome, "world": ctl.world, "sleeps": clock.sleeps,
        "n_reports": len(ctl.reports),
        "report": None if rep is None else (
            rep.trigger_step, rep.old_world, rep.new_world, rep.phases,
            rep.evicted, rep.io_failures, rep.restarted, rep.drained,
            [(r.old_p, r.new_p, r.verified, r.plan_us)
             for r in rep.replans])}


def _scenario(pkg, name):
    ft = pkg.ft
    clock = FakeTime()
    # evictions count what the cache holds: start both packages empty (the
    # port evicts every plan of the old size, the reference only those of
    # its axis name)
    pkg.clear()

    def ctl_of(world=4, **kw):
        return ft.ElasticController(world, ft.ElasticConfig(**kw),
                                    clock=clock.clock, sleep=clock.sleep)

    def io_error(msg):
        return ft.CheckpointIOError(msg)

    if name == "config_validation":
        out = []
        for kw in (dict(min_world=0), dict(min_world=4, max_world=2),
                   dict(recovery_deadline_s=0.0)):
            try:
                ft.ElasticConfig(**kw)
                out.append("accepted")
            except ValueError:
                out.append("refused")
        return out
    if name == "propose_world":
        ctl = ctl_of(world=8, min_world=4, max_world=6)
        out = [ctl.propose_world([3]), ctl.propose_world([1, 2, 1, 2]),
               ctl.propose_world([0, 1, 2, 3])]
        try:
            ctl.propose_world([0, 1, 2, 3, 4])
        except ft.ElasticAbort:
            out.append("abort")
        return out
    if name == "retry_backoff":
        ctl = ctl_of(io_retries=3, io_backoff_s=0.1)
        attempts = []

        def drain(step):
            attempts.append(step)
            if len(attempts) < 3:
                raise io_error("flaky mount")
            return step

        _, payload = ctl.recover(6, 3, [], drain=drain,
                                 reshard=lambda w: f"resharded@{w}")
        return _summary(ft, ctl, clock, payload)
    if name == "exhausted_restart":
        ctl = ctl_of(io_retries=1, io_backoff_s=0.01)

        def bad(w):
            raise io_error("disk on fire")

        _, payload = ctl.recover(3, 2, [], drain=lambda s: s, reshard=bad,
                                 restart=lambda: "clean-restart")
        return _summary(ft, ctl, clock, payload)
    if name == "deadline_restart":
        ctl = ctl_of(recovery_deadline_s=5.0)

        def slow_drain(step):
            clock.now += 10.0  # blows the whole-recovery deadline
            return step

        _, payload = ctl.recover(3, 3, [], drain=slow_drain,
                                 reshard=lambda w: "never reached",
                                 restart=lambda: "restarted")
        return _summary(ft, ctl, clock, payload)
    if name == "abort_no_restart":
        ctl = ctl_of(io_retries=0)

        def gone(s):
            raise io_error("gone")

        try:
            ctl.recover(3, 3, [], drain=gone, reshard=lambda w: w)
            outcome = "recovered"
        except ft.ElasticAbort:
            outcome = "abort"
        return _summary(ft, ctl, clock, outcome)
    if name == "out_of_bounds":
        ctl = ctl_of(min_world=2, max_world=6)
        out = []
        for bad in (1, 7):
            try:
                ctl.recover(0, bad, [], drain=lambda s: s,
                            reshard=lambda w: w, restart=lambda: "no")
                out.append("recovered")
            except ft.ElasticAbort:
                out.append("abort")
        return out, _summary(ft, ctl, clock, None)
    if name == "background_ckpt_error":
        ctl = ctl_of(world=2, io_retries=2, io_backoff_s=0.0)
        calls = []

        def drain(step):
            calls.append(step)
            if len(calls) == 1:
                raise pkg.ckpt.CheckpointError(step, OSError("bg write died"))
            return step

        _, payload = ctl.recover(4, 1, [], drain=drain, reshard=lambda w: w)
        return _summary(ft, ctl, clock, payload)
    if name in ("replan_evicts", "replan_noop"):
        specs = ft.active_specs(pkg.zero1.GradSyncConfig())
        new = 3 if name == "replan_evicts" else 4
        if name == "replan_evicts":
            for sp in specs:  # warm the cache at the old world
                if pkg is REF:
                    ref_plan(sp, p=4, axis_name="data")
                else:
                    port_plan(sp, p=4)
        ctl = ctl_of()
        _, payload = ctl.recover(5, new, specs, drain=lambda s: s,
                                 reshard=lambda w: w)
        pkg.clear()
        return len(specs), len(set(specs)), _summary(ft, ctl, clock, payload)
    raise KeyError(name)


SCENARIOS = ("config_validation", "propose_world", "retry_backoff",
             "exhausted_restart", "deadline_restart", "abort_no_restart",
             "out_of_bounds", "background_ckpt_error", "replan_evicts",
             "replan_noop")


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_matches_reference(name):
    got = _scenario(PORT, name)
    assert got == _scenario(REF, name)
    phases = ["drain", "replan", "reshard", "resume"]
    if name == "config_validation":
        assert got == ["refused"] * 3
    elif name == "propose_world":
        assert got == [6, 6, 4, "abort"]
    elif name == "retry_backoff":
        assert got["outcome"] == "resharded@3" and got["world"] == 3
        assert got["sleeps"] == [0.1, 0.2]
        assert [n for n, _ in got["report"][3]] == phases
        assert got["report"][5:8] == (2, False, 6)
    elif name == "exhausted_restart":
        assert got["outcome"] == "clean-restart" and got["world"] == 2
        assert got["report"][5:7] == (2, True)
    elif name == "deadline_restart":
        assert got["outcome"] == "restarted" and got["report"][6]
    elif name == "abort_no_restart":
        assert got["outcome"] == "abort" and got["world"] == 4
        assert got["report"][5] == 1
    elif name == "out_of_bounds":
        assert got[0] == ["abort", "abort"] and got[1]["n_reports"] == 0
    elif name == "background_ckpt_error":
        assert got["report"][5] == 1 and got["report"][7] == 4
    elif name == "replan_evicts":
        n, distinct, s = got
        assert n == 2 and distinct == 1  # rs_spec == ag_spec by default
        assert s["report"][4] == distinct
        assert all(r[:3] == (4, 3, True) for r in s["report"][8])
    else:
        assert got[2]["report"][4] == 0  # a no-op resize keeps its plans


def test_active_specs_are_the_data_role_specs():
    from repro_torch.train.steps import collective_specs
    sync = port_zero1.GradSyncConfig()
    assert set(port_ft.active_specs(sync)) == {
        sp for role, sp in collective_specs(sync) if role == "data"}


# ---------------------------------------------------------------------------
# resize_zero1_state: bitwise the reference's on the same global state
# ---------------------------------------------------------------------------

SHAPES = {"big": (10, 128), "tiny": (4,), "scalar": ()}


def _global_state(world, with_ef, min_numel=1024):
    """A synthetic GLOBAL state at ``world`` as numpy trees: zero leaves
    padded to the world multiple with zero rows, EF one row per rank."""
    rng = np.random.default_rng(world)

    def mv(shape):
        arr = rng.normal(size=shape).astype(np.float32)
        if port_zero1.is_zero_leaf(shape, world, min_numel):
            pad = (-shape[0]) % world
            arr = np.concatenate([arr, np.zeros((pad, *shape[1:]),
                                                np.float32)])
        return arr

    m = {k: mv(s) for k, s in SHAPES.items()}
    v = {k: mv(s) for k, s in SHAPES.items()}
    ef = None
    if with_ef:
        ef = {k: rng.normal(size=(world if port_zero1.is_zero_leaf(
            s, world, min_numel) else 1, *s)).astype(np.float32)
            for k, s in SHAPES.items()}
    return m, v, ef


def _resize(pkg, m, v, ef, world, sync_kw):
    sync = pkg.zero1.GradSyncConfig(**sync_kw)
    if pkg is REF:
        params = {k: jnp.zeros(s) for k, s in SHAPES.items()}
        state = ref_zero1.Zero1State(
            m={k: jnp.asarray(a) for k, a in m.items()},
            v={k: jnp.asarray(a) for k, a in v.items()},
            step=jnp.asarray(7, jnp.int32),
            ef=None if ef is None else {k: jnp.asarray(a)
                                        for k, a in ef.items()})
    else:
        params = {k: torch.zeros(s) for k, s in SHAPES.items()}
        state = port_zero1.Zero1State(m=m, v=v, step=7, ef=ef)
    out = pkg.zero1.resize_zero1_state(state, params, world, sync)
    conv = lambda t: None if t is None else {  # noqa: E731
        k: np.asarray(a) for k, a in t.items()}
    return conv(out.m), conv(out.v), conv(out.ef), int(out.step)


def _same(a, b):
    assert (a is None) == (b is None)
    for k in a or {}:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("ef", [False, True], ids=["f32", "ef"])
@pytest.mark.parametrize("p,p2", [(4, 3), (3, 4), (2, 5), (5, 2)])
def test_resize_matches_reference_and_round_trips(p, p2, ef):
    sync_kw = dict(wire_dtype="int8") if ef else {}
    m, v, e = _global_state(p, ef)
    got = _resize(PORT, m, v, e, p2, sync_kw)
    want = _resize(REF, m, v, e, p2, sync_kw)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    assert got[3] == want[3] == 7
    assert got[0]["big"].shape[0] % p2 == 0
    back = _resize(PORT, *got[:3], p, sync_kw)
    _same(back[0], m)
    _same(back[1], v)
    if ef:
        for k in e:  # mass conserved into row 0, at p' and back at p
            np.testing.assert_array_equal(got[2][k].sum(0), e[k].sum(0))
            np.testing.assert_array_equal(got[2][k][1:], 0.0)
            np.testing.assert_array_equal(back[2][k].sum(0), e[k].sum(0))


def test_resize_refuses_to_drop_ef_mass():
    m, v, e = _global_state(4, True)
    with pytest.raises(ValueError):
        _resize(PORT, m, v, e, 2, {})


# ---------------------------------------------------------------------------
# The scaled-down drill on the CPU, held against the reference's step
# ---------------------------------------------------------------------------

COMMON = dict(arch="qwen3-1.7b", scale_down=True, steps=8, seq_len=16,
              global_batch=12, ckpt_every=3, device="cpu")
#: tag -> (run_drill kwargs, world, new world)
DRILLS = {"shrink": (dict(world=4, shrink_at_step=5, fail_rank=2), 4, 3),
          "grow": (dict(world=3, grow_at_step=4, grow_to=4), 3, 4),
          "shrink_int8": (dict(world=4, shrink_at_step=5, fail_rank=2,
                               wire_dtype="int8", io_faults=1), 4, 3)}


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Every drill, its checkpoints kept; then the reference's first step
    after each resize from the same checkpoint (one worker)."""
    root = tmp_path_factory.mktemp("drills")
    res, runs = {}, []
    for tag, (kw, world, new) in DRILLS.items():
        d = str(root / tag)
        res[tag] = r = run_drill(ckpt_dir=d, **COMMON, **kw)
        runs.append({"tag": tag, "ckpt_dir": d, "step": r["resumed_step"],
                     "world": world, "new_world": new,
                     "wire_dtype": kw.get("wire_dtype"),
                     "steps": COMMON["steps"], "lr": 1e-3, "warmup": 2,
                     "global_batch": COMMON["global_batch"],
                     "seq_len": COMMON["seq_len"]})
    with open(root / "in.json", "w") as f:
        json.dump(runs, f)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the worker sets its own device count
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_elastic_ref.py"),
         str(root / "in.json"), str(root / "out.npz")],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return res, runs, dict(np.load(root / "out.npz"))


@pytest.mark.parametrize("tag", sorted(DRILLS))
def test_drill_resumes_on_the_reference_trajectory(drills, tag):
    res = drills[0][tag]
    rep = res["report"]
    assert not rep.restarted and rep.replans
    assert all(r.verified and r.new_p == res["new_world"]
               for r in rep.replans)
    assert [n for n, _ in rep.phases] == ["drain", "replan", "reshard",
                                          "resume"]
    assert [s for s, _ in res["post"]] == list(range(res["resumed_step"], 8))
    if tag == "grow":
        assert res["lost_steps"] == 0 and res["resumed_step"] == 4
    else:
        assert res["resumed_step"] == 3 and res["lost_steps"] == 2
        assert rep.evicted >= 1
    if tag == "shrink_int8":
        assert rep.io_failures == 1 and "ckpt_io" in res["fired"]
        assert res["max_abs_diff"] <= 0.05
        exact = drills[0]["shrink"]["post"]
        assert max(abs(a - b) for (_, a), (_, b)
                   in zip(res["post"], exact)) <= 0.05
    else:
        assert res["bitwise"], (res["post"], res["ref"])


@pytest.mark.parametrize("tag", sorted(DRILLS))
def test_first_resumed_step_matches_reference_step(drills, tag):
    _, runs, ref = drills
    run = next(r for r in runs if r["tag"] == tag)
    sess = bootstrap.build_session(
        arch="qwen3-1.7b", scale_down=True, steps=8, seq_len=16,
        global_batch=12, dp=run["new_world"], mode="zero1",
        wire_dtype=run["wire_dtype"], lr=1e-3, warmup=2, device="cpu",
        init_state=False)
    step, man = bootstrap.restore_session(sess, CheckpointManager(
        run["ckpt_dir"]), step=run["step"])
    assert step == run["step"] and man["world"] == run["world"]
    loss = float(bootstrap.run_step(sess, step)["loss"])
    assert abs(loss - float(ref[f"{tag}/loss"])) <= 1e-5
    # the resumed drill's own first loss is this one
    assert drills[0][tag]["post"][0] == (step, loss)
    # int8 wire: a tenth of this step's learning rate, the rule behind
    # test_torch_zero1.py's 6e-6 (there at lr 6e-5): below any update a
    # code that moved a grid step would flip.
    lr = float(adamw.lr_at(sess.opt_cfg, sess.opt[0].step))
    atol = lr / 10 if run["wire_dtype"] else 1e-9
    for path, t in T.flatten(sess.params[0]):
        np.testing.assert_allclose(t.numpy(), ref[tag + "/" + "/".join(path)],
                                   rtol=1e-5, atol=atol,
                                   err_msg=".".join(path))


# ---------------------------------------------------------------------------
# The launcher's restart drill
# ---------------------------------------------------------------------------

def test_launcher_restart_drill(tmp_path):
    argv = ["--arch", "qwen3-1.7b", "--scale-down", "--device", "cpu",
            "--mesh", "3x1", "--mode", "zero1", "--steps", "6",
            "--seq-len", "16", "--global-batch", "3", "--wire-dtype", "int8"]
    straight = train.main(argv)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    with pytest.raises(port_ft.SimulatedFailure):
        train.main(argv + ck + ["--fail-at-step", "5"])
    assert CheckpointManager(str(tmp_path / "ck")).completed_steps() == [
        2, 4]
    tail = train.main(argv + ck)
    assert tail.first_step == 4 and len(tail.losses) == 2
    assert tail.losses == straight.losses[4:]
