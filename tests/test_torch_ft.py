"""Fault tolerance of the port against the reference's: the watchdog,
failure-plan and elastic-controller scenarios of the reference's
``tests/test_ft.py`` run through BOTH packages with the same injected
clock: the same verdicts, reports (phase names and seconds, retries,
fallbacks, evictions, re-plans) and backoff sleeps, and each holds the
reference test's own assertions.  The ZeRO-1 state's resize and the
launcher's restart drill: ``test_torch_ft_state.py``; the elastic drills
on the CPU against the reference's step: ``test_torch_ft_drill.py``.
"""
import types

import numpy as np
import pytest

import repro.checkpoint as ref_ckpt
import repro.ft as ref_ft
import repro.optim.zero1 as ref_zero1
from repro.core.plan import plan as ref_plan
import repro_torch.checkpoint as port_ckpt
import repro_torch.ft as port_ft
import repro_torch.optim.zero1 as port_zero1
from repro_torch.core.plan import plan as port_plan

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
