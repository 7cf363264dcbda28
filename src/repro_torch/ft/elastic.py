"""Elastic recovery: detect → drain → re-plan → reshard → resume.
Ported from ``repro/ft/elastic.py``.

The circulant schedules are round-optimal at ANY p (paper Theorem 1/2 —
no power-of-two padding, no rank-count restriction), which makes an
elastic rank-set change cheap: re-planning after losing or gaining ranks
is just ``plan(spec, p=new_world)`` — a trace-time table rebuild, never
a topology rewrite.  :class:`ElasticController` owns that state machine:

``detect``
    A :class:`~repro_torch.ft.failures.RankFailure` (or a real rank loss)
    surfaces at some step; :meth:`ElasticController.propose_world` maps
    the surviving rank set to the next world size, clamped to
    ``[min_world, max_world]``.
``drain``
    Training stops at the LAST STEP BOUNDARY: the caller-supplied
    ``drain`` hook flushes/performs the final checkpoint for the old
    world (bounded retry/backoff absorbs transient
    :class:`~repro_torch.ft.failures.CheckpointIOError`\\ s).
``re-plan``
    Every active :class:`~repro_torch.core.spec.CollectiveSpec` (see
    :func:`active_specs`) is compiled at the new p and pushed through
    the STATIC verifier (``analysis.verify.assert_verified`` — Theorem 1
    partition, delivery, width invariants; microseconds, no device)
    BEFORE any data moves on the new world.  Plans cached for the old
    world are then evicted via ``plan.invalidate(p=old_world)`` (every
    plan of that size: the port's plans name no axis).
``reshard``
    The caller-supplied ``reshard`` hook restores the drained checkpoint
    at the new world — full (gathered) optimizer arrays slice to any p
    (``checkpoint.reshard_flat``), and
    ``optim.zero1.resize_zero1_state`` remaps m/v/EF shards (EF mass
    conservation — see its docstring).  Same retry/backoff budget.
``resume``
    The controller adopts the new world; the caller rebuilds its step
    function and continues.

Everything is driven through injected ``clock``/``sleep`` so the
deadline and backoff machinery is unit-testable without real waiting.
If the recovery deadline passes (or the IO retry budget is exhausted
past it), the controller falls back to a CLEAN RESTART via the caller's
``restart`` hook — the classic kill-and-relaunch drill — rather than
wedging; with no restart hook it raises :class:`ElasticAbort`.

World-size discipline: inside ``repro_torch.ft`` the ONLY source of
truth for the live world is ``ElasticController.world`` — nothing here
reads device counts from the runtime, because during a resize the
runtime's device count and the logical world disagree by construction.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from .failures import CheckpointIOError  # noqa: F401  (re-export convenience)

#: recovery state machine order (report ``phases`` entries follow it).
PHASES = ("drain", "replan", "reshard", "resume")


class ElasticAbort(RuntimeError):
    """Elastic recovery could not complete (deadline passed, IO retry
    budget exhausted past the deadline, or the proposed world is outside
    the configured bounds) and no clean-restart fallback was given."""


@dataclass(frozen=True)
class ElasticConfig:
    """Policy knobs of the recovery state machine.

    ``io_retries`` transient-IO retries (per drain/reshard phase) with
    exponential backoff starting at ``io_backoff_s``;
    ``recovery_deadline_s`` bounds the WHOLE recovery — past it the
    controller falls back to clean restart instead of retrying further.
    """

    min_world: int = 1
    max_world: int | None = None
    io_retries: int = 3
    io_backoff_s: float = 0.05
    recovery_deadline_s: float = 60.0
    verify_plans: bool = True

    def __post_init__(self):
        if self.min_world < 1:
            raise ValueError(f"min_world must be >= 1, got {self.min_world}")
        if self.max_world is not None and self.max_world < self.min_world:
            raise ValueError(
                f"max_world {self.max_world} < min_world {self.min_world}")
        if self.io_retries < 0 or self.io_backoff_s < 0 \
                or self.recovery_deadline_s <= 0:
            raise ValueError("io_retries/io_backoff_s must be >= 0 and "
                             "recovery_deadline_s > 0")


@dataclass(frozen=True)
class ReplanRecord:
    """One spec re-planned at the new world: compile+verify latency in
    microseconds (the quantity the elastic CI gate budgets)."""

    spec: Any
    old_p: int
    new_p: int
    plan_us: float
    verified: bool


@dataclass
class RecoveryReport:
    """What one :meth:`ElasticController.recover` run did.

    ``phases`` lists ``(name, seconds)`` in :data:`PHASES` order;
    ``io_failures`` counts transient IO errors absorbed by retry;
    ``evicted`` is how many old-world plans left the plan cache;
    ``restarted`` flags the clean-restart fallback path.
    """

    trigger_step: int
    old_world: int
    new_world: int
    phases: list = field(default_factory=list)
    replans: tuple = ()
    evicted: int = 0
    io_failures: int = 0
    restarted: bool = False
    drained: Any = None

    @property
    def replan_us(self) -> float:
        """Total re-plan + verify latency (µs) across all specs."""
        return sum(r.plan_us for r in self.replans)

    @property
    def total_s(self) -> float:
        return sum(s for _, s in self.phases)


def active_specs(sync, model_cfg=None, ep_world: int | None = None):
    """The data-axis :class:`CollectiveSpec`\\ s a resize must re-plan.

    Thin funnel over :func:`repro_torch.train.steps.collective_specs` keeping
    only the ``data``-role specs: a data-world resize changes p on the
    data axes, while the MoE ``ep`` axis is a model-parallel axis whose
    size is untouched by it (its plans stay cached and valid).
    """
    from ..train.steps import collective_specs
    return tuple(sp for role, sp in
                 collective_specs(sync, model_cfg, ep_world)
                 if role == "data")


class ElasticController:
    """Drives detect → drain → re-plan → reshard → resume on rank-set
    changes.

    The controller is runtime-agnostic: the caller supplies ``drain``
    (flush/write the boundary checkpoint; returns e.g. the drained
    step), ``reshard`` (restore + remap state at the new world; returns
    the resumed payload) and optionally ``restart`` (clean-restart
    fallback).  ``clock``/``sleep`` are injectable for tests.
    """

    def __init__(self, world: int, cfg: ElasticConfig | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.cfg = cfg or ElasticConfig()
        self._world = world
        self._clock = clock
        self._sleep = sleep
        self.reports: list[RecoveryReport] = []

    @property
    def world(self) -> int:
        """The live logical world size — THE rank-world read inside
        ``repro_torch.ft`` (see the module docstring on why not the
        runtime's device count)."""
        return self._world

    # -- detect --------------------------------------------------------------

    def propose_world(self, lost_ranks: Sequence[int] = ()) -> int:
        """World size after losing ``lost_ranks`` (deduplicated), clamped
        to ``max_world``; raises :class:`ElasticAbort` below
        ``min_world`` — with fewer survivors than that, recovery is not
        allowed to proceed at all."""
        new = self._world - len(set(lost_ranks))
        if self.cfg.max_world is not None:
            new = min(new, self.cfg.max_world)
        if new < self.cfg.min_world:
            raise ElasticAbort(
                f"{len(set(lost_ranks))} rank(s) lost from world "
                f"{self._world}: {new} survivors < min_world "
                f"{self.cfg.min_world}")
        return new

    # -- internal machinery --------------------------------------------------

    @contextlib.contextmanager
    def _phase(self, report: RecoveryReport, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            report.phases.append((name, self._clock() - t0))

    def _check_deadline(self, deadline: float) -> None:
        if self._clock() > deadline:
            raise ElasticAbort(
                f"recovery deadline ({self.cfg.recovery_deadline_s}s) "
                f"exceeded")

    def _retry_io(self, fn: Callable[[], Any], deadline: float,
                  report: RecoveryReport, what: str) -> Any:
        """Run ``fn`` riding out transient checkpoint-IO failures:
        ``io_retries`` retries with exponential backoff, all under the
        recovery deadline.  Retries cover :class:`CheckpointIOError` /
        ``OSError`` and :class:`~repro_torch.checkpoint.CheckpointError`
        (a failed background save surfaces as the latter)."""
        from ..checkpoint import CheckpointError
        last: BaseException | None = None
        for attempt in range(self.cfg.io_retries + 1):
            self._check_deadline(deadline)
            try:
                return fn()
            except (OSError, CheckpointError) as e:
                report.io_failures += 1
                last = e
                if attempt < self.cfg.io_retries:
                    self._sleep(self.cfg.io_backoff_s * (2 ** attempt))
        raise ElasticAbort(
            f"{what} still failing after {self.cfg.io_retries + 1} "
            f"attempts: {last!r}") from last

    # -- re-plan -------------------------------------------------------------

    def replan(self, specs: Sequence[Any], new_world: int,
               report: RecoveryReport | None = None
               ) -> tuple[ReplanRecord, ...]:
        """Compile every spec at ``new_world`` and statically verify it
        BEFORE the new world moves any data; then evict the old world's
        plans from the cache.  Returns the per-spec records (also stored
        on ``report``)."""
        from ..analysis.verify import assert_verified
        from ..core.plan import plan
        recs = []
        for spec in specs:
            t0 = self._clock()
            pl = plan(spec, p=new_world)
            if self.cfg.verify_plans:
                assert_verified(pl)
            recs.append(ReplanRecord(
                spec=spec, old_p=self._world, new_p=new_world,
                plan_us=(self._clock() - t0) * 1e6,
                verified=self.cfg.verify_plans))
        evicted = 0
        if new_world != self._world:
            # A no-op "resize" must not evict the plans just compiled.
            evicted = plan.invalidate(p=self._world)
        if report is not None:
            report.replans = tuple(recs)
            report.evicted = evicted
        return tuple(recs)

    # -- the full state machine ---------------------------------------------

    def recover(self, step: int, new_world: int, specs: Sequence[Any], *,
                drain: Callable[[int], Any],
                reshard: Callable[[int], Any],
                restart: Callable[[], Any] | None = None
                ) -> tuple[RecoveryReport, Any]:
        """Run drain → re-plan → reshard → resume; returns
        ``(report, payload)`` where ``payload`` is ``reshard``'s return
        value (or ``restart``'s on the fallback path).

        ``step`` is the boundary the run drained at (the failure was
        detected during/after it).  World bounds are enforced up front
        and never fall back — a world outside ``[min_world, max_world]``
        is a caller error, not a recoverable fault.
        """
        if new_world < self.cfg.min_world or (
                self.cfg.max_world is not None
                and new_world > self.cfg.max_world):
            raise ElasticAbort(
                f"proposed world {new_world} outside "
                f"[{self.cfg.min_world}, {self.cfg.max_world}]")
        report = RecoveryReport(trigger_step=step, old_world=self._world,
                                new_world=new_world)
        deadline = self._clock() + self.cfg.recovery_deadline_s
        try:
            with self._phase(report, "drain"):
                report.drained = self._retry_io(
                    lambda: drain(step), deadline, report, "drain")
            with self._phase(report, "replan"):
                self._check_deadline(deadline)
                self.replan(specs, new_world, report)
            with self._phase(report, "reshard"):
                payload = self._retry_io(
                    lambda: reshard(new_world), deadline, report, "reshard")
            with self._phase(report, "resume"):
                self._world = new_world
        except ElasticAbort:
            if restart is None:
                self.reports.append(report)
                raise
            # Hard fallback: abandon in-flight recovery, clean restart.
            with self._phase(report, "resume"):
                report.restarted = True
                payload = restart()
                self._world = new_world
        self.reports.append(report)
        return report, payload
