"""Rank-level failure injection for elastic recovery drills, ported from
``repro/ft/failures.py`` (it imports nothing of either framework).

:class:`FailureInjector` raises one step-triggered exception: the
whole-process crash of the classic restart drill.  The
elastic runtime needs rank-LEVEL faults on configurable schedules, so a
:class:`FailurePlan` holds a sequence of :class:`FaultEvent`\\ s:

``rank_loss``
    Rank ``rank`` dies at ``step``: :meth:`FailurePlan.check` raises
    :class:`RankFailure` (once — a dead rank stays dead).  The drill
    harness does NOT catch-and-ignore it; the elastic controller runs
    the drain → re-plan → reshard → resume machine (``ft/elastic.py``).
``slow_link``
    A degraded link adds ``delay_s`` seconds to every step in
    ``[step, step + duration)``: :meth:`FailurePlan.slow_delay` is added
    to the wall time the watchdog observes, so the straggler policy —
    not an exception — is what detects it.
``ckpt_io``
    Transient checkpoint-IO failure: starting at ``step``, the next
    ``duration`` checkpoint I/O operations raise
    :class:`CheckpointIOError` (:meth:`FailurePlan.io_hook` plugs into
    ``CheckpointManager(io_hook=...)``).  Transient by construction —
    the elastic controller's bounded retry/backoff must ride it out.

Exceptions deliberately mirror real failure surfaces: a real SIGKILL is
not catchable either, so the training loop never handles
:class:`RankFailure` itself — only the recovery harness does.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class SimulatedFailure(RuntimeError):
    """Injected whole-process failure (the classic restart drill)."""


class RankFailure(SimulatedFailure):
    """A specific rank died; carries ``rank`` and ``step`` for the
    controller's world-size proposal."""

    def __init__(self, rank: int, step: int):
        super().__init__(f"injected loss of rank {rank} at step {step}")
        self.rank = rank
        self.step = step


class CheckpointIOError(OSError):
    """Transient checkpoint-IO failure (injected or real); the elastic
    controller retries these with bounded backoff."""


_KINDS = ("rank_loss", "slow_link", "ckpt_io")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``rank`` applies to ``rank_loss``;
    ``delay_s``/``duration`` to ``slow_link``; ``duration`` (number of
    consecutive failing IO ops) to ``ckpt_io``."""

    step: int
    kind: str = "rank_loss"
    rank: int = 0
    delay_s: float = 0.0
    duration: int = 1

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {_KINDS}")
        if self.step < 0 or self.duration < 1 or self.delay_s < 0:
            raise ValueError(f"bad fault event {self}")


@dataclass
class FailurePlan:
    """A schedule of :class:`FaultEvent`\\ s driving one drill run.

    Mutable on purpose: fired one-shot events are recorded in ``fired``
    so a recovery that rewinds the step counter does not re-kill the
    same rank, and the transient-IO countdown lives here.
    """

    events: tuple[FaultEvent, ...] = ()
    fired: list = field(default_factory=list)
    _io_remaining: int | None = field(default=None, repr=False)

    def __post_init__(self):
        self.events = tuple(self.events)

    # -- rank loss ----------------------------------------------------------

    def check(self, step: int) -> None:
        """Raise :class:`RankFailure` for a ``rank_loss`` scheduled at
        ``step`` that has not fired yet."""
        for ev in self.events:
            if ev.kind == "rank_loss" and ev.step == step \
                    and ev not in self.fired:
                self.fired.append(ev)
                raise RankFailure(ev.rank, step)

    # -- slow link ----------------------------------------------------------

    def slow_delay(self, step: int) -> float:
        """Extra seconds of step time injected at ``step`` (sum of all
        active ``slow_link`` windows) — add to the duration the watchdog
        observes."""
        return sum(ev.delay_s for ev in self.events
                   if ev.kind == "slow_link"
                   and ev.step <= step < ev.step + ev.duration)

    # -- checkpoint IO ------------------------------------------------------

    def io_hook(self, step: int) -> None:
        """``CheckpointManager(io_hook=...)`` entry point: raise
        :class:`CheckpointIOError` for the next ``duration`` IO
        operations once a ``ckpt_io`` event's step has been reached."""
        for ev in self.events:
            if ev.kind == "ckpt_io" and step >= ev.step \
                    and ev not in self.fired:
                self.fired.append(ev)
                self._io_remaining = (self._io_remaining or 0) + ev.duration
        if self._io_remaining:
            self._io_remaining -= 1
            raise CheckpointIOError(
                f"injected transient checkpoint-IO failure at step {step} "
                f"({self._io_remaining} more to come)")


@dataclass
class FailureInjector:
    """Legacy single-event injector: raises :class:`SimulatedFailure` at
    ``fail_at_step`` — the whole-process crash of the restart drill."""

    fail_at_step: int | None = None

    def check(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
