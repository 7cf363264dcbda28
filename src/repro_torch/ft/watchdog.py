"""Straggler detection + mitigation policy, ported from
``repro/ft/watchdog.py`` (it imports nothing of either framework).

At 1000+ nodes, slow hosts (thermal throttling, failing HBM, network
degradation) stretch every synchronous collective.  The watchdog keeps an
EWMA/EWVAR of step wall-times, flags steps beyond ``k`` sigma, and drives a
policy:

  observe -> {OK, SLOW, STRAGGLER}
  STRAGGLER streaks >= patience  ->  action callback (checkpoint-and-
  rebalance on real deployments; here: the elastic controller's detect
  hook — see ft/elastic.py — and synthetic-trace tests).

Two hard-won details of the baseline update rule:

* SLOW/STRAGGLER steps never feed the EWMA (a degraded step must not
  drag the healthy baseline up), so a LEGITIMATE regime shift — e.g. the
  schedule switch a straggler action itself performs — would otherwise
  flag every subsequent step forever.  After ``on_straggler`` fires the
  watchdog therefore RE-BASELINES: statistics reset and the warmup
  window re-learns the new regime.
* The EWVAR after a constant-duration warmup is ~0, so the first
  micro-jitter step would z-score to infinity.  The z-score's sigma is
  floored at ``min_rel_sigma`` of the current mean.

A complementary knob it can pull on a live system: switch the grad-sync
schedule (Corollary 2) — e.g. from 'halving' to 'sqrt' — trading more,
smaller rounds for less per-round payload so a slow link hurts each round
less; the launcher re-plans with the new schedule at the next checkpoint
boundary (a plan is compiled once per schedule).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class WatchdogConfig:
    alpha: float = 0.1          # EWMA smoothing
    sigma_slow: float = 2.0     # flag threshold
    sigma_straggler: float = 4.0
    patience: int = 3           # straggler streak before action
    warmup: int = 5             # steps ignored (compile etc.)
    min_rel_sigma: float = 0.05  # z-score sigma floor, as a fraction of the
    #                              mean — guards the near-zero-variance
    #                              warmup exit (constant-duration warmups
    #                              would otherwise z-score jitter to inf)


@dataclass
class Watchdog:
    cfg: WatchdogConfig = field(default_factory=WatchdogConfig)
    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    streak: int = 0
    events: list = field(default_factory=list)
    rebaselines: list = field(default_factory=list)
    on_straggler: Callable[[int, float], None] | None = None

    def rebaseline(self, step: int | None = None) -> None:
        """Drop the learned baseline and re-enter warmup.

        Called automatically after ``on_straggler`` fires (the action —
        schedule switch, rank drain, elastic re-plan — changes the step-
        time regime on purpose, so the old EWMA is stale by design);
        also callable by the elastic controller after a resume at a new
        world size.
        """
        self.mean = 0.0
        self.var = 0.0
        self.count = 0
        self.streak = 0
        if step is not None:
            self.rebaselines.append(step)

    def observe(self, step: int, dt: float) -> str:
        self.count += 1
        if self.count <= self.cfg.warmup:
            self.mean = dt if self.count == 1 else self.mean
            self.mean += self.cfg.alpha * (dt - self.mean)
            self.var += self.cfg.alpha * ((dt - self.mean) ** 2 - self.var)
            return "WARMUP"
        sd = max(self.var, 1e-12) ** 0.5
        sd = max(sd, self.cfg.min_rel_sigma * abs(self.mean))
        z = (dt - self.mean) / sd if sd > 0 else 0.0
        if z > self.cfg.sigma_straggler:
            status = "STRAGGLER"
            self.streak += 1
            self.events.append((step, dt, z))
            if self.streak >= self.cfg.patience and self.on_straggler:
                self.on_straggler(step, dt)
                # The action changed the regime on purpose — re-learn it
                # instead of flagging every post-action step forever.
                self.rebaseline(step)
        elif z > self.cfg.sigma_slow:
            status = "SLOW"
            self.streak = 0
        else:
            status = "OK"
            self.streak = 0
            # only update baseline with healthy steps
            self.mean += self.cfg.alpha * (dt - self.mean)
            self.var += self.cfg.alpha * ((dt - self.mean) ** 2 - self.var)
        return status
