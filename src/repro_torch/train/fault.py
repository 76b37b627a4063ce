"""Fault tolerance: straggler detection + failure simulation + recovery
policy.

Counterpart of ``repro/train/fault.py`` (host code, copied).  On a
1000+-node fleet the loop must survive (a) node loss — recover from
the last checkpoint, possibly on a smaller mesh (elastic downscale), and
(b) stragglers — detect per-step time outliers and react.  This module
provides the host-side machinery; the integration lives in
launch/train.py, exercised with *injected* failures.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class FaultConfig:
    fail_at_steps: tuple = ()        # injected hard failures (raise)
    straggle_at_steps: tuple = ()    # injected slow steps
    straggle_factor: float = 5.0
    z_threshold: float = 3.0         # straggler detection z-score
    window: int = 32


class StragglerDetector:
    """Rolling z-score over per-step wall times.  On real fleets the same
    statistic runs per-host over collective-completion times; here it runs
    over the single-process step time (the algorithm is what is tested)."""

    def __init__(self, window: int = 32, z_threshold: float = 3.0):
        self.times = deque(maxlen=window)
        self.z = z_threshold
        self.flagged: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            mu = float(np.mean(self.times))
            sd = float(np.std(self.times)) + 1e-9
            if (dt - mu) / sd > self.z:
                is_straggler = True
                self.flagged.append((step, dt, mu))
        # straggler steps are excluded from the baseline window
        if not is_straggler:
            self.times.append(dt)
        return is_straggler


class InjectedFailure(RuntimeError):
    pass


def simulate_failures(step: int, cfg: FaultConfig):
    """Call at the top of each step; raises InjectedFailure on configured
    steps and sleeps on configured straggle steps."""
    if step in cfg.fail_at_steps:
        raise InjectedFailure(f"injected node failure at step {step}")
    if step in cfg.straggle_at_steps:
        time.sleep(0.05 * cfg.straggle_factor)


def run_with_recovery(run_fn: Callable[[Optional[int]], int],
                      max_restarts: int = 3,
                      checkpoint_dir: Optional[str] = None) -> int:
    """Supervisor loop: run_fn(resume_step) runs until completion or raises;
    on failure it is restarted from the latest checkpoint.  Returns the
    final step.  run_fn returns the last completed step.

    With ``checkpoint_dir``, the restart signal is the explicit
    ``latest_step(checkpoint_dir)`` (None when no checkpoint exists yet —
    a cold restart); without it, the legacy ``-1`` sentinel is passed and
    run_fn must resolve the latest checkpoint itself.  The generalized
    simulation supervisor (crash recovery + health-breach escalation)
    is :func:`repro_torch.core.health.run_resilient`."""
    restarts = 0
    resume = None
    while True:
        try:
            return run_fn(resume)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            if checkpoint_dir is not None:
                from .checkpoint import latest_step
                resume = latest_step(checkpoint_dir)
            else:
                resume = -1   # legacy signal: reload latest checkpoint


__all__ = ["FaultConfig", "InjectedFailure", "StragglerDetector",
           "run_with_recovery", "simulate_failures"]
