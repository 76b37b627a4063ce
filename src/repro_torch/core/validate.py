"""Statistical validation: spike-rate parity between implementations.

The port's own copy of ``repro/core/validate.py`` (never imported from
it).  The paper validates Brian2 <-> STACS <-> Loihi by plotting
per-neuron average spike rates (over 10 trials) against each other and
checking they fall on the y=x parity line (Figs 6, 12, 14, 15).  This
reproduces the statistic and adds quantitative summaries (parity RMSE,
Pearson r, fraction within tolerance).

It is numpy on the host.  Every function also takes tensors, on any
device, and moves them to the host first; ``TrialResult.mean_rates_hz``
(:mod:`repro_torch.exp.trials`) is already there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


@dataclasses.dataclass(frozen=True)
class ParityStats:
    rmse_hz: float
    pearson_r: float
    frac_within_1hz: float
    mean_rate_a: float
    mean_rate_b: float
    n_active: int
    n_nonfinite: int = 0   # entries masked out (NaN/inf in either input)

    def summary(self) -> str:
        return (f"rmse={self.rmse_hz:.3f}Hz r={self.pearson_r:.4f} "
                f"within1Hz={self.frac_within_1hz:.3f} "
                f"mean_a={self.mean_rate_a:.2f}Hz mean_b={self.mean_rate_b:.2f}Hz "
                f"active={self.n_active} nonfinite={self.n_nonfinite}")


def parity(rates_a, rates_b, active_thresh_hz: float = 0.5) -> ParityStats:
    """Compare index-matched per-neuron rates (averaged over trials).

    Non-finite entries (a poisoned run fed in by accident) are excluded
    from every statistic rather than silently propagating NaN into all of
    them; the count is reported as ``n_nonfinite`` so the caller can
    refuse a poisoned comparison."""
    rates_a = _host(rates_a, np.float64)
    rates_b = _host(rates_b, np.float64)
    finite = np.isfinite(rates_a) & np.isfinite(rates_b)
    n_nonfinite = int((~finite).sum())
    active = ((rates_a > active_thresh_hz) | (rates_b > active_thresh_hz)) \
        & finite
    a, b = rates_a[active], rates_b[active]
    if len(a) == 0:
        return ParityStats(0.0, 1.0, 1.0, 0.0, 0.0, 0,
                           n_nonfinite=n_nonfinite)
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    if np.std(a) > 0 and np.std(b) > 0:
        r = float(np.corrcoef(a, b)[0, 1])
    else:
        r = 1.0 if np.allclose(a, b) else 0.0
    return ParityStats(
        rmse_hz=rmse,
        pearson_r=r,
        frac_within_1hz=float(np.mean(np.abs(a - b) <= 1.0)),
        mean_rate_a=float(a.mean()),
        mean_rate_b=float(b.mean()),
        n_active=int(active.sum()),
        n_nonfinite=n_nonfinite,
    )


def mean_rates_over_trials(count_trials, t_steps: int,
                           dt_ms: float) -> np.ndarray:
    """[trials][n] spike counts -> [n] mean rate in Hz."""
    c = np.stack([_host(x) for x in count_trials])
    return c.mean(axis=0) / (t_steps * dt_ms * 1e-3)


def raster_to_times(raster, dt_ms: float):
    """[T, n] bool -> (times_ms, neuron_ids) for raster plots/dumps."""
    t, nid = np.nonzero(_host(raster))
    return t * dt_ms, nid


__all__ = ["ParityStats", "mean_rates_over_trials", "parity",
           "raster_to_times"]
