"""Named-scenario registry: reusable stimulus-response experiments.

Counterpart of ``repro/exp/scenarios.py``.  A scenario is a named builder
``build(c, cfg, **params) -> Stimulus`` with overridable defaults; the
CLI (``repro_torch.launch.simulate --scenario``) and ``chip_smoke.py``
draw from this catalog, so a scenario runs monolithic, as a trial batch
or partitioned (through :func:`repro_torch.exp.shard_stimulus`)
unchanged.

================== ======================================================
sugar_feeding      the paper's validation workload: Poisson drive onto a
                   random sugar-sensing population (+ optional background)
activity_sweep     uniform background spiking at a parametric rate — the
                   scaling-study substrate
background_storm   sugar drive under heavy background (stress / drop
                   accounting regime)
silent_baseline    no external drive: a correctly wired network must stay
                   silent (regression canary)
step_response      constant current step onto a random subset in a window
pulse_probe        periodic pulse train onto a random subset
opto_ramp          optogenetic-style windowed linear ramp drive
================== ======================================================
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .stimulus import (SILENT, Background, Compose, PoissonDrive, PulseTrain,
                       RampDrive, StepCurrent, per_neuron)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    build: Callable[..., Any]        # (c, cfg, **params) -> Stimulus
    defaults: dict


_SCENARIOS: dict[str, Scenario] = {}


def register_scenario(name: str, description: str = "", **defaults):
    """Decorator: register ``fn(c, cfg, **params) -> Stimulus`` under
    ``name`` with overridable default params."""
    def deco(fn):
        if name in _SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        _SCENARIOS[name] = Scenario(name, description, fn, dict(defaults))
        return fn
    return deco


def get_scenario(name: str) -> Scenario:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: {sorted(_SCENARIOS)}"
        ) from None


def available_scenarios() -> list[str]:
    return sorted(_SCENARIOS)


def build_scenario(name: str, c, cfg, **overrides):
    """Instantiate a named scenario's stimulus for connectome ``c`` under
    ``cfg`` (params default from the registry, overridable per call)."""
    s = get_scenario(name)
    unknown = set(overrides) - set(s.defaults)
    if unknown:
        raise ValueError(f"scenario {name!r} has no params {sorted(unknown)}; "
                         f"accepts {sorted(s.defaults)}")
    return s.build(c, cfg, **{**s.defaults, **overrides})


def _pick(c, n_targets: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(c.n, size=min(int(n_targets), c.n), replace=False)


@register_scenario(
    "sugar_feeding",
    "paper validation workload: Poisson onto sugar-sensing neurons",
    n_sugar=20, rate_hz=None, background_hz=0.0, seed=0)
def _sugar_feeding(c, cfg, *, n_sugar, rate_hz, background_hz, seed):
    idx = _pick(c, n_sugar, seed)
    parts = [PoissonDrive(
        idx=torch.from_numpy(idx.astype(np.int32)),
        rate_hz=cfg.poisson_rate_hz if rate_hz is None else rate_hz,
        target="v" if cfg.poisson_to_v else "g",
        weight=cfg.poisson_weight)]
    if background_hz > 0:
        parts.append(Background(rate_hz=background_hz))
    return Compose(tuple(parts))


@register_scenario(
    "activity_sweep",
    "uniform background spiking at a parametric rate (scaling study)",
    background_hz=5.0)
def _activity_sweep(c, cfg, *, background_hz):
    if background_hz <= 0:      # off = no per-step draw at all
        return SILENT
    return Compose((Background(rate_hz=background_hz),))


@register_scenario(
    "background_storm",
    "sugar drive under heavy background activity (stress regime)",
    n_sugar=20, background_hz=200.0, seed=0)
def _background_storm(c, cfg, *, n_sugar, background_hz, seed):
    sugar = build_scenario("sugar_feeding", c, cfg, n_sugar=n_sugar, seed=seed)
    return Compose(sugar.parts + (Background(rate_hz=background_hz),))


@register_scenario(
    "silent_baseline",
    "no external drive: the network must stay silent",
)
def _silent_baseline(c, cfg):
    return SILENT


@register_scenario(
    "step_response",
    "constant current step onto a random subset during a window",
    n_targets=100, amp=80.0, t_on=50, t_off=250, seed=0)
def _step_response(c, cfg, *, n_targets, amp, t_on, t_off, seed):
    w = per_neuron(_pick(c, n_targets, seed), amp, c.n)
    return Compose((StepCurrent(weights=w, t_on=int(t_on), t_off=int(t_off)),))


@register_scenario(
    "pulse_probe",
    "periodic pulse train onto a random subset",
    n_targets=100, amp=120.0, period_ms=5.0, width_ms=0.5, t_on=0, seed=0)
def _pulse_probe(c, cfg, *, n_targets, amp, period_ms, width_ms, t_on, seed):
    dt = cfg.params.dt
    w = per_neuron(_pick(c, n_targets, seed), amp, c.n)
    return Compose((PulseTrain(
        weights=w, period=max(1, int(round(period_ms / dt))),
        width=max(1, int(round(width_ms / dt))), t_on=int(t_on)),))


@register_scenario(
    "opto_ramp",
    "optogenetic-style windowed linear ramp drive",
    n_targets=200, amp=60.0, t_on_ms=5.0, ramp_ms=20.0, t_off_ms=40.0, seed=0)
def _opto_ramp(c, cfg, *, n_targets, amp, t_on_ms, ramp_ms, t_off_ms, seed):
    dt = cfg.params.dt
    w = per_neuron(_pick(c, n_targets, seed), amp, c.n)
    return Compose((RampDrive(
        weights=w, t_on=int(round(t_on_ms / dt)),
        t_ramp=max(1, int(round(ramp_ms / dt))),
        t_off=int(round(t_off_ms / dt))),))


__all__ = ["Scenario", "available_scenarios", "build_scenario",
           "get_scenario", "register_scenario"]
