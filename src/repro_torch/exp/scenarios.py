"""Named-scenario registry: reusable stimulus-response experiments.

Counterpart of ``repro/exp/scenarios.py``.  A scenario is a named builder
``build(c, cfg, **params) -> Stimulus`` with overridable defaults.
Ported: ``sugar_feeding`` (the paper's validation workload),
``activity_sweep`` and ``silent_baseline``.  The reference's
``background_storm``, ``step_response``, ``pulse_probe`` and ``opto_ramp``
are not ported yet; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .stimulus import SILENT, Background, Compose, PoissonDrive

#: Scenarios of ``repro.exp.scenarios`` that this package does not have yet.
NOT_PORTED = ("background_storm", "opto_ramp", "pulse_probe",
              "step_response")


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
    if name in _SCENARIOS:
        return _SCENARIOS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"scenario {name!r} is not ported yet")
    raise ValueError(
        f"unknown scenario {name!r}; available: {sorted(_SCENARIOS)}")


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
    "silent_baseline",
    "no external drive: the network must stay silent",
)
def _silent_baseline(c, cfg):
    return SILENT


__all__ = ["NOT_PORTED", "Scenario", "available_scenarios", "build_scenario",
           "get_scenario", "register_scenario"]
