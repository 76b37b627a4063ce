"""Experiment subsystem: stimulus protocols, per-step probes and the
named-scenario registry (counterpart of ``repro.exp``; trial batches are
not ported yet)."""

from .probes import NO_PROBES, ProbeSpec
from .scenarios import (Scenario, available_scenarios, build_scenario,
                        get_scenario, register_scenario)
from .stimulus import (SILENT, Background, Compose, PoissonDrive, SkipKey,
                       StimDrive, apply_drive, legacy_stimulus, n_split)

__all__ = [
    "NO_PROBES", "ProbeSpec",
    "Scenario", "available_scenarios", "build_scenario", "get_scenario",
    "register_scenario",
    "SILENT", "Background", "Compose", "PoissonDrive", "SkipKey",
    "StimDrive", "apply_drive", "legacy_stimulus", "n_split",
]
