"""Experiment subsystem: stimulus protocols, per-step probes, the
named-scenario registry and trial batches (counterpart of
``repro.exp``)."""

from .probes import NO_PROBES, ProbeSpec
from .scenarios import (Scenario, available_scenarios, build_scenario,
                        get_scenario, register_scenario)
from .stimulus import (SILENT, Background, Compose, CountDraw, PoissonCount,
                       PoissonDrive, PulseTrain, RampDrive, SkipKey,
                       StepCurrent, StimDrive, apply_drive, count_events,
                       legacy_stimulus, n_split, per_neuron,
                       poisson_count_table, shard_stimulus)
from .trials import (DistTrialResult, TrialResult, run_dist_trials,
                     run_trials, trial_carry)

__all__ = [
    "NO_PROBES", "ProbeSpec",
    "Scenario", "available_scenarios", "build_scenario", "get_scenario",
    "register_scenario",
    "SILENT", "Background", "Compose", "CountDraw", "PoissonCount",
    "PoissonDrive", "PulseTrain", "RampDrive", "SkipKey", "StepCurrent",
    "StimDrive", "apply_drive", "count_events", "legacy_stimulus", "n_split",
    "per_neuron", "poisson_count_table", "shard_stimulus",
    "DistTrialResult", "TrialResult", "run_dist_trials", "run_trials",
    "trial_carry",
]
