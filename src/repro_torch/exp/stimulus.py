"""Composable stimulus protocols: what drives the network each step.

Counterpart of ``repro/exp/stimulus.py`` for the stochastic stimuli and
their composition.  A stimulus's ``step`` produces the per-step
:class:`StimDrive` consumed by the step body; ``to(device)`` returns a
copy whose tensors live on the simulation's device.

Drive channels (all optional, combined additively / by OR):

* ``v_mv``    — direct membrane drive in mV (Brian2-style Poisson semantics);
* ``g_units`` — synaptic drive in integer weight units (Loihi approximation);
* ``force``   — forced spikes this step (the scaling study's background).

RNG contract, as in the reference: the step splits its carry key into
:func:`n_split` subkeys and hands ``keys[1:]`` to the stimulus, whose
parts consume them in declaration order.  ``partitionable`` selects the
threefry mode (see :mod:`repro_torch.random`).

The clocked stimuli (``StepCurrent``, ``PulseTrain``, ``RampDrive``) and
``shard_stimulus`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.neuron import (LIFParams, f32, f32s, ftz, lif_step,
                                     lif_step_fx, poisson_drive)


class StimDrive(NamedTuple):
    """Per-step drive; ``None`` channels cost nothing."""

    v_mv: torch.Tensor | None = None      # [n] float32 membrane drive, mV
    g_units: torch.Tensor | None = None   # [n] float32 drive, weight units
    force: torch.Tensor | None = None     # [n] bool forced spikes


def n_split(stim) -> int:
    """Subkeys to split from the carry key each step: 1 (next carry) plus
    one per stimulus key, floored at the historical 3-way split."""
    return 1 + max(2, stim.n_keys)


def apply_drive(lif, g_units: torch.Tensor, drive: StimDrive, p: LIFParams,
                fixed_point: bool):
    """Apply a :class:`StimDrive` to the delivered synaptic input and
    integrate one LIF step -> ``(new_lif, spikes)``: the g add (flushed to
    zero as XLA's CPU code flushes it) before the fixed-point rounding, and
    the Q19.12 conversion of ``v_mv`` by an IEEE division, as the reference
    does them."""
    if drive.g_units is not None:
        g_units = ftz(ftz(g_units) + ftz(drive.g_units))
    if fixed_point:
        g_in = torch.round(g_units).to(torch.int32)
        v_fx = None
        if drive.v_mv is not None:
            v_fx = torch.round(drive.v_mv / f32(p.w_scale, drive.v_mv)
                               ).to(torch.int32)
        return lif_step_fx(lif, g_in, p, v_fx, drive.force)
    return lif_step(lif, g_units, p, drive.v_mv, drive.force)


def _to(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass(frozen=True)
class PoissonDrive:
    """Bernoulli(rate*dt) drive onto a population (the sugar experiment).

    Scatter mode (``idx``) draws only for the driven subset; masked mode
    (``mask`` or neither) draws for all n and masks.  ``target='v'`` sets
    the membrane drive to ``v_amp_mv`` (default 1.5*v_th); ``target='g'``
    adds ``weight`` units of synaptic drive.
    """

    idx: Any = None                               # [k] int32 target ids
    mask: Any = None                              # [n] bool
    rate_hz: float = 150.0
    target: str = "v"                             # "v" | "g"
    v_amp_mv: float | None = None                 # None -> 1.5*v_th
    weight: float = 180.0                         # g units per event

    n_keys = 1

    def init_state(self, n: int):
        return ()

    def to(self, device):
        return dataclasses.replace(self, idx=_to(self.idx, device),
                                   mask=_to(self.mask, device))

    def step(self, state, keys, t, n, p, *, partitionable=True):
        prob = self.rate_hz * p.dt * 1e-3
        amp = (1.5 * p.v_th) if self.v_amp_mv is None else self.v_amp_mv
        if self.idx is not None:
            draws = prng.bernoulli(keys[0], prob, tuple(self.idx.shape),
                                   partitionable=partitionable)
            out = torch.zeros(n, dtype=torch.float32, device=keys.device)
            if self.target == "v":
                out[self.idx.long()] = draws.to(torch.float32) * f32s(amp)
                return state, StimDrive(v_mv=out)
            out.index_add_(0, self.idx.long(),
                           draws.to(torch.float32) * f32s(self.weight))
            return state, StimDrive(g_units=out)
        draws = poisson_drive(keys[0], n, self.rate_hz, p.dt, self.mask,
                              partitionable=partitionable)
        if self.target == "v":
            return state, StimDrive(
                v_mv=draws.to(torch.float32) * f32s(amp))
        return state, StimDrive(
            g_units=draws.to(torch.float32) * f32s(self.weight))


@dataclasses.dataclass(frozen=True)
class Background:
    """Probabilistic background spiking (the activity scaling study):
    every unmasked neuron emits a forced spike with prob rate*dt."""

    mask: Any = None                              # [n] bool, None = all
    rate_hz: float = 5.0

    n_keys = 1

    def init_state(self, n: int):
        return ()

    def to(self, device):
        return dataclasses.replace(self, mask=_to(self.mask, device))

    def step(self, state, keys, t, n, p, *, partitionable=True):
        return state, StimDrive(force=poisson_drive(
            keys[0], n, self.rate_hz, p.dt, self.mask,
            partitionable=partitionable))


@dataclasses.dataclass(frozen=True)
class SkipKey:
    """Consume one PRNG subkey and drive nothing (keeps the historical key
    layout of a background-only legacy run)."""

    n_keys = 1

    def init_state(self, n: int):
        return ()

    def to(self, device):
        return self

    def step(self, state, keys, t, n, p, *, partitionable=True):
        return state, StimDrive()


@dataclasses.dataclass(frozen=True)
class Compose:
    """Combine stimuli: v/g drives add, forced spikes OR.  PRNG subkeys are
    handed to parts in declaration order (each consumes ``part.n_keys``)."""

    parts: tuple = ()

    @property
    def n_keys(self) -> int:
        return sum(s.n_keys for s in self.parts)

    def init_state(self, n: int):
        return tuple(s.init_state(n) for s in self.parts)

    def to(self, device):
        return Compose(tuple(s.to(device) for s in self.parts))

    def step(self, state, keys, t, n, p, *, partitionable=True):
        if len(state) != len(self.parts):
            raise ValueError(
                f"Compose state has {len(state)} entries for "
                f"{len(self.parts)} parts — carry was not built from this "
                f"stimulus's init_state()")
        v = g = force = None
        new_states = []
        k0 = 0
        for s, st in zip(self.parts, state):
            ks = keys[k0:k0 + s.n_keys] if s.n_keys else None
            k0 += s.n_keys
            st2, d = s.step(st, ks, t, n, p, partitionable=partitionable)
            new_states.append(st2)
            if d.v_mv is not None:
                v = d.v_mv if v is None else v + d.v_mv
            if d.g_units is not None:
                g = d.g_units if g is None else g + d.g_units
            if d.force is not None:
                force = d.force if force is None else force | d.force
        return tuple(new_states), StimDrive(v_mv=v, g_units=g, force=force)


SILENT = Compose(())   # no external drive at all (silent_baseline scenario)


def legacy_stimulus(cfg, n: int, sugar_idx=None, masked: bool = False
                    ) -> Compose:
    """Reconstruct the pre-subsystem inline drive from SimConfig fields,
    with the historical key layout (see :class:`SkipKey`).  Tensors are
    made on the CPU; ``simulate`` moves the stimulus to its device."""
    parts: list = []
    if masked:
        if cfg.poisson_rate_hz > 0:
            m = np.zeros(n, bool)
            if sugar_idx is not None:
                m[np.asarray(sugar_idx)] = True
            parts.append(PoissonDrive(
                mask=torch.from_numpy(m), rate_hz=cfg.poisson_rate_hz,
                target="v" if cfg.poisson_to_v else "g",
                weight=cfg.poisson_weight))
    elif sugar_idx is not None:
        parts.append(PoissonDrive(
            idx=torch.from_numpy(np.asarray(sugar_idx).astype(np.int32)),
            rate_hz=cfg.poisson_rate_hz,
            target="v" if cfg.poisson_to_v else "g",
            weight=cfg.poisson_weight))
    if cfg.background_rate_hz > 0:
        if not parts:
            parts.append(SkipKey())
        parts.append(Background(rate_hz=cfg.background_rate_hz))
    return Compose(tuple(parts))


__all__ = ["Background", "Compose", "PoissonDrive", "SILENT", "SkipKey",
           "StimDrive", "apply_drive", "legacy_stimulus", "n_split"]
