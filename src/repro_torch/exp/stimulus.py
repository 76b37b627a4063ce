"""Composable stimulus protocols: what drives the network each step.

Counterpart of ``repro/exp/stimulus.py`` for the stochastic stimuli and
their composition.  A stimulus's ``step`` produces the per-step
:class:`StimDrive` consumed by the step body; ``to(device)`` returns a
copy whose tensors live on the simulation's device.

Drive channels (all optional, combined additively / by OR):

* ``v_mv``    — direct membrane drive in mV (Brian2-style Poisson semantics);
* ``g_units`` — synaptic drive in integer weight units (Loihi approximation);
* ``force``   — forced spikes this step (the scaling study's background);
* ``counts``  — a Poisson count drive onto g (:class:`PoissonCount`), left
  as its raw threefry words, which the ``delay_event`` engine counts where
  it reads them; every other engine refuses it.

RNG contract, as in the reference: the step splits its carry key into
:func:`n_split` subkeys and hands ``keys[..., 1:, :]`` to the stimulus,
whose parts consume them in declaration order.  ``partitionable`` selects
the threefry mode (see :mod:`repro_torch.random`).

Trial batches: the keys are ``[..., k, 2]`` and every drive channel
``[..., n]``, one row per lane (``[B, k, 2]`` and ``[B, n]`` in a trial
batch of B lanes, as the reference's stimulus sees one lane under
``vmap``); the stimulus tensors themselves are shared by all lanes.

Partitioned use: :func:`shard_stimulus` turns a stimulus into its dense
per-neuron ("masked") form and remaps every per-neuron tensor through a
DCSR partitioning into partition-stacked ``[P, U]`` tensors (stateless
stimuli only).

The clocked stimuli (:class:`StepCurrent`, :class:`PulseTrain`,
:class:`RampDrive`) read the absolute step index ``t`` (a Python int;
a chunked run passes the step it starts at, so a chunk never replays a
pulse) and draw no keys.  Their gate is float32 arithmetic on the host,
as the reference's int32/float32 scalar ops in the scan are, and their
drive is one ``[n]`` row that the lanes share by broadcasting.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.core.neuron import (LIFParams, f32, f32_to_i32, f32s, ftz,
                                     lif_step, lif_step_fx, poisson_drive)
from repro_torch.tree import map_tensors


class CountDraw(NamedTuple):
    """A step's Poisson count drive, not yet counted: neuron i of a lane
    receives ``weight`` units for each threshold of its population's row
    of ``table`` that its word reaches (:func:`count_events`)."""

    bits: torch.Tensor     # [..., n] int64: one 32-bit threefry word each
    pop: torch.Tensor      # [n] int32 population of each neuron
    table: torch.Tensor    # [P, K] int64 thresholds, 2**32 past the last
    weight: float          # weight units an event


class StimDrive(NamedTuple):
    """Per-step drive; ``None`` channels cost nothing."""

    v_mv: torch.Tensor | None = None      # [..., n] float32 drive, mV
    g_units: torch.Tensor | None = None   # [..., n] float32, weight units
    force: torch.Tensor | None = None     # [..., n] bool forced spikes
    counts: CountDraw | None = None       # Poisson count drive onto g


def count_events(draw: CountDraw) -> torch.Tensor:
    """``[..., n]`` int32 events of a count drive: how many of its
    population's thresholds each word reaches (the thresholds rise along a
    row, so that is the Poisson count whose CDF the row holds)."""
    thr = draw.table[draw.pop.long()]                        # [n, K]
    count = torch.zeros(draw.bits.shape, dtype=torch.int32,
                        device=draw.bits.device)
    for k in range(thr.shape[1]):
        count += (draw.bits >= thr[:, k]).to(torch.int32)
    return count


def n_split(stim) -> int:
    """Subkeys to split from the carry key each step: 1 (next carry) plus
    one per stimulus key, floored at the historical 3-way split."""
    return 1 + max(2, stim.n_keys)


def apply_drive(lif, g_units: torch.Tensor, drive: StimDrive, p: LIFParams,
                fixed_point: bool, *, wide: bool = False):
    """Apply a :class:`StimDrive` to the delivered synaptic input and
    integrate one LIF step -> ``(new_lif, spikes)``: the g add (flushed to
    zero as XLA's CPU code flushes it) before the fixed-point rounding, and
    the Q19.12 conversion of ``v_mv`` by an IEEE division, as the reference
    does them.  ``wide``: the Q19.12 step's products in 64 bits
    (:func:`repro_torch.core.neuron.lif_step_fx`)."""
    if drive.g_units is not None:
        g_units = ftz(ftz(g_units) + ftz(drive.g_units))
    if fixed_point:
        g_in = f32_to_i32(torch.round(g_units))
        v_fx = None
        if drive.v_mv is not None:
            v_fx = f32_to_i32(torch.round(drive.v_mv
                                          / f32(p.w_scale, drive.v_mv)))
        return lif_step_fx(lif, g_in, p, v_fx, drive.force, wide=wide)
    return lif_step(lif, g_units, p, drive.v_mv, drive.force)


def _to(x, device):
    return None if x is None else x.to(device)


def per_neuron(sel, amp, n: int) -> torch.Tensor:
    """Dense [n] float32 drive: ids or bool mask ``sel`` set to ``amp``."""
    w = np.zeros(n, np.float32)
    w[np.asarray(sel)] = amp
    return torch.from_numpy(w)


def _by_target(target: str, arr: torch.Tensor) -> StimDrive:
    if target == "v":
        return StimDrive(v_mv=arr)
    if target == "g":
        return StimDrive(g_units=arr)
    raise ValueError(f"unknown drive target {target!r} (want 'v' or 'g')")


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
        key = keys[..., 0, :]
        if self.idx is not None:
            draws = prng.bernoulli(key, prob, tuple(self.idx.shape),
                                   partitionable=partitionable)
            out = torch.zeros(key.shape[:-1] + (n,), dtype=torch.float32,
                              device=keys.device)
            if self.target == "v":
                out[..., self.idx.long()] = draws.to(torch.float32) * f32s(amp)
                return state, StimDrive(v_mv=out)
            out.index_add_(-1, self.idx.long(),
                           draws.to(torch.float32) * f32s(self.weight))
            return state, StimDrive(g_units=out)
        draws = poisson_drive(key, n, self.rate_hz, p.dt, self.mask,
                              partitionable=partitionable)
        if self.target == "v":
            return state, StimDrive(
                v_mv=draws.to(torch.float32) * f32s(amp))
        return state, StimDrive(
            g_units=draws.to(torch.float32) * f32s(self.weight))

    def to_masked(self, n: int):
        """The same drive in masked mode (all n drawn, then masked)."""
        if self.idx is None:
            mask = (torch.ones(n, dtype=torch.bool) if self.mask is None
                    else self.mask)
        else:
            mask = torch.zeros(n, dtype=torch.bool, device=self.idx.device)
            mask[self.idx.long()] = True
        return dataclasses.replace(self, idx=None, mask=mask)


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
            keys[..., 0, :], n, self.rate_hz, p.dt, self.mask,
            partitionable=partitionable))

    def to_masked(self, n: int):
        mask = (torch.ones(n, dtype=torch.bool) if self.mask is None
                else self.mask)
        return dataclasses.replace(self, mask=mask)


CDF_ONE = 1 << 32     # the thresholds' scale: a threefry word's range


def poisson_count_table(lam) -> np.ndarray:
    """``[P, K]`` int64 thresholds of the Poisson counts of means ``lam``
    (events a step, one a population): entry k of a row is
    ``ceil(CDF(k) * 2**32)``, the CDF summed in float64 from ``pmf(0) =
    exp(-lam)`` and ``pmf(k) = pmf(k - 1) * lam / k``, up to the first
    entry that reaches ``2**32`` (no word reaches it), and every row padded
    with ``2**32`` to the longest.  A word ``u`` then counts ``#{k: u >=
    row[k]}`` events: ``P(count <= k) = row[k] / 2**32``."""
    rows = []
    for mean in lam:
        mean = float(mean)
        if not 0.0 <= mean <= 64.0:
            raise ValueError(f"a count's mean of {mean} events a step is "
                             f"outside [0, 64]")
        pmf, cdf, row = np.exp(-mean), 0.0, []
        for k in range(1024):
            cdf += pmf
            thr = min(CDF_ONE, int(np.ceil(cdf * CDF_ONE)))
            row.append(thr)
            if thr >= CDF_ONE:
                break
            pmf = pmf * mean / (k + 1)
        rows.append(row)
    K = max(len(r) for r in rows)
    return np.array([r + [CDF_ONE] * (K - len(r)) for r in rows], np.int64)


@dataclasses.dataclass(frozen=True)
class PoissonCount:
    """Poisson count drive onto g (a population's summed external input,
    the cortical microcircuit's background): every neuron of population p
    receives Poisson(``lam[p]``) events a step, each ``weight`` units.

    The step draws one 32-bit threefry word a neuron
    (:func:`repro_torch.random.random_bits`) and leaves it in the drive's
    ``counts`` channel with the thresholds of :func:`poisson_count_table`,
    made once on the host in float64; the ``delay_event`` engine counts
    the words where it reads them (:func:`count_events` in its plain
    version).
    """

    pop: Any                                      # [n] int32 population ids
    lam: tuple = ()                               # mean events a step, by pop
    weight: float = 1.0                           # g units an event
    table: Any = None                             # set from ``lam``

    n_keys = 1

    def __post_init__(self):
        if self.table is None:
            object.__setattr__(self, "table", torch.from_numpy(
                poisson_count_table(self.lam)))

    def init_state(self, n: int):
        return ()

    def to(self, device):
        return dataclasses.replace(self, pop=self.pop.to(device),
                                   table=self.table.to(device))

    def step(self, state, keys, t, n, p, *, partitionable=True):
        bits = prng.random_bits(keys[..., 0, :], (n,),
                                partitionable=partitionable)
        return state, StimDrive(counts=CountDraw(
            bits=bits, pop=self.pop, table=self.table,
            weight=float(self.weight)))

    def to_masked(self, n: int):
        return self


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

    def to_masked(self, n: int):
        return self


@dataclasses.dataclass(frozen=True)
class StepCurrent:
    """Constant drive ``weights`` during the window [t_on, t_off)."""

    weights: Any                                   # [n] float32 amplitude
    t_on: int = 0                                  # steps
    t_off: int | None = None
    target: str = "g"

    n_keys = 0

    def init_state(self, n: int):
        return ()

    def to(self, device):
        return dataclasses.replace(self, weights=self.weights.to(device))

    def step(self, state, keys, t, n, p, *, partitionable=True):
        on = t >= self.t_on
        if self.t_off is not None:
            on = on and t < self.t_off
        # a multiply by the 0/1 gate, not a select: NaN weights stay NaN
        # outside the window, as the reference's are
        return state, _by_target(self.target, self.weights * float(on))

    def to_masked(self, n: int):
        return self


@dataclasses.dataclass(frozen=True)
class PulseTrain:
    """Periodic pulses: ``width``-step pulses every ``period`` steps from
    ``t_on``, optionally limited to ``n_pulses``."""

    weights: Any
    period: int = 100                              # steps
    width: int = 5                                 # steps
    t_on: int = 0
    n_pulses: int | None = None
    target: str = "g"

    n_keys = 0

    def init_state(self, n: int):
        return ()

    def to(self, device):
        return dataclasses.replace(self, weights=self.weights.to(device))

    def step(self, state, keys, t, n, p, *, partitionable=True):
        ph = t - self.t_on
        on = ph >= 0
        if self.n_pulses is not None:
            on = on and ph < self.n_pulses * self.period
        on = on and ph % self.period < self.width
        return state, _by_target(self.target, self.weights * float(on))

    def to_masked(self, n: int):
        return self


@dataclasses.dataclass(frozen=True)
class RampDrive:
    """Optogenetic-style windowed ramp: amplitude rises linearly from 0 to
    ``weights`` over ``t_ramp`` steps starting at ``t_on``, holds, and cuts
    off at ``t_off`` (None = never)."""

    weights: Any
    t_on: int = 0
    t_ramp: int = 100                              # steps to reach peak
    t_off: int | None = None
    target: str = "g"

    n_keys = 0

    def init_state(self, n: int):
        return ()

    def to(self, device):
        return dataclasses.replace(self, weights=self.weights.to(device))

    def gate(self, t: int) -> np.float32:
        """The ramp's float32 gate at step ``t``.  XLA compiles the
        reference's ``ph / max(t_ramp, 1)`` into a multiply by the float32
        reciprocal of the constant, and so does this."""
        one = np.float32(1.0)
        ph = t - self.t_on
        frac = np.float32(ph) * (one / np.float32(max(self.t_ramp, 1)))
        gate = min(max(frac, np.float32(0.0)), one) if ph >= 0 \
            else np.float32(0.0)
        if self.t_off is not None and not t < self.t_off:
            gate = np.float32(0.0)
        return np.float32(gate)

    def step(self, state, keys, t, n, p, *, partitionable=True):
        return state, _by_target(self.target,
                                 self.weights * float(self.gate(t)))

    def to_masked(self, n: int):
        return self


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
        v = g = force = counts = None
        new_states = []
        k0 = 0
        for s, st in zip(self.parts, state):
            ks = keys[..., k0:k0 + s.n_keys, :] if s.n_keys else None
            k0 += s.n_keys
            st2, d = s.step(st, ks, t, n, p, partitionable=partitionable)
            new_states.append(st2)
            if d.v_mv is not None:
                v = d.v_mv if v is None else v + d.v_mv
            if d.g_units is not None:
                g = d.g_units if g is None else g + d.g_units
            if d.force is not None:
                force = d.force if force is None else force | d.force
            if d.counts is not None:
                if counts is not None:
                    raise ValueError("a stimulus takes one PoissonCount part")
                counts = d.counts
        return tuple(new_states), StimDrive(v_mv=v, g_units=g, force=force,
                                            counts=counts)

    def to_masked(self, n: int):
        return Compose(tuple(s.to_masked(n) for s in self.parts))


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


def shard_stimulus(stim, d):
    """Remap a stimulus onto a DCSR partitioning: its masked form, with
    every per-neuron tensor ``[..., n]`` made partition-stacked ``[..., P,
    U]`` through the renumbering (pad neurons get zeros / False)."""
    dense = stim.to_masked(d.n_orig)
    P_, U = d.n_parts, d.part_size
    inv = torch.from_numpy(np.asarray(d.inv_perm))
    real = inv >= 0
    safe = torch.where(real, inv, 0)

    def remap(x):
        if x.dim() == 0 or x.shape[-1] != d.n_orig:
            return x
        y = x[..., safe.to(x.device)]
        out = torch.where(real.to(x.device), y, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
        return out.reshape(x.shape[:-1] + (P_, U))
    return map_tensors(remap, dense)


__all__ = ["Background", "CDF_ONE", "Compose", "CountDraw", "PoissonCount",
           "PoissonDrive", "PulseTrain", "RampDrive", "SILENT", "SkipKey",
           "StepCurrent", "StimDrive", "apply_drive", "count_events",
           "legacy_stimulus", "n_split", "per_neuron", "poisson_count_table",
           "shard_stimulus"]
