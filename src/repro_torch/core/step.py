"""The simulation step (paper §3.2.2-3.2.3), and the loop over steps.

Counterpart of ``repro/core/step.py``: ring-buffer delayed-spike readout,
spike exchange/delivery, stimulus step, LIF integration, pad masking,
counters and probe collection, through a registered exchange scheme.  A
scheme whose delivery already integrates (``engine="blocked_fused"``)
reports ``fuses_lif(sim)`` and the step calls its ``deliver_fused``
instead of ``deliver`` + ``apply_drive``, so the LIF update runs exactly
once.

The reference vmaps (or shards) its step over the partitions, so its
collective sees every partition at once.  Here the step of one partition
is split around the collective: :func:`step_exchange` (key split, delayed
read, the scheme's local exchange), then the caller's
:func:`~repro_torch.core.exchange.base.all_gather` of every partition's
contribution, then :func:`step_finish` (the rest).  :func:`sim_step` is
the one-partition composition, which :func:`scan_steps` loops; the
partitioned runner (:mod:`repro_torch.core.distributed`) drives the two
halves itself.  Where the reference scans over an immutable carry, the
loop copies the ring buffer once and then updates it in place every step.

There is one step body, and it runs a batch of lanes: the reference
vmaps its step over a trial axis, and here that axis is written out as
the leading axis of every per-lane leaf of the carry (:class:`SimCarry`).
Every op of the step runs once over all B lanes; the synaptic state and
the stimulus are shared.  A single run is the batch of one lane.

The two halves mark where each phase of the step starts
(:mod:`repro_torch.obs.phases`: ``keys``, ``exchange``, ``stimulus``,
``deliver``, ``finish``, ``probes``) when the chunk in flight is marked;
otherwise each half makes one check and marks nothing.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import random as prng
from repro_torch.obs import phases

from .exchange.base import ExchangeScheme, Topology, all_gather
from .health import health_step_stats
from .neuron import LIFState


def _scheme_fuses_lif(scheme: ExchangeScheme, sim) -> bool:
    fuses = getattr(scheme, "fuses_lif", None)
    return bool(fuses(sim)) if fuses is not None else False


class SimCarry(NamedTuple):
    """Loop carry of one partition over B lanes (tensors on the run's
    device; U = n when P = 1).  It holds one of two rings, each
    ``[D, B, U]`` so that a step's slot ``[ptr]`` is one contiguous
    ``[B, U]`` block, read and written in place as one op:

    * ``ring``, bool, for every engine of the one uniform delay
      (``LIFParams.delay``, D = ``delay_steps``): the spikes of D steps
      ago are read from slot ``ptr`` and delivered, and this step's spikes
      written there; ``pending`` is None;
    * ``pending``, int32, for an engine with per-synapse delays
      (``delay_event``; D = its longest delay + 1): the input due this step
      is read from slot ``ptr`` and zeroed, and a spike through a synapse
      of delay d adds its weight into slot ``(ptr + d) % D``; ``ring`` is
      None.  At ~19 GB for 1,024 lanes of the cortical microcircuit it is
      never copied: the steps update it in place, across chunks."""
    lif: LIFState          # leaves [B, U]
    ring: torch.Tensor | None  # [D, B, U] bool delayed-spike ring buffer
    ptr: int               # ring slot read (then written) this step
    key: torch.Tensor      # [B, 2] int64: the two uint32 words of a JAX key
    counts: torch.Tensor   # [B, U] int32 spike counts
    dropped: torch.Tensor  # [B] int32 total dropped synapse events
    stim: Any              # stimulus state (() for stateless stimuli)
    stats: dict            # scheme and health counters, [B] each
    pending: torch.Tensor | None = None   # [D, B, U] int32 pending input


class PendingState(NamedTuple):
    """The final state of a run with per-synapse delays: the LIF leaves
    ``[B, n]`` and the pending ring as ``[B, n, D]`` (a view of the
    carry's ``[D, B, n]`` ring, slot s holding the input due at the steps
    t with t % D == s, t counted from the run's start)."""
    v: torch.Tensor
    g: torch.Tensor
    refrac: torch.Tensor
    pending: torch.Tensor


def final_state(carry: SimCarry):
    """The run's final state: ``carry.lif``, or with a pending ring a
    :class:`PendingState` (no copy)."""
    if carry.pending is None:
        return carry.lif
    return PendingState(*carry.lif, pending=carry.pending.movedim(0, -1))


class Exchanged(NamedTuple):
    """What :func:`step_exchange` leaves for :func:`step_finish`."""
    keys: torch.Tensor     # [B, n_split, 2] this step's key split
    delayed: torch.Tensor  # [B, U] bool spikes delivered this step
    sent: torch.Tensor     # this partition's part of the collective
    kept: Any              # what the scheme keeps for its deliver


def step_exchange(carry: SimCarry, t: int, *, scheme: ExchangeScheme, state,
                  stim, cap, topo: Topology, partitionable: bool = True
                  ) -> Exchanged:
    """The half of a step before the collective, at the absolute step
    ``t``.  A scheme with the step-aware ``exchange_at`` (the ``faulty``
    wrapper, which sabotages payloads at configured steps) is called
    through it; the others keep the t-free ``exchange``."""
    from repro_torch.exp.stimulus import n_split
    marks = phases.current()
    if marks is not None:
        marks("keys")
    keys = prng.split(carry.key, n_split(stim), partitionable=partitionable)
    if marks is not None:
        marks("exchange")
    delayed = None if carry.ring is None else carry.ring[carry.ptr]
    ex_at = getattr(scheme, "exchange_at", None)
    sent, kept = (scheme.exchange(state, delayed, cap, topo) if ex_at is None
                  else ex_at(state, delayed, cap, topo, t))
    return Exchanged(keys, delayed, sent, kept)


def step_finish(carry: SimCarry, ex: Exchanged, gathered: torch.Tensor,
                t: int, *, scheme: ExchangeScheme, state, stim, sim, cap,
                topo: Topology, probes, partitionable: bool = True,
                pad_mask=None, voltage_rows=None) -> tuple[SimCarry, dict]:
    """The half of a step after the collective.  Writes this step's spikes
    into ``carry.ring`` in place (the slot just read) and returns the new
    carry and this step's probe records (``[B, ...]`` each).  ``pad_mask``
    ([U] bool, True for real neurons) keeps a padded partition's pad slots
    silent."""
    from repro_torch.exp.stimulus import apply_drive
    p = sim.params
    marks = phases.current()
    if marks is not None:
        marks("stimulus")
    payload = (gathered, ex.kept)
    sstate, drive = stim.step(carry.stim, ex.keys[..., 1:, :], t,
                              topo.part_size, p, partitionable=partitionable)
    if marks is not None:
        marks("deliver")
    if carry.pending is not None:
        lif, spikes, drop, stats = scheme.deliver_pending(
            state, carry.pending, carry.ptr, carry.lif, drive, sim, cap, topo)
    elif drive.counts is not None:
        raise ValueError("a PoissonCount drive takes the delay_event engine "
                         f"(per-synapse delays), not {sim.engine!r}")
    elif _scheme_fuses_lif(scheme, sim):
        lif, spikes, drop, stats = scheme.deliver_fused(
            state, payload, ex.delayed, carry.lif, drive, sim, cap, topo)
    else:
        g_units, drop, stats = scheme.deliver(state, payload, ex.delayed, sim,
                                              cap, topo)
        lif, spikes = apply_drive(carry.lif, g_units, drive, p,
                                  sim.fixed_point)
    if marks is not None:
        marks("finish")
    if pad_mask is not None:
        spikes = spikes & pad_mask

    if carry.ring is not None:
        carry.ring[carry.ptr] = spikes
    depth = (p.delay_steps if carry.pending is None
             else carry.pending.shape[0])
    # the health sentinels (repro_torch.core.health) accumulate next to
    # the scheme counters; the carry's stats keys are fixed at init time
    stats = {**stats, **health_step_stats(lif, sim)}
    new = SimCarry(
        lif=lif, ring=carry.ring, ptr=(carry.ptr + 1) % depth,
        key=ex.keys[..., 0, :], counts=carry.counts + spikes.to(torch.int32),
        dropped=carry.dropped + drop.to(torch.int32), stim=sstate,
        stats={k: carry.stats[k] + stats[k] for k in carry.stats},
        pending=carry.pending)
    if marks is not None:
        marks("probes")
    return new, probes.collect(spikes=spikes, lif=lif, drop=drop, params=p,
                               voltage_rows=voltage_rows)


def sim_step(carry: SimCarry, t: int, *, scheme: ExchangeScheme, state, stim,
             sim, cap, topo: Topology, probes, partitionable: bool = True,
             voltage_rows=None) -> tuple[SimCarry, dict]:
    """One step of a single partition: both halves, the collective over
    the one partition in between."""
    ex = step_exchange(carry, t, scheme=scheme, state=state, stim=stim,
                       cap=cap, topo=topo, partitionable=partitionable)
    return step_finish(carry, ex, all_gather([ex.sent]), t, scheme=scheme,
                       state=state, stim=stim, sim=sim, cap=cap, topo=topo,
                       probes=probes, partitionable=partitionable,
                       voltage_rows=voltage_rows)


def scan_steps(scheme: ExchangeScheme, state, carry: SimCarry, stim, sim,
               cap, topo: Topology, probes, t_steps: int, *, t0: int = 0,
               partitionable: bool = True) -> tuple[SimCarry, dict]:
    """Run ``t_steps`` of :func:`sim_step` from the absolute step index
    ``t0`` (a chunk of a supervised run starts at its own step, so the
    clocked stimuli never replay); returns the final carry and the
    records stacked to ``[B, T, ...]``.  The given carry is not
    modified, apart from a pending ring, which the steps update in
    place."""
    voltage_rows = None
    if probes.voltage:
        probes.check(topo.part_size)
        voltage_rows = torch.tensor(probes.voltage, dtype=torch.long,
                                    device=carry.counts.device)
    if carry.ring is not None:
        carry = carry._replace(ring=carry.ring.clone())
    records: dict[str, list] = {}
    for t in range(t0, t0 + t_steps):
        carry, rec = sim_step(carry, t, scheme=scheme, state=state, stim=stim,
                              sim=sim, cap=cap, topo=topo, probes=probes,
                              partitionable=partitionable,
                              voltage_rows=voltage_rows)
        for k, v in rec.items():
            records.setdefault(k, []).append(v)
    return carry, {k: torch.stack(v, dim=1) for k, v in records.items()}


__all__ = ["Exchanged", "PendingState", "SimCarry", "final_state",
           "scan_steps", "sim_step", "step_exchange", "step_finish"]
