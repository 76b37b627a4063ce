"""The simulation step (paper §3.2.2-3.2.3), and the loop over steps.

Counterpart of ``repro/core/step.py``: ring-buffer delayed-spike readout,
spike exchange/delivery, stimulus step, LIF integration, counters and
probe collection, through a registered exchange scheme.  A scheme whose
delivery already integrates (``engine="blocked_fused"``) reports
``fuses_lif(sim)`` and the step calls its ``deliver_fused`` instead of
``deliver`` + ``apply_drive``, so the LIF update runs exactly once.

Where the reference scans with ``lax.scan`` over an immutable carry,
:func:`scan_steps` is a Python loop; it copies the ring buffer once and
then updates it in place every step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import random as prng

from .exchange.base import ExchangeScheme, Topology
from .neuron import LIFState


def _scheme_fuses_lif(scheme: ExchangeScheme, sim) -> bool:
    fuses = getattr(scheme, "fuses_lif", None)
    return bool(fuses(sim)) if fuses is not None else False


class SimCarry(NamedTuple):
    """Loop carry (leaves are [n]-shaped tensors on the run's device)."""
    lif: LIFState
    ring: torch.Tensor     # [D, n] bool delayed-spike ring buffer
    ptr: int               # ring slot read (then written) this step
    key: torch.Tensor      # [2] int64: the two uint32 words of a JAX key
    counts: torch.Tensor   # [n] int32 spike counts
    dropped: torch.Tensor  # scalar int32 total dropped synapse events
    stim: Any              # stimulus state (() for stateless stimuli)
    stats: dict            # scheme stats counters (scheme.init_stats())


def sim_step(carry: SimCarry, t: int, *, scheme: ExchangeScheme, state, stim,
             sim, cap, topo: Topology, probes, partitionable: bool = True,
             voltage_rows=None) -> tuple[SimCarry, dict]:
    """One simulation step.  Writes this step's spikes into ``carry.ring``
    in place (the slot it has just read) and returns the new carry and
    this step's probe records."""
    from repro_torch.exp.stimulus import apply_drive, n_split
    p = sim.params
    keys = prng.split(carry.key, n_split(stim), partitionable=partitionable)
    delayed = carry.ring[carry.ptr]

    payload = scheme.exchange(state, delayed, cap, topo)
    sstate, drive = stim.step(carry.stim, keys[1:], t, topo.part_size, p,
                              partitionable=partitionable)
    if _scheme_fuses_lif(scheme, sim):
        lif, spikes, drop, stats = scheme.deliver_fused(
            state, payload, delayed, carry.lif, drive, sim, cap, topo)
    else:
        g_units, drop, stats = scheme.deliver(state, payload, delayed, sim,
                                              cap, topo)
        lif, spikes = apply_drive(carry.lif, g_units, drive, p,
                                  sim.fixed_point)

    carry.ring[carry.ptr] = spikes
    new = SimCarry(
        lif=lif, ring=carry.ring, ptr=(carry.ptr + 1) % p.delay_steps,
        key=keys[0], counts=carry.counts + spikes.to(torch.int32),
        dropped=carry.dropped + drop.to(torch.int32), stim=sstate,
        stats={k: carry.stats[k] + stats[k] for k in carry.stats})
    return new, probes.collect(spikes=spikes, lif=lif, drop=drop, params=p,
                               voltage_rows=voltage_rows)


def scan_steps(scheme: ExchangeScheme, state, carry: SimCarry, stim, sim,
               cap, topo: Topology, probes, t_steps: int, *, t0: int = 0,
               partitionable: bool = True) -> tuple[SimCarry, dict]:
    """Run ``t_steps`` of :func:`sim_step` from step index ``t0``; returns
    the final carry and the records stacked to ``[T, ...]``.  The given
    carry is not modified."""
    voltage_rows = None
    if probes.voltage:
        probes.check(topo.part_size)
        voltage_rows = torch.tensor(probes.voltage, dtype=torch.long,
                                    device=carry.counts.device)
    carry = carry._replace(ring=carry.ring.clone())
    records: dict[str, list] = {}
    for t in range(t0, t0 + t_steps):
        carry, rec = sim_step(carry, t, scheme=scheme, state=state, stim=stim,
                              sim=sim, cap=cap, topo=topo, probes=probes,
                              partitionable=partitionable,
                              voltage_rows=voltage_rows)
        for k, v in rec.items():
            records.setdefault(k, []).append(v)
    return carry, {k: torch.stack(v) for k, v in records.items()}


__all__ = ["SimCarry", "scan_steps", "sim_step"]
