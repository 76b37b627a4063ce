"""Delay-event engine: delivery at each synapse's own delay, into a ring
of pending input.

No counterpart in ``repro/core/engines/``: every engine of the JAX
package reads the spikes of one uniform delay ago from the carry's ring
of spike vectors.  A network whose synapses each have a delay (the
Potjans & Diesmann microcircuit: 1-60 steps, multapses with delays of
their own) needs the input itself held until it is due.  This engine
declares ``per_synapse_delays``: the carry then holds, in place of the
spike ring, a ring of pending input ``pending`` ``[D, B, n]`` int32
(:class:`repro_torch.core.step.SimCarry`), ``D`` the longest delay plus
one.  A spike of step t through a synapse of delay d adds its weight into
slot ``(t + d) % D``; step t reads and zeroes slot ``t % D``
(``carry.ptr``).

The store is source-major: each synapse one 32-bit word (target in the
low bits, the signed quantized weight, the delay in steps above them,
widths set by ``n``, the weight range and ``D``), the words of a source
contiguous, and the row pointers.  The step is
:func:`repro_torch.kernels.delay_event.delay_step`: one kernel reads the
slot, applies the drive (a Poisson count drive counted from its words
there) and the LIF step and lists the spikes; a second walks the listed
spikes' fan-out and adds each weight into its slot with int32 atomics,
exact in any order.  No budget caps the work, so nothing is dropped.
The lanes' ``syn_events`` and ``drive_events`` are counters of the
carry's ``stats``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compress import quantize_weights
from ..connectome import Connectome
from .base import register

#: The carry's counters this engine adds a step, ``[B]`` int64 each.
STATS = ("syn_events", "drive_events")

_CHUNK = 1 << 24      # synapses packed at once on the device


@dataclasses.dataclass(frozen=True)
class DelayEventState:
    indptr: torch.Tensor              # [n+1] int64 fan-out row pointers
    words: torch.Tensor               # [nnz] int32 packed synapses
    n: int = 0
    depth: int = 2                    # D: the longest delay + 1
    tgt_bits: int = 1
    w_bits: int = 8

    @property
    def nbytes(self) -> int:
        return (self.indptr.numel() * self.indptr.element_size()
                + self.words.numel() * self.words.element_size())


def word_layout(n: int, depth: int, w_lo: int, w_hi: int) -> tuple[int, int]:
    """``(tgt_bits, w_bits)`` of the packed word for ``n`` neurons, delays
    below ``depth`` and weights in ``[w_lo, w_hi]``: the target and delay
    fields as narrow as they can be, the weight the bits between; raises if
    the weights do not fit."""
    tbits = max(1, (n - 1).bit_length())
    dbits = max(1, (depth - 1).bit_length())
    wbits = 32 - tbits - dbits
    lo, hi = -(1 << (wbits - 1)), (1 << (wbits - 1)) - 1
    if wbits < 2 or w_lo < lo or w_hi > hi:
        raise ValueError(
            f"delay_event: weights in [{w_lo}, {w_hi}] do not fit the "
            f"{wbits} bits left by {n} neurons ({tbits} bits) and delays "
            f"below {depth} ({dbits} bits)")
    return tbits, wbits


def pack_words(tgt: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
               tbits: int, wbits: int) -> torch.Tensor:
    """int32 words ``tgt | (w & mask) << tbits | d << (tbits + wbits)``
    (the 32 bits as an unsigned word, held in int32)."""
    x = (tgt.long() | ((w.long() & ((1 << wbits) - 1)) << tbits)
         | (d.long() << (tbits + wbits)))
    return (x - ((x >> 31) << 32)).to(torch.int32)


@register
class DelayEventEngine:
    name = "delay_event"
    per_synapse_delays = True     # the carry holds the pending ring

    def build(self, c: Connectome, cfg, device) -> DelayEventState:
        if c.out_delays is None:
            raise ValueError("the delay_event engine needs per-synapse "
                             "delays (Connectome.out_delays)")
        w = np.asarray(c.out_weights)
        if cfg.quantize_bits is not None:
            w = quantize_weights(w, cfg.quantize_bits)
        elif c.nnz and not np.array_equal(w, np.round(w)):
            raise ValueError("the delay_event engine sums integer weights: "
                             "set quantize_bits or give integer weights")
        d = np.asarray(c.out_delays)
        depth = int(d.max()) + 1 if c.nnz else 2
        tbits, wbits = word_layout(c.n, depth, int(w.min()) if c.nnz else 0,
                                   int(w.max()) if c.nnz else 0)
        words = torch.empty(c.nnz, dtype=torch.int32, device=device)
        for s in range(0, c.nnz, _CHUNK):
            e = min(c.nnz, s + _CHUNK)
            words[s:e] = pack_words(
                *(torch.from_numpy(np.ascontiguousarray(x[s:e])).to(device)
                  for x in (c.out_indices, w, d)), tbits, wbits)
        return DelayEventState(
            indptr=torch.from_numpy(np.asarray(c.out_indptr, np.int64)
                                    ).to(device),
            words=words, n=c.n, depth=depth, tgt_bits=tbits, w_bits=wbits)

    def init_stats(self, lanes: int, device) -> dict:
        return {k: torch.zeros(lanes, dtype=torch.int64, device=device)
                for k in STATS}

    def deliver(self, state, spikes, cfg):
        raise NotImplementedError(
            "the delay_event engine delivers into the carry's pending ring "
            "(deliver_pending), not from a ring of spikes")

    def deliver_pending(self, state: DelayEventState, pending, ptr, lif,
                        drive, cfg):
        """One step on the pending ring ``[D, B, n]`` (updated in place) ->
        ``(new_lif, spikes [B, n] bool, dropped [B] (zeros), stats)``."""
        from repro_torch.kernels.delay_event import delay_step
        lif, spikes, stats = delay_step(state, pending, ptr, lif, drive,
                                        cfg.params, cfg.fixed_point)
        return lif, spikes, torch.zeros(spikes.shape[:-1], dtype=torch.int32,
                                        device=spikes.device), stats


__all__ = ["DelayEventEngine", "DelayEventState", "STATS", "pack_words",
           "word_layout"]
