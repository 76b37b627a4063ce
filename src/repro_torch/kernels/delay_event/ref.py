"""Plain versions of the delay_event kernels, for tensors on the CPU.

No counterpart in ``repro/kernels/``.  A step of the engine, on a ring of
pending input ``[D, B, n]`` int32 and its slot ``ptr`` (this step's):

1. the slot is read as the step's delivered input and zeroed;
2. the drive is applied and the LIF step taken, as
   :func:`repro_torch.exp.stimulus.apply_drive` does both (a count drive
   counted from its words; Q19.12 with its products in 64 bits);
3. each spike of lane b from source s adds, for every synapse of s with
   target i, weight w and delay d, w into ``pending[(ptr + d) % D, b, i]``.

A synapse is one packed 32-bit word (:func:`unpack`).
"""

from __future__ import annotations

import torch


def unpack(words: torch.Tensor, tbits: int, wbits: int):
    """``(target, weight, delay)`` int64 of packed words: the target in the
    low ``tbits`` bits, the signed weight in the next ``wbits``, the delay
    (in steps) above them."""
    w = words.long() & 0xFFFFFFFF
    tgt = w & ((1 << tbits) - 1)
    wt = (w >> tbits) & ((1 << wbits) - 1)
    wt = wt - ((wt >> (wbits - 1)) << wbits)
    return tgt, wt, w >> (tbits + wbits)


def delay_deliver_ref(spikes, indptr, words, tbits: int, wbits: int,
                      pending, ptr: int) -> torch.Tensor:
    """Add the step's spikes ``[B, n]`` bool through their sources' fan-out
    into ``pending`` (in place); returns the synapse events of each lane,
    ``[B]`` int64."""
    D, B, n = pending.shape
    lane, src = spikes.nonzero(as_tuple=True)
    cnt = indptr[src + 1] - indptr[src]
    events = torch.zeros(B, dtype=torch.int64, device=spikes.device)
    events.index_add_(0, lane, cnt)
    total = int(cnt.sum()) if len(src) else 0
    if total:
        first = torch.repeat_interleave(indptr[src] - (torch.cumsum(cnt, 0)
                                                        - cnt), cnt)
        syn = first + torch.arange(total, device=spikes.device)
        tgt, wt, d = unpack(words[syn], tbits, wbits)
        slot = (ptr + d) % D
        idx = (slot * B + torch.repeat_interleave(lane, cnt)) * n + tgt
        pending.view(-1).index_add_(0, idx, wt.to(torch.int32))
    return events


def delay_step_ref(indptr, words, tbits: int, wbits: int, pending,
                   ptr: int, lif, drive, params, fixed_point: bool):
    """One step (module docstring) -> ``(lif, spikes [B, n] bool, stats)``
    with ``stats`` the lanes' ``syn_events`` and ``drive_events``, ``[B]``
    int64 each."""
    from repro_torch.core.neuron import f32s
    from repro_torch.exp.stimulus import apply_drive, count_events
    slot = pending[ptr]
    g_units = slot.to(torch.float32)
    slot.zero_()
    B = pending.shape[1]
    drive_events = torch.zeros(B, dtype=torch.int64, device=pending.device)
    if drive.counts is not None:
        # the count's units join the g channel (after it), in float32:
        # exact for integer weights
        events = count_events(drive.counts)
        drive_events = events.sum(dim=-1, dtype=torch.int64)
        g = events.to(torch.float32) * f32s(drive.counts.weight)
        if drive.g_units is not None:
            g = drive.g_units + g
        drive = drive._replace(g_units=g, counts=None)
    lif, spikes = apply_drive(lif, g_units, drive, params, fixed_point,
                              wide=True)
    syn_events = delay_deliver_ref(spikes, indptr, words, tbits, wbits,
                                   pending, ptr)
    return lif, spikes, {"syn_events": syn_events,
                         "drive_events": drive_events}


__all__ = ["delay_deliver_ref", "delay_step_ref", "unpack"]
