"""Plain version of the fan-out step, for tensors on the CPU.

No counterpart in ``repro/kernels/``: the JAX package delivers from its
128 x 128 tile store (``fused_deliver_lif_pallas``).  One step of the
``blocked_fused`` engine on the local path, per synapse:

1. each spike of lane b from source s adds, for every synapse of s with
   target i and weight w (the source-major list ``indptr``, ``tgt``,
   ``w``), w into the lane's int32 sum at i;
2. the sum, as float32, is the delivered input of
   :func:`repro_torch.exp.stimulus.apply_drive`, which applies the drive
   and takes the LIF step (Q19.12 with its narrow products).
"""

from __future__ import annotations

import torch


def fanout_sums(spikes, indptr, tgt, w):
    """``(sums [B, n] int32, syn_events [B] int64)`` of the spikes ``[B, n]``
    bool through their sources' fan-out."""
    B, n = spikes.shape
    lane, src = spikes.nonzero(as_tuple=True)
    cnt = indptr[src + 1] - indptr[src]
    events = torch.zeros(B, dtype=torch.int64, device=spikes.device)
    events.index_add_(0, lane, cnt)
    sums = torch.zeros(B * n, dtype=torch.int32, device=spikes.device)
    total = int(cnt.sum()) if len(src) else 0
    if total:
        first = torch.repeat_interleave(indptr[src] - (torch.cumsum(cnt, 0)
                                                        - cnt), cnt)
        syn = first + torch.arange(total, device=spikes.device)
        idx = torch.repeat_interleave(lane, cnt) * n + tgt[syn].long()
        sums.index_add_(0, idx, w[syn].to(torch.int32))
    return sums.reshape(B, n), events


def fanout_step_ref(indptr, tgt, w, spikes, lif, drive, params,
                    fixed_point: bool):
    """One step (module docstring) -> ``(lif, spikes [B, n] bool,
    syn_events [B] int64)``."""
    from repro_torch.exp.stimulus import apply_drive
    sums, events = fanout_sums(spikes, indptr, tgt, w)
    lif, out = apply_drive(lif, sums.to(torch.float32), drive, params,
                           fixed_point)
    return lif, out, events


__all__ = ["fanout_step_ref", "fanout_sums"]
