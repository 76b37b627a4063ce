"""Blocked-fused engine: delivery and LIF integration in one CUDA kernel.

Same tile store as the :mod:`blocked <repro_torch.core.engines.blocked>`
engine, but one kernel per step accumulates a target block's delivered
current in registers and applies the LIF step to it, so the current never
reaches device memory; the kernel takes the per-block spike counts of
``pad_spike_blocks`` as its gate and reads only the live source blocks'
tiles.  The engine has the ``integrates_lif``
capability: the step body calls :meth:`deliver_fused` instead of
``deliver`` + ``apply_drive``.  ``deliver`` is inherited unfused.
"""

from __future__ import annotations

import torch

from .base import register
from .blocked import BlockedEngine, BlockedState


@register
class BlockedFusedEngine(BlockedEngine):
    name = "blocked_fused"
    integrates_lif = True        # step body must skip its own LIF update

    def deliver_fused(self, state: BlockedState, spikes, lif, drive, cfg):
        """spikes [n] bool, lif LIFState, drive StimDrive ->
        (new_lif, spikes [n] bool, dropped)."""
        from repro_torch.kernels.spike_prop.ops import (fused_step,
                                                        pad_spike_blocks)
        spk_pad, nspk = pad_spike_blocks(spikes, state.n, state.n_sb)
        new_lif, out = fused_step(
            state.blk_id, state.weights, spk_pad, nspk, lif, drive, state.n,
            cfg.params, cfg.fixed_point)
        return new_lif, out, torch.zeros((), dtype=torch.int32,
                                         device=spikes.device)
