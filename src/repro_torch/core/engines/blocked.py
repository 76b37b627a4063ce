"""Blocked engine: block-gated spike delivery through the CUDA kernel.

Synapses are grouped into dense 128 x 128 int16 tiles, one per nonempty
(target block, source block) pair; per step the kernel
(:func:`repro_torch.kernels.spike_prop.kernel.spike_deliver_tiles`) skips
every tile whose source block emitted no spikes, and reads only the
spiking columns of the others.  The tile store is built onto the device
once per ``build`` and stays there; the per-step ``deliver`` moves only
the spike vector.  On the CPU the wrapper runs its plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from ..connectome import Connectome
from .base import quantized_in_weights, register


@dataclasses.dataclass(frozen=True)
class BlockedState:
    blk_id: torch.Tensor              # [n_tb, E] int32 source block per tile
    weights: torch.Tensor             # [n_tb, E, SRC_BLK, TGT_BLK] int16
    n: int = 0
    n_sb: int = 0
    occupancy: float = 0.0
    tiles_stored: int = 0


@register
class BlockedEngine:
    name = "blocked"

    def build(self, c: Connectome, cfg, device) -> BlockedState:
        from repro_torch.kernels.spike_prop.ops import build_blocked
        w = quantized_in_weights(c, cfg)
        bs = build_blocked(c, quantized=w if cfg.quantize_bits else None,
                           device=device)
        return BlockedState(
            blk_id=bs.blk_id, weights=bs.weights, n=bs.n, n_sb=bs.n_sb,
            occupancy=bs.occupancy, tiles_stored=bs.tiles_stored)

    def deliver(self, state: BlockedState, spikes: torch.Tensor, cfg):
        from repro_torch.kernels.spike_prop.kernel import spike_deliver_tiles
        from repro_torch.kernels.spike_prop.ops import pad_spike_blocks
        spk_pad, nspk = pad_spike_blocks(spikes, state.n, state.n_sb)
        out = spike_deliver_tiles(state.blk_id, state.weights, spk_pad, nspk)
        return (out.reshape(-1)[:state.n],
                torch.zeros((), dtype=torch.int32, device=spikes.device))
