"""Blocked-fused engine: delivery and LIF integration fused, delivery per
synapse on the local path.

The engine has the ``integrates_lif`` capability: the step body calls
:meth:`BlockedFusedEngine.deliver_fused` instead of ``deliver`` +
``apply_drive``.  Which kernels run depends on the path:

* the local (P = 1) path (``run_trials``, ``simulate``, ``SimServer``,
  ``run_resilient`` over ``local``) runs :meth:`deliver_fused`: each delayed
  spike's fan-out, from a source-major list (``indptr``, int32 ``tgt``,
  int16 ``w``, the tile store's quantized weights), is added into an int32
  ``[B, n]`` sum with atomics, then one pass over the unpadded ``[B, n]``
  state reads and clears the sum and takes the LIF step
  (:func:`repro_torch.kernels.fanout.fanout_step`: ``fanout_scatter``,
  ``fanout_lif``).  A spike costs its own synapses (~650 B at FlyWire's
  mean fan-out) where the tile kernel streamed a 256-byte tile row for every
  live target block (~278 KB), and the state needs no row-block pads.
  The lanes' ``syn_events`` (synapse events delivered) are a counter of the
  carry's ``stats``;
* the partitioned path (``core/exchange/blocked.py``, P > 1: a sharded
  store over global source ids) keeps the fused tile kernel
  (``kernels/spike_prop/ops.py::fused_step``).

The tile store is still built, beside the fan-out list: the inherited
unfused ``deliver`` reads it, and so do the state's ``tiles_stored`` and
``occupancy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs

from ..connectome import Connectome
from .base import quantized_in_weights, register
from .blocked import BlockedEngine, BlockedState

#: The carry's counter this engine adds a step, ``[B]`` int64.
STATS = ("syn_events",)


class _Scratch:
    """What a state keeps on the device across steps: the scatter's sums
    (all zero between steps) and the last step's counters, until the
    exchange scheme takes them (:meth:`BlockedFusedEngine.step_stats`)."""

    def __init__(self):
        from repro_torch.kernels.fanout import Accumulator
        self.acc = Accumulator()
        self.stats: dict | None = None


@dataclasses.dataclass(frozen=True)
class BlockedFusedState(BlockedState):
    indptr: torch.Tensor | None = None    # [n+1] int64 fan-out row pointers
    tgt: torch.Tensor | None = None       # [nnz] int32 target a synapse
    w: torch.Tensor | None = None         # [nnz] int16 quantized weight
    scratch: _Scratch = dataclasses.field(default_factory=_Scratch,
                                          compare=False, repr=False)


def build_fanout(c: Connectome, w, device
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The target-major CSR with weights ``w`` as a source-major list on
    ``device``: ``(indptr [n+1] int64, tgt [nnz] int32, w [nnz] int16)``, a
    stable sort of the synapses by source, made on the device."""
    n = c.n
    src = torch.from_numpy(np.asarray(c.in_indices, np.int32)).to(device)
    order = torch.sort(src, stable=True).indices
    tgt = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=device),
        torch.from_numpy(np.asarray(c.fan_in, np.int64)).to(device))
    w16 = torch.from_numpy(np.asarray(w)).to(device).to(torch.int16)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return indptr, tgt[order].contiguous(), w16[order].contiguous()


@register
class BlockedFusedEngine(BlockedEngine):
    name = "blocked_fused"
    integrates_lif = True        # step body must skip its own LIF update

    def build(self, c: Connectome, cfg, device) -> BlockedFusedState:
        from repro_torch.kernels.fanout import check_fanout
        tiles = super().build(c, cfg, device)    # checks the int16 weights
        with obs.span("build", what="fanout"):
            indptr, tgt, w = build_fanout(c, quantized_in_weights(c, cfg),
                                          device)
            check_fanout(indptr)
        return BlockedFusedState(
            **{f.name: getattr(tiles, f.name)
               for f in dataclasses.fields(tiles)},
            indptr=indptr, tgt=tgt, w=w)

    def init_stats(self, lanes: int, device) -> dict:
        return {k: torch.zeros(lanes, dtype=torch.int64, device=device)
                for k in STATS}

    def deliver_fused(self, state: BlockedFusedState, spikes, lif, drive,
                      cfg):
        """spikes [B, n] bool, lif LIFState, drive StimDrive -> (new_lif,
        spikes [B, n] bool, dropped [B]): two kernel launches for all lanes
        of a trial batch.  The step's ``syn_events`` wait in the state for
        :meth:`step_stats`."""
        from repro_torch.kernels.fanout import fanout_step
        new_lif, out, events = fanout_step(
            state.indptr, state.tgt, state.w, spikes, lif, drive, cfg.params,
            cfg.fixed_point, state.scratch.acc)
        state.scratch.stats = {"syn_events": events}
        return new_lif, out, torch.zeros(spikes.shape[:-1], dtype=torch.int32,
                                         device=spikes.device)

    def step_stats(self, state: BlockedFusedState, lanes: int, device
                   ) -> dict:
        """The counters of the last :meth:`deliver_fused` on ``state``,
        handed over once (zeros when none is waiting).  ``deliver_fused``
        keeps the protocol's three results, which its callers unpack (the
        benchmark's tests wrap it), so its counters come through here."""
        stats, state.scratch.stats = state.scratch.stats, None
        return self.init_stats(lanes, device) if stats is None else stats


__all__ = ["BlockedFusedEngine", "BlockedFusedState", "STATS",
           "build_fanout"]
