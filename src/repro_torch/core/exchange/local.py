"""Local scheme: the degenerate P=1 exchange (no collectives).

Every neuron lives on one partition, so the exchange sends the delayed
spikes to itself and delivery is whatever the registered delivery engine
does.  It is the one scheme that runs an engine with per-synapse delays
(``deliver_pending``: the engine's step on the carry's pending ring).  An
engine's counters (its ``init_stats``, which the carry starts from) pass
through: ``deliver_pending`` returns them, and after ``deliver_fused`` the
engine's ``step_stats`` hands over the step's.
"""

from __future__ import annotations

from .base import Topology, register_scheme


@register_scheme
class LocalExchange:
    name = "local"

    def build(self, c, sim, cap, device):
        from ..engines import get_engine
        return get_engine(sim.engine).build(c, sim, device)

    def init_stats(self) -> dict:
        return {}

    def exchange(self, state, delayed, cap, topo: Topology):
        return delayed, None

    def deliver(self, state, payload, delayed, sim, cap, topo: Topology):
        from ..engines import get_engine
        g, drop = get_engine(sim.engine).deliver(state, payload[0], sim)
        return g, drop, {}

    # -- fused-integration capability: delegated to the engine registry --

    def fuses_lif(self, sim) -> bool:
        from ..engines import engine_integrates_lif
        return engine_integrates_lif(sim.engine)

    def deliver_pending(self, state, pending, ptr, lif, drive, sim, cap,
                        topo: Topology):
        from ..engines import get_engine
        return get_engine(sim.engine).deliver_pending(state, pending, ptr,
                                                      lif, drive, sim)

    def deliver_fused(self, state, payload, delayed, lif, drive, sim, cap,
                      topo: Topology):
        from ..engines import get_engine
        engine = get_engine(sim.engine)
        new_lif, spikes, drop = engine.deliver_fused(state, payload[0], lif,
                                                     drive, sim)
        take = getattr(engine, "step_stats", None)
        stats = ({} if take is None
                 else take(state, spikes.shape[0], spikes.device))
        return new_lif, spikes, drop, stats
