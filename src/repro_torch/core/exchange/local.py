"""Local scheme: the degenerate P=1 exchange (no collectives).

Every neuron lives on one partition, so the exchange is the identity and
delivery is whatever the registered delivery engine does.
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
        return delayed

    def deliver(self, state, payload, delayed, sim, cap, topo: Topology):
        from ..engines import get_engine
        g, drop = get_engine(sim.engine).deliver(state, payload, sim)
        return g, drop, {}

    # -- fused-integration capability: delegated to the engine registry --

    def fuses_lif(self, sim) -> bool:
        from ..engines import engine_integrates_lif
        return engine_integrates_lif(sim.engine)

    def deliver_fused(self, state, payload, delayed, lif, drive, sim, cap,
                      topo: Topology):
        from ..engines import get_engine
        new_lif, spikes, drop = get_engine(sim.engine).deliver_fused(
            state, payload, lif, drive, sim)
        return new_lif, spikes, drop, {}
