"""flywire — the paper's own workload: the FlyWire connectome LIF network
(139,255 neurons / ~15M condensed synapses) with the sugar-neuron
experiment.  Counterpart of ``repro/configs/flywire.py``; the configured
engine is the reference's (``event``, not ported yet), so a run of the
port names its engine with ``dataclasses.replace(CONFIG.sim, engine=...)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.connectome import FLYWIRE_N_NEURONS
from repro_torch.core.engine import SimConfig
from repro_torch.core.neuron import FLYWIRE_LIF


@dataclasses.dataclass(frozen=True)
class FlyWireConfig:
    n_neurons: int = FLYWIRE_N_NEURONS
    target_synapses: int = 15_000_000
    n_sugar: int = 20
    sugar_rate_hz: float = 150.0
    t_sim_ms: float = 1000.0
    sim: SimConfig = SimConfig(params=FLYWIRE_LIF, engine="event",
                               quantize_bits=9, fixed_point=True,
                               poisson_to_v=False)

    @property
    def t_steps(self) -> int:
        return int(round(self.t_sim_ms / self.sim.params.dt))

    def sugar_neurons(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.choice(self.n_neurons, self.n_sugar, replace=False)


CONFIG = FlyWireConfig()
SMOKE = FlyWireConfig(n_neurons=2000, target_synapses=60_000, t_sim_ms=50.0)
