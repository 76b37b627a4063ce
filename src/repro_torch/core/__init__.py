"""Core library of the PyTorch port: connectome, LIF neuron, delivery
engines, the step loop and :func:`simulate` (counterpart of
:mod:`repro.core`, which this package never imports)."""

from .capacity import MONOLITHIC_CAPACITY, CapacityConfig
from .compress import WEIGHT_BITS, quantize_weights
from .connectome import (Connectome, cache_path, from_edges,
                         synthetic_flywire, synthetic_flywire_cached)
from .engine import (SimCarry, SimConfig, SimResult, build_synapses,
                     init_carry, resolve_device, run_steps, simulate,
                     spike_rates_hz)
from .engines import (DeliveryEngine, available_engines,
                      engine_integrates_lif, get_engine, register)
from .exchange import ExchangeScheme, Topology, available_schemes, get_scheme
from .neuron import (FLYWIRE_LIF, FLYWIRE_LIF_1MS, LIFParams, LIFState,
                     fx_to_mv, init_state, lif_step, lif_step_fx, mv_to_fx)

__all__ = [k for k in dir() if not k.startswith("_")]
