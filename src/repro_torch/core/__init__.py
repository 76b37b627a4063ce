"""Core library of the PyTorch port: connectome, LIF neuron, delivery
engines, the step loop over a batch of lanes, :func:`simulate` and the
partitioned :func:`simulate_distributed` (each the one-lane case of the
trial batches of :mod:`repro_torch.exp.trials`), the supervision layer
(:mod:`repro_torch.core.health`: chunks, checkpoints, ``run_resilient``)
with the ``faulty`` exchange scheme, and the rate-parity statistic of
:mod:`repro_torch.core.validate` (counterpart of
:mod:`repro.core`, which this package never imports)."""

from .capacity import (DISTRIBUTED_CAPACITY, MONOLITHIC_CAPACITY,
                       CapacityConfig, escalate_capacity)
from .compress import WEIGHT_BITS, quantize_weights
from .connectome import (Connectome, cache_path, from_edges, from_fanout,
                         load_flywire_parquet, synthetic_flywire,
                         synthetic_flywire_cached)
from .engine import (SimCarry, SimConfig, SimResult, build_synapses,
                     init_carry, resolve_device, run_steps, simulate,
                     spike_rates_hz)
from .engines import (DeliveryEngine, auto_capacity, available_engines,
                      engine_integrates_lif, get_engine, register)
from .dcsr import DCSR, build_dcsr, edge_cut
from .distributed import DistConfig, DistResult, simulate_distributed
from .exchange import (ExchangeFault, ExchangeScheme, FaultSpec, Topology,
                       available_schemes, configure_faulty, get_scheme)
from .health import (BackoffPolicy, HealthConfig, SimCheckpointer,
                     SimulationHealthError, run_chunked, run_resilient)
from .neuron import (FLYWIRE_LIF, FLYWIRE_LIF_1MS, LIFParams, LIFState,
                     fx_to_mv, init_state, lif_step, lif_step_fx, mv_to_fx)
from .partition import (Partitioning, even_partition, greedy_partition,
                        pad_to_uniform)
from .validate import (ParityStats, mean_rates_over_trials, parity,
                       raster_to_times)

__all__ = [k for k in dir() if not k.startswith("_")]
