"""Connectome LIF simulation over pluggable delivery engines.

Counterpart of ``repro/core/engine.py``.  :func:`simulate` builds the
engine's synaptic state on the device once, sets up the carry (LIF state,
the ring buffer of the uniform 1.8 ms synaptic delay, the PRNG key,
counters) and runs the step loop of :mod:`repro_torch.core.step` through
the P=1 ``local`` exchange scheme.

It runs on the CUDA device unless the caller names another device; with
no device named and no CUDA device present it raises, so a run never
lands on the CPU by accident.  The reference's supervision features
(``chunk_steps``, checkpoints, ``cfg.health``) and its telemetry are not
ported yet: asking for them raises ``NotImplementedError``, and
``SimResult.stats`` is ``{}``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as prng

from .capacity import MONOLITHIC_CAPACITY, CapacityConfig, merge_legacy_capacity
from .connectome import Connectome
from .engines import available_engines, get_engine
from .neuron import LIFParams, LIFState, f32, init_state
from .step import SimCarry, scan_steps


@dataclasses.dataclass(frozen=True)
class SimConfig:
    params: LIFParams = LIFParams()
    engine: str = "csr"             # see repro_torch.core.engines
    fixed_point: bool = False
    quantize_bits: Optional[int] = None   # 9 = Loihi; None = raw weights
    # Legacy stimulus fields: consumed by repro_torch.exp.legacy_stimulus
    # when simulate() is called without an explicit stimulus.
    poisson_to_v: bool = True       # True = Brian2 semantics; False = Loihi approx
    poisson_rate_hz: float = 150.0
    poisson_weight: float = 180.0   # weight units delivered per Poisson event
    background_rate_hz: float = 0.0  # scaling-study probabilistic spiking
    # Deprecated capacity shims -> capacity (CapacityConfig)
    spike_capacity: Optional[int] = None
    syn_budget: Optional[int] = None
    block_capacity: Optional[int] = None
    ell_width_cap: int = 4096        # SSD fan-in cap (ell engine, not ported)
    collect_raster: bool = False     # deprecated: use ProbeSpec(raster=True)
    capacity: Optional[CapacityConfig] = None   # event-path static budgets
    health: Optional[Any] = None     # in-scan sentinels: not ported yet

    def __post_init__(self):
        cap = merge_legacy_capacity(
            self.capacity, self.spike_capacity, self.syn_budget,
            self.block_capacity, MONOLITHIC_CAPACITY, "SimConfig")
        object.__setattr__(self, "capacity", cap)
        for f in ("spike_capacity", "syn_budget", "block_capacity"):
            object.__setattr__(self, f, None)
        if self.collect_raster:
            warnings.warn(
                "SimConfig(collect_raster=True) is deprecated; pass "
                "probes=ProbeSpec(raster=True) instead",
                DeprecationWarning, stacklevel=3)


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when none is named; raises when none
    is named and CUDA is absent (no silent CPU run)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: repro_torch runs on the GPU "
                           "unless a device is named (device='cpu' runs the "
                           "plain PyTorch versions of the kernels)")
    return torch.device("cuda")


def build_synapses(c: Connectome, cfg: SimConfig, device=None) -> Any:
    """Build the engine's synaptic state on ``device``; pass it back to
    :func:`simulate` via ``syn=`` to reuse it across runs."""
    return get_engine(cfg.engine).build(c, cfg, resolve_device(device))


class SimResult(NamedTuple):
    counts: torch.Tensor
    state: LIFState
    dropped: torch.Tensor
    raster: torch.Tensor | None
    records: dict          # ProbeSpec-selected [T, ...] tensors
    stats: dict = {}       # scheme + health counters (none ported yet)


def init_carry(n: int, cfg: SimConfig, stimulus, seed: int,
               device) -> SimCarry:
    return SimCarry(
        lif=init_state(n, cfg.params, cfg.fixed_point, device=device),
        ring=torch.zeros((cfg.params.delay_steps, n), dtype=torch.bool,
                         device=device),
        ptr=0,
        key=prng.PRNGKey(seed, device=device),
        counts=torch.zeros(n, dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
        stim=stimulus.init_state(n),
        stats={},
    )


def run_steps(syn, carry: SimCarry, stim, cfg: SimConfig, probes,
              t_steps: int, n: int, t0: int = 0,
              partitionable: bool = True) -> tuple[SimCarry, dict]:
    """Run ``t_steps`` steps from ``carry`` through the ``local`` scheme;
    the counterpart of the reference's ``_run_scan``."""
    from .exchange import Topology, get_scheme
    return scan_steps(get_scheme("local"), syn, carry, stim, cfg,
                      cfg.capacity, Topology(1, n, axis=None), probes,
                      t_steps, t0=t0, partitionable=partitionable)


def _resolve_stimulus(cfg: SimConfig, n: int, sugar_neurons, stimulus):
    if stimulus is not None:
        if sugar_neurons is not None:
            raise ValueError(
                "pass either sugar_neurons (legacy drive) or stimulus, "
                "not both — an explicit stimulus ignores sugar_neurons")
        return stimulus
    from repro_torch.exp.stimulus import legacy_stimulus
    sugar_idx = None
    if sugar_neurons is not None:
        warnings.warn(
            "sugar_neurons= is deprecated; pass stimulus= instead (e.g. "
            "repro_torch.exp.PoissonDrive(idx=...) or legacy_stimulus(cfg, "
            "n, sugar_idx))", DeprecationWarning, stacklevel=3)
        sugar_idx = np.asarray(sugar_neurons).astype(np.int32)
    return legacy_stimulus(cfg, n, sugar_idx)


def _resolve_probes(cfg: SimConfig, probes):
    if probes is not None:
        return probes
    from repro_torch.exp.probes import ProbeSpec
    return ProbeSpec(raster=cfg.collect_raster)


def simulate(
    c: Connectome,
    cfg: SimConfig,
    t_steps: int,
    sugar_neurons: np.ndarray | None = None,
    seed: int = 0,
    syn: Any | None = None,
    stimulus: Any | None = None,
    probes: Any | None = None,
    chunk_steps: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    async_checkpoint: bool = False,
    *,
    device=None,
    partitionable: bool = True,
) -> SimResult:
    """Run ``t_steps`` of the network; returns per-neuron spike counts (the
    paper's validation statistic) plus any probe records.

    ``cfg.engine`` selects a registered delivery engine; ``syn``
    optionally supplies a state from :func:`build_synapses` (on
    ``device``).  ``stimulus`` is a stimulus of :mod:`repro_torch.exp`
    (default: the legacy drive reconstructed from ``cfg`` and
    ``sugar_neurons``); ``probes`` a :class:`repro_torch.exp.ProbeSpec`.
    ``device`` defaults to CUDA; ``partitionable`` is the threefry mode
    that ``seed``'s stream follows (JAX's ``jax_threefry_partitionable``).
    """
    if (chunk_steps is not None or checkpoint_dir is not None or resume
            or async_checkpoint):
        raise NotImplementedError(
            "chunk_steps, checkpoint_dir, resume and async_checkpoint are "
            "not ported to PyTorch yet")
    if cfg.health is not None:
        raise NotImplementedError("SimConfig.health is not ported yet")
    device = resolve_device(device)
    n = c.n
    if syn is None:
        syn = build_synapses(c, cfg, device)
    stimulus = _resolve_stimulus(cfg, n, sugar_neurons, stimulus).to(device)
    probes = _resolve_probes(cfg, probes)
    carry = init_carry(n, cfg, stimulus, seed, device)
    carry, records = run_steps(syn, carry, stimulus, cfg, probes, t_steps, n,
                               partitionable=partitionable)
    return SimResult(counts=carry.counts, state=carry.lif,
                     dropped=carry.dropped, raster=records.get("raster"),
                     records=records, stats={})


def spike_rates_hz(counts: torch.Tensor, t_steps: int, dt_ms: float
                   ) -> torch.Tensor:
    return counts.to(torch.float32) / f32(t_steps * dt_ms * 1e-3, counts)


__all__ = ["SimCarry", "SimConfig", "SimResult", "available_engines",
           "build_synapses", "init_carry", "resolve_device", "run_steps",
           "simulate", "spike_rates_hz"]
