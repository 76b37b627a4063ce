"""Delivery-engine protocol and registry.

A *delivery engine* is one strategy for turning the delayed spike vector
into the per-neuron synaptic drive ``g`` (in integer weight units).  Each
engine lives in its own module under :mod:`repro_torch.core.engines` and
registers a singleton instance at import time.  ``build(c, cfg, device)``
moves the connectome onto the device once per :func:`simulate` call;
``deliver(state, spikes, cfg)`` runs every step and returns ``(g_units
[n] f32, dropped)``.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from ..connectome import Connectome

@runtime_checkable
class DeliveryEngine(Protocol):
    """One synaptic-delivery strategy (see module docstring).

    An engine that sets ``integrates_lif = True`` fuses the LIF update into
    delivery and provides ``deliver_fused(state, spikes, lif, drive, cfg)
    -> (new_lif, spikes [n] bool, dropped)``; the step body then calls it
    instead of ``deliver`` + the separate LIF update.  With counters of its
    own it also provides ``step_stats(state, lanes, device)``, the last
    ``deliver_fused``'s.

    An engine that sets ``per_synapse_delays = True`` (``delay_event``)
    delivers at each synapse's own delay: its state has a ``depth``, the
    carry holds a ring of pending input of that many slots in place of
    the ring of spikes, and the step body calls ``deliver_pending(state,
    pending, ptr, lif, drive, cfg) -> (new_lif, spikes, dropped, stats)``.
    Only the P = 1 ``local`` path runs it.

    ``init_stats(lanes, device)``, where an engine has it, gives the
    counters it adds to the carry's (``[lanes]`` int64 each) on the
    ``local`` path.
    """

    name: str

    def build(self, c: Connectome, cfg, device: torch.device) -> Any:
        ...

    def deliver(self, state: Any, spikes: torch.Tensor, cfg
                ) -> tuple[torch.Tensor, torch.Tensor]:
        ...


_REGISTRY: dict[str, DeliveryEngine] = {}


def register(cls):
    """Class decorator: instantiate and register a delivery engine."""
    inst = cls()
    if not getattr(inst, "name", None):
        raise ValueError(f"{cls.__name__} must define a non-empty .name")
    _REGISTRY[inst.name] = inst
    return cls


def get_engine(name: str) -> DeliveryEngine:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(
        f"unknown engine {name!r}; available: {sorted(_REGISTRY)}")


def available_engines() -> list[str]:
    return sorted(_REGISTRY)


def engine_integrates_lif(name: str) -> bool:
    """True iff ``name``'s engine fuses the LIF update into delivery."""
    return bool(getattr(get_engine(name), "integrates_lif", False))


def per_synapse_delays(name: str) -> bool:
    """True iff ``name``'s engine delivers into a ring of pending input."""
    return bool(getattr(get_engine(name), "per_synapse_delays", False))


def pending_depth(cfg, syn) -> int | None:
    """The slots of the pending ring that ``cfg.engine``'s built state
    ``syn`` needs, or None for an engine of the ring of spikes."""
    return syn.depth if per_synapse_delays(cfg.engine) else None


def refuse_per_synapse_delays(name: str, where: str) -> None:
    """Raise for an engine with per-synapse delays on a path that holds
    no pending ring (the partitioned runners, the server)."""
    if per_synapse_delays(name):
        raise ValueError(
            f"{where} does not run the {name!r} engine: its per-synapse "
            f"delays need the pending ring of run_trials / simulate (P = 1)")


def quantized_in_weights(c: Connectome, cfg):
    """Target-major weights with the config's optional 9-bit cap applied."""
    from ..compress import quantize_weights
    w = c.in_weights
    if cfg.quantize_bits is not None:
        w = quantize_weights(w, cfg.quantize_bits)
    return w


__all__ = ["DeliveryEngine", "available_engines", "engine_integrates_lif",
           "get_engine", "pending_depth", "per_synapse_delays",
           "quantized_in_weights", "refuse_per_synapse_delays", "register"]
