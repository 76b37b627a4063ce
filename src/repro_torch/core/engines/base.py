"""Delivery-engine protocol and registry.

A *delivery engine* is one strategy for turning the delayed spike vector
into the per-neuron synaptic drive ``g`` (in integer weight units).  Each
engine lives in its own module under :mod:`repro_torch.core.engines` and
registers a singleton instance at import time.  ``build(c, cfg, device)``
moves the connectome onto the device once per :func:`simulate` call;
``deliver(state, spikes, cfg)`` runs every step and returns ``(g_units
[n] f32, dropped)``.

Engines of the reference that are not ported yet are known by name, so
that asking for one raises ``NotImplementedError`` instead of a lookup
error.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from ..connectome import Connectome

#: Engines of ``repro.core.engines`` that this package does not have yet.
NOT_PORTED = ("binned", "dense", "ell", "event")


@runtime_checkable
class DeliveryEngine(Protocol):
    """One synaptic-delivery strategy (see module docstring).

    An engine that sets ``integrates_lif = True`` fuses the LIF update into
    delivery and provides ``deliver_fused(state, spikes, lif, drive, cfg)
    -> (new_lif, spikes [n] bool, dropped)``; the step body then calls it
    instead of ``deliver`` + the separate LIF update.
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
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to PyTorch yet; ported: "
            f"{sorted(_REGISTRY)}")
    raise ValueError(
        f"unknown engine {name!r}; available: {sorted(_REGISTRY)}")


def available_engines() -> list[str]:
    return sorted(_REGISTRY)


def engine_integrates_lif(name: str) -> bool:
    """True iff ``name``'s engine fuses the LIF update into delivery."""
    return bool(getattr(get_engine(name), "integrates_lif", False))


def quantized_in_weights(c: Connectome, cfg):
    """Target-major weights with the config's optional 9-bit cap applied."""
    from ..compress import quantize_weights
    w = c.in_weights
    if cfg.quantize_bits is not None:
        w = quantize_weights(w, cfg.quantize_bits)
    return w


__all__ = ["DeliveryEngine", "NOT_PORTED", "available_engines",
           "engine_integrates_lif", "get_engine", "quantized_in_weights",
           "register"]
