"""Exchange-scheme protocol and registry.

Counterpart of ``repro/core/exchange/base.py``.  An *exchange scheme*
moves spikes between partitions and turns them into each partition's
local drive.  Per step the step body (:mod:`repro_torch.core.step`) calls
``exchange`` and then ``deliver`` (or, when ``fuses_lif(sim)``,
``deliver_fused``, which also integrates).  The monolithic simulation is
the P=1 ``local`` scheme.  The reference's partitioned schemes
(``bitmap``, ``event``, ``blocked``, ``faulty``) are not ported yet;
asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Protocol, runtime_checkable

#: Schemes of ``repro.core.exchange`` that this package does not have yet.
NOT_PORTED = ("bitmap", "blocked", "event", "faulty")


class Topology(NamedTuple):
    """Static partition geometry threaded through every scheme call."""

    n_parts: int          # P
    part_size: int        # U: local neuron slots (n itself when P == 1)
    axis: str | None      # collective axis name (None for ``local``)

    @property
    def n_global(self) -> int:
        return self.n_parts * self.part_size


@runtime_checkable
class ExchangeScheme(Protocol):
    """One partition-exchange strategy (see module docstring)."""

    name: str

    def build(self, source: Any, sim, cap, device) -> Any:
        ...

    def exchange(self, state: Any, delayed, cap, topo: Topology) -> Any:
        ...

    def deliver(self, state: Any, payload: Any, delayed, sim, cap,
                topo: Topology):
        """Payload -> (g_units [U] f32, dropped i32, stats dict)."""
        ...

    def init_stats(self) -> dict:
        return {}


_REGISTRY: dict[str, ExchangeScheme] = {}


def register_scheme(cls):
    """Class decorator: instantiate and register an exchange scheme."""
    inst = cls()
    if not getattr(inst, "name", None):
        raise ValueError(f"{cls.__name__} must define a non-empty .name")
    _REGISTRY[inst.name] = inst
    return cls


def get_scheme(name: str) -> ExchangeScheme:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"exchange scheme {name!r} is not ported to PyTorch yet")
    raise ValueError(f"unknown exchange scheme {name!r}; "
                     f"available: {sorted(_REGISTRY)}")


def available_schemes() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["ExchangeScheme", "NOT_PORTED", "Topology", "available_schemes",
           "get_scheme", "register_scheme"]
