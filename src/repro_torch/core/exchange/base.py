"""Exchange-scheme protocol, registry and build memoization.

Counterpart of ``repro/core/exchange/base.py``.  An *exchange scheme*
moves spikes between partitions and turns them into each partition's
local drive.  The monolithic simulation is the P=1 ``local`` scheme.

The reference's ``exchange`` runs its collective (``all_gather`` over a
named axis) itself, inside a step that is vmapped or sharded over the
partitions.  Here a step of a partition is plain code, so the collective
is lifted out of the scheme: ``exchange`` returns ``(sent, kept)``, the
tensor this partition contributes to the collective and what it keeps for
itself; the caller gathers every partition's ``sent`` with
:func:`all_gather` (partition order, as ``all_gather`` lays them out) and
hands ``(gathered, kept)`` to ``deliver`` (or, when ``fuses_lif(sim)``,
to ``deliver_fused``, which also integrates).  ``Topology.index`` is this
partition's place on the axis, which the reference reads with
``axis_index``.

Trial batches: every per-neuron tensor a scheme sees or returns has the
lanes as leading axes (``delayed`` [B, U], ``g_units`` [B, U], ``dropped``
and each stats counter [B]), as the reference's scheme sees one lane
under ``vmap``; a lane's exchange reaches only that lane of the other
partitions.  Without the leading axis a call is one lane.

A scheme may also offer the step-aware ``exchange_at(state, delayed, cap,
topo, t)`` (the ``faulty`` wrapper does); the step then calls it with the
absolute step in place of ``exchange``.

The collective has two forms.  :func:`all_gather` is the emulated one,
over the list of every partition's ``sent`` in one process.
:func:`all_gather_group` is the multi-process one: each rank (one
partition, :class:`repro_torch.core.distributed.CoreMesh`) contributes
its own ``sent`` and receives every partition's, laid out in partition
order exactly as the emulated list is, so a scheme's ``deliver`` cannot
tell the two apart.  ``build(source, sim, cap, device, parts=None)``
builds every partition's state, stacked on a leading axis, or with
``parts`` only those partitions' (a rank builds its own).
"""

from __future__ import annotations

import weakref
from typing import Any, NamedTuple, Protocol, runtime_checkable

import torch

class Topology(NamedTuple):
    """Static partition geometry threaded through every scheme call."""

    n_parts: int          # P
    part_size: int        # U: local neuron slots (n itself when P == 1)
    axis: str | None      # collective axis name (None for ``local``)
    index: int = 0        # this partition's index on the axis

    @property
    def n_global(self) -> int:
        return self.n_parts * self.part_size


@runtime_checkable
class ExchangeScheme(Protocol):
    """One partition-exchange strategy (see module docstring)."""

    name: str

    def build(self, source: Any, sim, cap, device, parts=None) -> Any:
        ...

    def exchange(self, state: Any, delayed, cap, topo: Topology
                 ) -> tuple[torch.Tensor, Any]:
        """Local delayed spikes [..., U] -> (sent, kept)."""
        ...

    def deliver(self, state: Any, payload: Any, delayed, sim, cap,
                topo: Topology):
        """(gathered, kept) -> (g_units [..., U] f32, dropped [...] i32,
        stats dict of [...] counters)."""
        ...

    def init_stats(self) -> dict:
        return {}


def all_gather(sent: list[torch.Tensor]) -> torch.Tensor:
    """The emulated collective: every partition's contribution, in
    partition order, along the last axis, lane by lane (one partition: its
    own)."""
    return sent[0] if len(sent) == 1 else torch.cat(sent, dim=-1)


def all_gather_group(sent: list[torch.Tensor], mesh) -> torch.Tensor:
    """The process-group collective: this rank's contribution in (the
    list of its one partition's), every rank's out, in rank (=
    partition) order along the last axis, as :func:`all_gather` lays out
    the emulated list (``mesh.all_gather``: a send to and a receive from
    each peer, :func:`repro_torch.core.distributed.staged_all_gather`)."""
    (mine,) = sent
    return all_gather(mesh.all_gather(mine))


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
    raise ValueError(f"unknown exchange scheme {name!r}; "
                     f"available: {sorted(_REGISTRY)}")


def available_schemes() -> list[str]:
    return sorted(_REGISTRY)


_BUILD_CACHE: dict[tuple[int, str], tuple] = {}


def memoized_build(source: Any, key: str, build_fn):
    """Memoize a build on the identity of ``source`` (a DCSR snapshot,
    immutable): the result is kept while ``source`` lives and evicted when
    it is garbage-collected.  Device-resident results name their device
    in ``key``."""
    k = (id(source), key)
    hit = _BUILD_CACHE.get(k)
    if hit is not None and hit[0]() is source:
        return hit[1]
    out = build_fn()
    try:
        ref = weakref.ref(source, lambda _r, k=k: _BUILD_CACHE.pop(k, None))
    except TypeError:
        return out
    _BUILD_CACHE[k] = (ref, out)
    return out


__all__ = ["ExchangeScheme", "Topology", "all_gather", "all_gather_group",
           "available_schemes", "get_scheme", "memoized_build",
           "register_scheme"]
