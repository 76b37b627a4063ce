"""One capacity vocabulary for every event-driven path.

Counterpart of ``repro/core/capacity.py``: the budgets that ``SimConfig``
and ``DistConfig`` carry (the monolithic ``event`` engine and the
partitioned ``event`` and ``blocked`` exchange schemes read them), and
:func:`escalate_capacity`, which the supervisor
(:func:`repro_torch.core.health.run_resilient`) and the serving layer
apply after a drop-rate breach.
"""

from __future__ import annotations

import dataclasses
import math
import warnings


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Joint static-shape provisioning for the event-driven paths.

    ``spike_capacity`` (K) bounds active neurons per step (per partition
    on the partitioned path), ``syn_budget`` (S_cap) bounds delivered
    synapses per step, ``block_capacity`` (B_cap) bounds active 128-blocks
    in the hierarchical compaction (0 = derive from K).  Overruns are
    counted (``dropped``), never silent.
    """

    spike_capacity: int = 512
    syn_budget: int = 65_536
    block_capacity: int = 0


#: Historical per-config defaults, preserved through the deprecation shims.
MONOLITHIC_CAPACITY = CapacityConfig()
DISTRIBUTED_CAPACITY = CapacityConfig(spike_capacity=256, syn_budget=32_768)


def merge_legacy_capacity(capacity: CapacityConfig | None,
                          spike_capacity: int | None,
                          syn_budget: int | None,
                          block_capacity: int | None,
                          default: CapacityConfig,
                          owner: str) -> CapacityConfig:
    """Resolve a config's capacity from the new field + the deprecated
    per-field shims; the shims warn only when they change the value."""
    cap = capacity if capacity is not None else default
    legacy = {"spike_capacity": spike_capacity, "syn_budget": syn_budget,
              "block_capacity": block_capacity}
    changed = {k: v for k, v in legacy.items()
               if v is not None and v != getattr(cap, k)}
    if changed:
        # stacklevel: warn -> merge -> __post_init__ -> generated __init__
        # -> the caller's construction site
        warnings.warn(
            f"{owner}({', '.join(sorted(changed))}=...) is deprecated; pass "
            f"{owner}(capacity=CapacityConfig(...)) instead",
            DeprecationWarning, stacklevel=4)
        cap = dataclasses.replace(cap, **changed)
    return cap


def escalate_capacity(cap: CapacityConfig | None,
                      factor: float = 2.0) -> CapacityConfig | None:
    """A larger :class:`CapacityConfig` after a drop-rate breach: every
    budget scaled by ``factor`` and rounded up, so repeated escalations
    converge geometrically to a lossless provisioning.  ``None`` passes
    through (no base capacity to escalate: the supervisor then surfaces
    the breach instead of looping)."""
    if cap is None:
        return None
    if factor <= 1.0:
        raise ValueError(f"escalation factor must exceed 1, got {factor}")

    def up(x):
        return int(math.ceil(x * factor))
    return CapacityConfig(
        spike_capacity=up(cap.spike_capacity),
        syn_budget=up(cap.syn_budget),
        block_capacity=up(cap.block_capacity) if cap.block_capacity else 0)


__all__ = ["CapacityConfig", "DISTRIBUTED_CAPACITY", "MONOLITHIC_CAPACITY",
           "escalate_capacity", "merge_legacy_capacity"]
