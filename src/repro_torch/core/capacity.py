"""One capacity vocabulary for every event-driven path.

Copy of the parts of ``repro/core/capacity.py`` that ``SimConfig`` and
``DistConfig`` carry: the monolithic ``event`` engine and the partitioned
``event`` and ``blocked`` exchange schemes read the budgets.
``escalate_capacity`` belongs to the supervision layer, not ported yet.
"""

from __future__ import annotations

import dataclasses
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


__all__ = ["CapacityConfig", "DISTRIBUTED_CAPACITY", "MONOLITHIC_CAPACITY",
           "merge_legacy_capacity"]
