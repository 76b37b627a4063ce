"""Sharding rules, the shard layout, activation policy and the GPipe
schedule over a :class:`repro_torch.launch.mesh.Mesh` of ranks."""

from .sharding import (DEFAULT_RULES, ShardingRules, batch_spec,
                       logical_to_spec, make_param_shardings, solve_rules)

__all__ = ["ShardingRules", "DEFAULT_RULES", "make_param_shardings",
           "batch_spec", "logical_to_spec", "solve_rules"]
