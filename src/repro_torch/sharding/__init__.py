"""Partition rules of the port (counterpart of ``repro.sharding``): specs
from shapes and mesh sizes alone.  Placing tensors on a mesh (``ShardPlan``,
``make_shard_plan``) is ROADMAP queue 1, item 5."""
from repro_torch.sharding.rules import (ShardDecision, ShardLog, batch_axes,
                                        batch_specs, cache_specs, check_plan,
                                        explain, param_spec, params_specs)

__all__ = ["ShardDecision", "ShardLog", "batch_axes", "batch_specs",
           "cache_specs", "check_plan", "explain", "param_spec",
           "params_specs"]
