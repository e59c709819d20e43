"""Partition rules of the port (counterpart of ``repro.sharding``): specs
from shapes and mesh sizes alone; ``ShardPlan`` places tensors on a mesh
of devices and ``collectives`` moves them between its positions."""
from repro_torch.sharding.rules import (ShardDecision, ShardLog, batch_axes,
                                        batch_specs, cache_specs, check_plan,
                                        explain, param_spec, params_specs)
from repro_torch.sharding.plan import (Sharded, ShardPlan, make_shard_plan,
                                       place)

__all__ = ["ShardDecision", "ShardLog", "batch_axes", "batch_specs",
           "cache_specs", "check_plan", "explain", "param_spec",
           "params_specs", "Sharded", "ShardPlan", "make_shard_plan", "place"]
