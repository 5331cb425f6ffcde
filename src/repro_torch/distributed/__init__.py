"""Sharding over a mesh of devices: the LM's logical-axis rules and where
a global value's blocks live, the sessions mesh, the collectives (within
a process, and across the processes of a joined job) and gradient
synchronization (port of ``repro.distributed``)."""
from repro_torch.distributed.sharding import (SESSIONS_AXIS, AxisRules, Mesh,
                                              NamedSharding, PartitionSpec,
                                              PerShard, Placed, ShardLayout,
                                              all_gather, all_to_all,
                                              axis_index, axis_rules,
                                              current_rules, make_rules,
                                              pmax, pmean, ppermute, psum,
                                              row_blocks, rules_for,
                                              sessions_sharding, shard)

__all__ = ["SESSIONS_AXIS", "Mesh", "PerShard", "row_blocks",
           "sessions_sharding", "psum", "pmax", "pmean", "ppermute",
           "all_gather", "all_to_all", "axis_index", "AxisRules",
           "PartitionSpec", "NamedSharding", "Placed", "ShardLayout",
           "axis_rules", "current_rules", "make_rules", "rules_for",
           "shard"]
