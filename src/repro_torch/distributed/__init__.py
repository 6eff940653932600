"""Mesh serving on ``torch.distributed``: the logical sharding rules, the
placement of parameters and caches, and the collectives the forward
issues at the points those rules fix. Importing this package starts no
process group."""
from repro_torch.distributed.sharding import (LOGICAL_RULES, axis_group,
                                              current_mesh, serving_rules,
                                              shard_ctx, spec_for)

__all__ = ["LOGICAL_RULES", "shard_ctx", "current_mesh", "spec_for",
           "serving_rules", "axis_group"]
