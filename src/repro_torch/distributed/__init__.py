"""The distributed layer: logical-axis sharding rules over a DeviceMesh and
ring attention over its ``"model"`` dimension."""
from .ring_attention import (ring_attention_sharded,
                             ring_attention_single_device)
from .sharding import (DEFAULT_RULES, ShardingRules, activate_rules,
                       current_rules, input_sharding, param_sharding, shard)

__all__ = ["DEFAULT_RULES", "ShardingRules", "activate_rules",
           "current_rules", "input_sharding", "param_sharding", "shard",
           "ring_attention_sharded", "ring_attention_single_device"]
