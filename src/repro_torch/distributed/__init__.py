"""repro_torch.distributed — logical-axis sharding rules as DTensor
placements."""
from .sharding import (  # noqa: F401
    ShardingRules,
    active_rules,
    constrain,
    default_rules,
    local_shape,
    placement_leaves,
    placements_for,
    rules_for_config,
    use_rules,
)
