"""Logical-axis sharding rules of the port (``sharding.rules``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    Rules,
    current_mesh,
    current_rules,
    logical_spec,
    shard,
    use_rules,
)
