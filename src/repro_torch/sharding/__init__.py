"""Logical-axis -> mesh-axis sharding rules and their ``DeviceMesh`` placements."""
from repro_torch.sharding.rules import (
    AxisRules,
    MeshSharding,
    batch_spec,
    cache_shardings,
    default_rules,
    param_shardings,
    placements,
    spec_for_axes,
)

__all__ = [
    "AxisRules",
    "MeshSharding",
    "batch_spec",
    "cache_shardings",
    "default_rules",
    "param_shardings",
    "placements",
    "spec_for_axes",
]
