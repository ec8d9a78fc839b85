"""Distributed-optimization helpers: logical axis rules resolved onto a
``DeviceMesh`` as DTensor placements (``sharding.py``) and int8 gradient
compression with its all-reduce (``compression.py``)."""

from repro_torch.distributed.sharding import (
    AxisRules,
    RULE_SETS,
    axis_rules,
    constrain,
    current_mesh,
    current_rules,
    logical_to_spec,
    mesh_context,
    named_sharding,
)

__all__ = [
    "AxisRules", "RULE_SETS", "axis_rules", "constrain", "current_mesh",
    "current_rules", "logical_to_spec", "mesh_context", "named_sharding",
]
