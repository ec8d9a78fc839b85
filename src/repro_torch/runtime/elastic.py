"""Elastic re-meshing: restart a run on a different device count.

The port of ``repro/runtime/elastic.py``. Checkpoints store full (unsharded)
arrays per parameter (checkpoint/ckpt.py), so elasticity reduces to
re-deriving the sharding tree for the NEW mesh and placing each leaf on
restore (``CheckpointManager.restore(shardings=...)``) — `replan` computes
that tree and validates feasibility (batch divisibility, degraded axes). At
1000+ nodes this is the "lose a pod, keep training on the rest" path: the
same rule set resolves on the smaller mesh, and axes that no longer divide
fall back to replication.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import RULE_SETS, logical_to_spec
from repro_torch.launch import specs as sp


@dataclasses.dataclass
class ElasticPlan:
    old_mesh: Tuple[int, ...]
    new_mesh: Tuple[int, ...]
    feasible: bool
    issues: List[str]
    param_shardings: Any = None
    batch_per_device: int = 0


def replan(
    cfg: ArchConfig,
    shape: ShapeConfig,
    new_mesh,
    rules_name: str,
    old_mesh_shape: Tuple[int, ...] = (16, 16),
) -> ElasticPlan:
    """Validate + build shardings for resuming `cfg` x `shape` on `new_mesh`."""
    issues: List[str] = []
    rules = RULE_SETS[rules_name]

    batch_spec = logical_to_spec(("batch",), rules, new_mesh, (shape.global_batch,))
    dp = 1
    b_axes = batch_spec[0] if batch_spec else None
    if isinstance(b_axes, str):
        b_axes = (b_axes,)
    for a in b_axes or ():
        dp *= new_mesh.shape[a]
    if shape.global_batch % max(dp, 1):
        issues.append(
            f"global_batch {shape.global_batch} not divisible by data extent {dp}"
        )
    p_sh = sp.param_shardings(cfg, new_mesh, rules_name)

    # feasibility: bf16 params must fit the new per-chip HBM budget
    n_dev = 1
    for s in new_mesh.shape.values():
        n_dev *= s
    # worst-case replication factor: params whose axes all degraded
    bytes_dev = cfg.param_count() * 2 / max(n_dev, 1)
    if bytes_dev > 12 * 2**30:
        issues.append(f"params ~{bytes_dev/2**30:.1f} GiB/device on new mesh")

    return ElasticPlan(
        old_mesh=tuple(old_mesh_shape),
        new_mesh=tuple(new_mesh.shape.values()),
        feasible=not issues,
        issues=issues,
        param_shardings=p_sh,
        batch_per_device=shape.global_batch // max(dp, 1),
    )
