"""int8 gradient compression with error feedback (distributed-optimization trick).

The port of ``repro/distributed/compression.py``. Per-tensor symmetric
quantization: q = round(g / s), s = max|g| / 127, applied *before* the
cross-pod all-reduce and dequantized after. The residual (g - deq(q)) feeds
back into the next step's gradient so the bias vanishes over time
(error-feedback SGD guarantee). ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 values and scales equal the reference's.
``psum_compressed`` all-reduces over a mesh axis's process group, where the
reference's ``psum``/``pmax`` run inside ``shard_map``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_mesh
from repro_torch.tree import tree_map


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-20) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _is_qs(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], torch.Tensor)
            and x[0].dtype == torch.int8)


def compress_tree(grads: Any, error: Optional[Any] = None):
    """Returns (quantized tree of (q, scale), new error-feedback tree)."""
    if error is None:
        error = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, error)
    qs = tree_map(quantize, corrected)
    deq = tree_map(lambda qsc: dequantize(*qsc), qs, is_leaf=_is_qs)
    new_error = tree_map(lambda c, d: c - d, corrected, deq)
    return qs, new_error


def decompress_tree(qs: Any) -> Any:
    return tree_map(lambda qsc: dequantize(*qsc), qs, is_leaf=_is_qs)


def psum_compressed(grads: Any, axis_name: str, error: Optional[Any] = None):
    """All-reduce int8-compressed gradients over mesh axis `axis_name` of the
    ``axis_rules`` context's mesh (the reference runs inside ``shard_map``).

    Each rank passes its own (local) gradient tree. The reference's
    arithmetic: the int8 values
    widen to int32 and are summed over the axis's group, the scales take
    their maximum (``pmax``), and the result is ``summed * s_max / n`` over
    the axis's `n` ranks. Error feedback is carried by the caller."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("psum_compressed needs a mesh (an axis_rules context)")
    group = mesh.get_group(axis_name)
    n = mesh.shape[axis_name]
    qs, new_error = compress_tree(grads, error)

    def reduce_one(qsc):
        q, s = qsc
        # the int8 payload widened to int32 for the accumulation, as the
        # reference's psum over the axis
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        s_max = s.clone()
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        return summed.to(torch.float32) * s_max / float(n)

    return tree_map(reduce_one, qs, is_leaf=_is_qs), new_error
