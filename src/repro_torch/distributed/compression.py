"""int8 gradient compression with error feedback (distributed-optimization trick).

The port of ``repro/distributed/compression.py``. Per-tensor symmetric
quantization: q = round(g / s), s = max|g| / 127, applied *before* the
cross-pod all-reduce and dequantized after. The residual (g - deq(q)) feeds
back into the next step's gradient so the bias vanishes over time
(error-feedback SGD guarantee). ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 values and scales equal the reference's.
The all-reduce itself (``psum_compressed``) needs a process group, which the
multi-device layer brings (ROADMAP A.10).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

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
    """All-reduce of int8-compressed gradients over `axis_name`: needs a
    process group over a mesh axis."""
    raise NotImplementedError(
        "psum_compressed needs a process group over a device mesh, which is not "
        "ported yet (ROADMAP A.10)")
