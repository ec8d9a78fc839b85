"""Shared building blocks: norms, RoPE, MLP variants, initializers.

Parameters are plain nested dicts of tensors with layers STACKED on a leading
``L`` axis, the reference's layout (``repro/models/layers.py``), so a parameter
tree converts one-to-one between the two packages (``repro_torch.interop``).
Initializers draw from an explicit ``torch.Generator`` on the target device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ----------------------------------------------------------------------------- init
# A layer-stacked leaf of more elements than this is drawn one slice of its
# leading axis at a time: a whole draw needs fp32 scratch of the leaf's size,
# and deepseek-coder-33b's (62, 7168, 19200) MLP stacks would take 34 GB
# each. Smaller leaves (every reduced config, gemma3-1b at full width) are
# drawn whole, so their values are the whole draw's.
WHOLE_DRAW_LIMIT = 1 << 28       # elements: 1 GiB of fp32 scratch


def trunc_normal(gen: torch.Generator, shape, scale: float, dtype=torch.float32,
                 device="cuda") -> torch.Tensor:
    """Fan-in-scaled truncated normal (std = scale / sqrt(fan_in)), drawn in
    fp32 into a scratch (the whole leaf, or one layer slice of a stack past
    WHOLE_DRAW_LIMIT) and rounded into the leaf once. On the meta device
    (shapes only) nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta or out.numel() == 0:
        return out
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    whole = len(shape) < 3 or out.numel() <= WHOLE_DRAW_LIMIT
    parts = (out,) if whole else out.unbind(0)
    scratch = torch.empty(parts[0].shape, dtype=torch.float32, device=device)
    for part in parts:
        torch.nn.init.trunc_normal_(scratch, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(scratch.mul_(std))
    return out


def zeros(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


# ----------------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with (1 + scale) parameterization (gemma-style zero-init safe)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


# ----------------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates halves."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                      # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------- mlps
def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; match it.
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "squared_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name}")


def init_mlp(gen: torch.Generator, L: int, D: int, F_: int, activation: str, dtype,
             device="cuda") -> Dict[str, torch.Tensor]:
    if activation in ("swiglu", "gelu_glu"):
        return {
            "w_gate": trunc_normal(gen, (L, D, F_), 1.0, dtype, device),
            "w_up": trunc_normal(gen, (L, D, F_), 1.0, dtype, device),
            "w_down": trunc_normal(gen, (L, F_, D), 1.0, dtype, device),
        }
    return {
        "w_up": trunc_normal(gen, (L, D, F_), 1.0, dtype, device),
        "w_down": trunc_normal(gen, (L, F_, D), 1.0, dtype, device),
    }


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, activation: str) -> torch.Tensor:
    """Per-layer MLP (params already sliced to this layer, no leading L)."""
    if activation in ("swiglu", "gelu_glu"):
        inner = "silu" if activation == "swiglu" else "gelu"
        h = _act(inner, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(activation, x @ p["w_up"])
    h = constrain(h, ("batch", None, "ff"))
    return h @ p["w_down"]


def mlp_flops(D: int, F: int, activation: str, tokens: int) -> int:
    mats = 3 if activation in ("swiglu", "gelu_glu") else 2
    return 2 * mats * D * F * tokens
