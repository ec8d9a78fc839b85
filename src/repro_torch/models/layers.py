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


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ----------------------------------------------------------------------------- init
def trunc_normal(gen: torch.Generator, shape, scale: float, dtype=torch.float32,
                 device="cuda") -> torch.Tensor:
    """Fan-in-scaled truncated normal (std = scale / sqrt(fan_in)), drawn in fp32."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def zeros(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


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
    return h @ p["w_down"]
