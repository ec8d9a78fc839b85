"""Mamba2 block (state-space duality form), used inside Zamba2's hybrid.

The port of ``repro/models/mamba2.py``. Structure per block (Mamba2 paper):
in_proj -> [x | z | B | C | dt], short causal conv over (x,B,C), SSD recurrence
with scalar-per-head decay, gated by silu(z), out_proj. The SSD core lives in
``kernels/mamba2_ssd`` (ref | chunked | pallas, the last the CUDA kernel for
CUDA tensors).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.mamba2_ssd.ops import ssd, ssd_decode_step
from repro_torch.models.layers import ones, rms_norm, trunc_normal, zeros


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    N = cfg.ssm_state
    return d_in, P, H, N


def init_mamba2(gen: torch.Generator, L: int, cfg: ArchConfig, dtype,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Stacked (L, ...) Mamba2 parameters; A_log, D and dt_bias stay fp32."""
    D = cfg.d_model
    d_in, P, H, N = _dims(cfg)
    conv_dim = d_in + 2 * N
    A_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device))
    return {
        "in_proj": trunc_normal(gen, (L, D, 2 * d_in + 2 * N + H), 1.0, dtype, device),
        "conv_w": trunc_normal(gen, (L, cfg.ssm_conv, conv_dim), 1.0, dtype, device),
        "conv_b": zeros((L, conv_dim), dtype, device),
        "A_log": A_log.tile(L, 1),
        "D": ones((L, H), torch.float32, device),
        "dt_bias": zeros((L, H), torch.float32, device),
        "norm": zeros((L, d_in), dtype, device),
        "out_proj": trunc_normal(gen, (L, d_in, D), 1.0, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prev: torch.Tensor):
    """Depthwise causal conv1d. x: (B,S,C), w: (k,C), prev: (B,k-1,C) carry."""
    k = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([prev, x], dim=1)                             # (B, S+k-1, C)
    out = sum(xp[:, i : i + S] * w[i][None, None] for i in range(k))
    # a copy: a view of the last k-1 rows would keep all of xp alive in the
    # caller's collected states (a (B, S, C) tensor a layer)
    new_prev = xp[:, -(k - 1):].clone() if k > 1 else torch.zeros_like(prev)
    return F.silu(out + b[None, None]), new_prev


def _split_proj(proj: torch.Tensor, d_in: int, N: int):
    """[x | z | B | C | dt] along the last axis."""
    return torch.split(proj, [d_in, d_in, N, N, proj.shape[-1] - 2 * d_in - 2 * N], dim=-1)


def mamba2_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                      # (B, S, D)
    state: Dict[str, torch.Tensor],       # {"conv": (B,k-1,C), "ssd": (B,H,P,N)}
    cfg: ArchConfig,
    impl: str = "chunked",
    eps: float = 1e-6,                    # the gated norm's
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, _ = x.shape
    d_in, P, H, N = _dims(cfg)

    proj = x @ p["in_proj"]                                      # (B,S,2*d_in+2N+H)
    xi, z, Bc, Cc, dt = _split_proj(proj, d_in, N)
    conv_in = torch.cat([xi, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], p["conv_b"], state["conv"])
    xi, Bc, Cc = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None])      # (B,S,H)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, S, H, P)
    xh = constrain(xh, ("batch", None, "heads", "head_dim"))

    y, ssd_state = ssd(xh, dt, A, Bc, Cc, p["D"], state["ssd"], impl=impl)
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], eps)
    out = y @ p["out_proj"]
    return constrain(out, ("batch", "seq", "embed")), {"conv": conv_state, "ssd": ssd_state}


def mamba2_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                      # (B, 1, D)
    state: Dict[str, torch.Tensor],
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B = x.shape[0]
    d_in, P, H, N = _dims(cfg)
    proj = x[:, 0] @ p["in_proj"]
    xi, z, Bc, Cc, dt = _split_proj(proj, d_in, N)
    conv_in = torch.cat([xi, Bc, Cc], dim=-1)[:, None, :]
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], p["conv_b"], state["conv"])
    xi, Bc, Cc = torch.split(conv_out[:, 0], [d_in, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])
    y, ssd_state = ssd_decode_step(xi.reshape(B, H, P), dt, A, Bc, Cc, p["D"], state["ssd"])
    y = y.reshape(B, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return (y @ p["out_proj"])[:, None, :], {"conv": conv_state, "ssd": ssd_state}


def mamba2_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device="cuda"):
    d_in, P, H, N = _dims(cfg)
    conv_dim = d_in + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }
