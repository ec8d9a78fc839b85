"""RWKV6 "Finch" block: time-mix with data-dependent decay + channel-mix.

The port of ``repro/models/rwkv6.py`` (arXiv:2404.05892): per-channel decay
w_t from a LoRA on the token-shifted input (``w_t = exp(-exp(w0 + tanh(x_w @ A)
@ B))``), the bonus term u, token-shift interpolation with static per-projection
mu (the reference leaves out RWKV6's ddlerp LoRA, and so does the port). The
WKV recurrence lives in ``kernels/rwkv6_scan`` (ref | chunked | pallas, the
last the CUDA kernel for CUDA tensors).

Dtypes follow the reference: the decay runs in fp32, so w reaches the WKV
kernel as fp32 while r, k and v keep the activation dtype; the fp32 WKV output
is cast back to the activation dtype before the per-head group norm;
``tm_x``/``cm_x`` carry the activation dtype and ``wkv`` is fp32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.rwkv6_scan.ops import wkv6, wkv6_decode_step
from repro_torch.models.layers import ones, rms_norm, trunc_normal, zeros


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_rwkv6(gen: torch.Generator, L: int, cfg: ArchConfig, dtype,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Stacked (L, ...) RWKV6 parameters; w0, wA, wB and u stay fp32."""
    D, Fd = cfg.d_model, cfg.d_ff
    H, hd = _heads(cfg)
    lora = cfg.rwkv_decay_lora
    f32 = torch.float32
    return {
        # time-mix
        "mu": 0.5 * ones((L, 5, D), dtype, device),         # lerp coefficients r,k,v,g,w
        "wr": trunc_normal(gen, (L, D, D), 1.0, dtype, device),
        "wk": trunc_normal(gen, (L, D, D), 1.0, dtype, device),
        "wv": trunc_normal(gen, (L, D, D), 1.0, dtype, device),
        "wg": trunc_normal(gen, (L, D, D), 1.0, dtype, device),
        "wo": trunc_normal(gen, (L, D, D), 1.0, dtype, device),
        "w0": zeros((L, D), f32, device) - 0.6,             # base decay logit
        "wA": trunc_normal(gen, (L, D, lora), 1.0, f32, device),
        "wB": trunc_normal(gen, (L, lora, D), 0.1, f32, device),
        "u": trunc_normal(gen, (L, H, hd), 1.0, f32, device),
        "ln_x": zeros((L, D), dtype, device),               # per-head group-norm scale
        # channel-mix
        "cmu": 0.5 * ones((L, 2, D), dtype, device),        # lerp for k', r'
        "ck": trunc_normal(gen, (L, D, Fd), 1.0, dtype, device),
        "cv": trunc_normal(gen, (L, Fd, D), 1.0, dtype, device),
        "cr": trunc_normal(gen, (L, D, D), 1.0, dtype, device),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xx_t = x_{t-1}; prev is the carry from the previous segment (B, D)."""
    xx = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return xx, x[:, -1, :]


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): exp(-exp(w0 + tanh(xw A) B)), fp32."""
    logit = p["w0"][None, None] + torch.tanh(xw.float() @ p["wA"]) @ p["wB"]
    return torch.exp(-torch.exp(logit))


def _split_heads(t: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """(..., H * hd) -> (..., H, hd). On a mesh the merged dim is laid out
    unsharded first, as the rules give it ("heads_merged" names no mesh
    axis), so the view never splits a dim sharded over the mesh."""
    t = constrain(t, ("batch",) + (None,) * (t.dim() - 1))
    return t.reshape(*t.shape[:-1], H, hd)


def _group_norm(y: torch.Tensor, ln_x: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """The per-head group norm (unit scale), then the learned ln_x over D."""
    shape = y.shape
    y = rms_norm(y.reshape(*shape[:-1], H, hd), torch.zeros((hd,), dtype=y.dtype,
                                                            device=y.device))
    return rms_norm(y.reshape(shape), ln_x)


def _channel_mix(p, h: torch.Tensor, hx: torch.Tensor) -> torch.Tensor:
    cmu = p["cmu"]
    xk = h + (hx - h) * cmu[0]
    xr = h + (hx - h) * cmu[1]
    kk = torch.square(F.relu(xk @ p["ck"]))
    if h.dim() == 3:                      # the block; decode passes (B, D)
        kk = constrain(kk, ("batch", None, "ff"))
    return torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"])


def rwkv6_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (B, S, D)
    state: Dict[str, torch.Tensor],        # {"tm_x","cm_x": (B,D), "wkv": (B,H,hd,hd)}
    cfg: ArchConfig,
    impl: str = "chunked",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, D = x.shape
    H, hd = _heads(cfg)

    # ---- time mix -----------------------------------------------------------
    xx, tm_last = _token_shift(x, state["tm_x"])
    mu = p["mu"]

    def lerp(i):
        return x + (xx - x) * mu[i]

    r = _split_heads(lerp(0) @ p["wr"], H, hd)
    k = _split_heads(lerp(1) @ p["wk"], H, hd)
    v = _split_heads(lerp(2) @ p["wv"], H, hd)
    g = F.silu(lerp(3) @ p["wg"])
    w = _split_heads(_decay(p, lerp(4)), H, hd)
    r = constrain(r, ("batch", None, "heads", "head_dim"))
    k = constrain(k, ("batch", None, "heads", "head_dim"))
    v = constrain(v, ("batch", None, "heads", "head_dim"))

    y, wkv_state = wkv6(r, k, v, w, p["u"], state["wkv"], impl=impl)
    y = _group_norm(y.reshape(B, S, D).to(x.dtype), p["ln_x"], H, hd)
    h = x + (y * g) @ p["wo"]

    # ---- channel mix ----------------------------------------------------------
    hx, cm_last = _token_shift(h, state["cm_x"])
    new_state = {"tm_x": tm_last, "cm_x": cm_last, "wkv": wkv_state}
    return h + _channel_mix(p, h, hx), new_state


def rwkv6_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (B, 1, D)
    state: Dict[str, torch.Tensor],
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step using the O(1) recurrent state."""
    B, _, D = x.shape
    H, hd = _heads(cfg)
    xt = x[:, 0]
    xx = state["tm_x"]
    mu = p["mu"]

    def lerp(i):
        return xt + (xx - xt) * mu[i]

    r = _split_heads(lerp(0) @ p["wr"], H, hd)
    k = _split_heads(lerp(1) @ p["wk"], H, hd)
    v = _split_heads(lerp(2) @ p["wv"], H, hd)
    g = F.silu(lerp(3) @ p["wg"])
    w = _split_heads(_decay(p, lerp(4)[:, None, :])[:, 0], H, hd)

    y, wkv_state = wkv6_decode_step(r, k, v, w, p["u"], state["wkv"])
    y = _group_norm(y.reshape(B, D).to(xt.dtype), p["ln_x"], H, hd)
    h = xt + (y * g) @ p["wo"]

    new_state = {"tm_x": xt, "cm_x": h, "wkv": wkv_state}
    return (h + _channel_mix(p, h, state["cm_x"]))[:, None, :], new_state


def rwkv6_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device="cuda"):
    D = cfg.d_model
    H, hd = _heads(cfg)
    return {
        "tm_x": torch.zeros((batch, D), dtype=dtype, device=device),
        "cm_x": torch.zeros((batch, D), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    }
