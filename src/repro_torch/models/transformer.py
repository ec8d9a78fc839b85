"""Model assembly for the dense family: init, embedding, and unembedding.

The port of ``repro/models/transformer.py`` as far as the serving path needs it.
Parameters keep the reference's tree and its layer-stacked ``(L, ...)``
layout, so ``repro_torch.interop.from_reference`` maps one tree onto the
other key for key. Other families raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as ll
from repro_torch.models.layers import dtype_of

BIG_WINDOW = np.int32(2**30)

# Families that are not ported yet, and the ROADMAP item that ports each.
_UNPORTED = {
    "moe": "ROADMAP A.7 (MoE)",
    "ssm": "ROADMAP A.8 (SSM families)",
    "hybrid": "ROADMAP A.8 (SSM families)",
    "vlm": "ROADMAP A.6 (the rest of transformer/attention)",
    "audio": "ROADMAP A.6 (the rest of transformer/attention)",
}


def require_dense(cfg: ArchConfig) -> None:
    """Raise unless `cfg` is a family the port runs (dense, token input)."""
    item = _UNPORTED.get(cfg.family)
    if cfg.moe and item is None:
        item = _UNPORTED["moe"]
    if item is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet ({item})")


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Implementation knobs, field for field the reference's."""

    attn_impl: str = "xla"          # xla | flash
    moe_impl: str = "ep"            # ep | dense
    wkv_impl: str = "chunked"       # chunked | ref | pallas
    ssd_impl: str = "chunked"
    remat: str = "none"             # none | full | offload
    offload_names: Tuple[str, ...] = ("residual",)
    scan_layers: bool = True
    sliding_ring: bool = False
    decode_flash_layout: bool = False
    unroll_scans: bool = False


# ------------------------------------------------------------------------- windows
def layer_windows(cfg: ArchConfig, stack_size: int, offset: int = 0) -> np.ndarray:
    """Per-layer attention windows (int32); BIG_WINDOW means full attention."""
    if cfg.attention_kind == "sliding_global" and cfg.global_every:
        idx = np.arange(offset, offset + stack_size)
        return np.where(
            (idx + 1) % cfg.global_every == 0, BIG_WINDOW, np.int32(cfg.sliding_window)
        ).astype(np.int32)
    if cfg.attention_kind == "full" or cfg.family in ("vlm", "audio"):
        return np.full((stack_size,), BIG_WINDOW, np.int32)
    if cfg.sliding_window:
        return np.full((stack_size,), cfg.sliding_window, np.int32)
    return np.full((stack_size,), BIG_WINDOW, np.int32)


# ------------------------------------------------------------------------- init
def _init_attn_stack(gen, cfg: ArchConfig, L: int, dtype, device):
    D, F = cfg.d_model, cfg.d_ff
    N, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p: Dict[str, Any] = {
        "ln1": ll.zeros((L, D), dtype, device),
        "ln2": ll.zeros((L, D), dtype, device),
        "attn": attn.init_attention(gen, L, D, N, K, hd, cfg.qk_norm, dtype, device),
    }
    if cfg.post_norms:
        p["post_ln1"] = ll.zeros((L, D), dtype, device)
        p["post_ln2"] = ll.zeros((L, D), dtype, device)
    p["mlp"] = ll.init_mlp(gen, L, D, F, cfg.mlp_activation, dtype, device)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Dict[str, Any]:
    """Random parameters for a dense config, drawn from `gen` on `device`.

    `gen` must live on `device` (``torch.Generator(device=...)``). The draws
    differ from the reference's ``jax.random`` streams; parity tests carry the
    reference's parameters across with ``repro_torch.interop`` instead."""
    dev = resolve_device(device)
    require_dense(cfg)
    dtype = dtype_of(cfg.param_dtype)
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.num_layers
    params: Dict[str, Any] = {
        # std 1/sqrt(D): keeps tied logits O(1) and scale_embedding outputs ~N(0,1)
        "embed": ll.trunc_normal(gen, (V, D), math.sqrt(V / D), dtype, dev),
        "stack": _init_attn_stack(gen, cfg, L, dtype, dev),
        "final_norm": ll.zeros((D,), dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = ll.trunc_normal(gen, (D, V), 1.0, dtype, dev)
    return params


# ------------------------------------------------------------------------- embed
def embed_inputs(params, cfg: ArchConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> activations (B, S, D) in the config's dtype."""
    dtype = dtype_of(cfg.dtype)
    h = params["embed"][inputs].to(dtype)
    if cfg.scale_embedding:
        # The reference rounds sqrt(d_model) to the activation dtype before
        # multiplying (sqrt(1152) = 33.94 becomes 34.0 in bf16); so does this.
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype).item()
    return h


def unembed(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + vocab projection; padded vocab entries are masked to -1e30."""
    h = ll.rms_norm(h, params["final_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (h @ w.to(h.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits
