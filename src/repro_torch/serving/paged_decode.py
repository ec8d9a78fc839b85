"""Model-integrated paged decode: one token against the paged KV pool.

The port of ``repro/serving/paged_decode.py`` for the attention families
(dense, moe, vlm, audio), as the reference's: it refuses what the reference
asserts against, ssm and hybrid models and MoE stacks with leading dense
layers. A decode step is embed -> loop over layers [paged attention + mlp or
moe] -> unembed, reading pages the engine has promoted to the hot tier. Each layer's attention is the
paged-attention kernel (``kernels/paged_attention``): the CUDA kernel for
pools on the card, its plain version for pools on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import rms_norm


def paged_decode_step(
    params,
    cfg: ArchConfig,
    k_pool: torch.Tensor,        # (L, slots, page, K, hd)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # (B, max_pages) int32 hot slots
    lengths: torch.Tensor,       # (B,) int32
    inputs: torch.Tensor,        # (B, 1) tokens or (B, 1, D)
    opts: tf.ModelOptions = tf.ModelOptions(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (logits (B, V), k_pool, v_pool).

    Unlike the reference, whose ``lax.scan`` donates the pools and returns new
    ones, this writes the new token's K/V into ``k_pool``/``v_pool`` in place
    and returns the same tensors, so the engine's call site reads the same."""
    # The reference's two asserts, with its wording (hybrid_moe has no
    # counterpart there: its Mamba2 state has no place in the paged pools).
    if cfg.family in ("ssm", "hybrid", "hybrid_moe"):
        raise NotImplementedError("paged decode is for attention archs")
    if cfg.moe and cfg.moe_first_dense:
        raise NotImplementedError("use uniform stacks for paged demo")
    # host time from entry to return: every launch enqueued, no wait
    with spans.span("decode.dispatch"):
        B = inputs.shape[0]
        L, slots, page, K, hd = k_pool.shape
        h = tf.embed_inputs(params, cfg, inputs)
        windows = tf.layer_windows(cfg, cfg.num_layers)
        positions = lengths[:, None].to(torch.int32)
        page_idx = (lengths // page).long()
        offset = (lengths % page).long()
        slot_of = block_table[torch.arange(B, device=block_table.device), page_idx].long()
        kv_lengths = lengths + 1
        scale = float(cfg.resolved_head_dim) ** -0.5
        for layer in range(L):
            p = tf._layer(params["stack"], layer)
            x = rms_norm(h, p["ln1"])
            q, k_new, v_new = attn._project_qkv(p["attn"], x, positions, cfg.rope_theta,
                                                cfg.qk_norm)
            # write the new token's K/V into its page slot (in place)
            k_pages, v_pages = k_pool[layer], v_pool[layer]
            k_pages[slot_of, offset] = k_new[:, 0].to(k_pages.dtype)
            v_pages[slot_of, offset] = v_new[:, 0].to(v_pages.dtype)
            out = paged_attention(q[:, 0].contiguous(), k_pages, v_pages, block_table,
                                  kv_lengths, int(windows[layer]), scale=scale)
            a_out = torch.einsum("bnh,nhd->bd", out.to(x.dtype), p["attn"]["wo"])
            h, _ = tf._finish_block(p, h, a_out[:, None], cfg, opts.moe_impl)
        logits = tf.unembed(params, cfg, h)[:, 0]
    return logits, k_pool, v_pool
