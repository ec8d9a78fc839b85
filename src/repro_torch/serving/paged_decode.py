"""Model-integrated paged decode: one token against the paged KV pool.

The port of ``repro/serving/paged_decode.py`` for the dense family. A decode
step is embed -> loop over layers [paged attention + mlp] -> unembed, reading
pages the engine has promoted to the hot tier. Each layer's attention is the
paged-attention kernel (``kernels/paged_attention``): the CUDA kernel for
pools on the card, its plain version for pools on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.models.layers import apply_rope, rms_norm


def paged_decode_step(
    params,
    cfg: ArchConfig,
    k_pool: torch.Tensor,        # (L, slots, page, K, hd)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # (B, max_pages) int32 hot slots
    lengths: torch.Tensor,       # (B,) int32
    inputs: torch.Tensor,        # (B, 1) tokens
    opts: tf.ModelOptions = tf.ModelOptions(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (logits (B, V), k_pool, v_pool).

    Unlike the reference, whose ``lax.scan`` donates the pools and returns new
    ones, this writes the new token's K/V into ``k_pool``/``v_pool`` in place
    and returns the same tensors, so the engine's call site reads the same."""
    tf.require_dense(cfg)
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
    stack = params["stack"]
    for layer in range(L):
        p_attn = {name: w[layer] for name, w in stack["attn"].items()}
        x = rms_norm(h, stack["ln1"][layer])
        q = torch.einsum("bsd,dnh->bsnh", x, p_attn["wq"])
        k_new = torch.einsum("bsd,dkh->bskh", x, p_attn["wk"])
        v_new = torch.einsum("bsd,dkh->bskh", x, p_attn["wv"])
        if cfg.qk_norm:
            q = rms_norm(q, p_attn["q_norm"])
            k_new = rms_norm(k_new, p_attn["k_norm"])
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        # write the new token's K/V into its page slot (in place)
        k_pages, v_pages = k_pool[layer], v_pool[layer]
        k_pages[slot_of, offset] = k_new[:, 0].to(k_pages.dtype)
        v_pages[slot_of, offset] = v_new[:, 0].to(v_pages.dtype)
        out = paged_attention(q[:, 0].contiguous(), k_pages, v_pages, block_table,
                              kv_lengths, int(windows[layer]), scale=scale)
        a_out = torch.einsum("bnh,nhd->bd", out.to(x.dtype), p_attn["wo"])
        if cfg.post_norms:
            a_out = rms_norm(a_out[:, None], stack["post_ln1"][layer])[:, 0]
        h = h + a_out[:, None]
        x2 = rms_norm(h, stack["ln2"][layer])
        f_out = ll.mlp({name: w[layer] for name, w in stack["mlp"].items()}, x2,
                       cfg.mlp_activation)
        if cfg.post_norms:
            f_out = rms_norm(f_out, stack["post_ln2"][layer])
        h = h + f_out
    logits = tf.unembed(params, cfg, h)[:, 0]
    return logits, k_pool, v_pool
