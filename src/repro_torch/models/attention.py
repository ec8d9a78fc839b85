"""GQA attention: full / sliding-window / bidirectional, with KV-cache decode.

The port of ``repro/models/attention.py``. The per-layer window is a Python
int here (the reference carries it as int32 data through ``lax.scan``): sliding
layers carry their window, global layers carry window >= seq_len.

Implementations of ``full_attention``:
  * ``xla``         — einsum reference with an explicit (S, T) mask;
  * ``xla_chunked`` — the same over query blocks, so scores never reach (S x S);
  * ``flash``       — the flash-attention kernel (``kernels/flash_attention``):
                      the CUDA kernel for CUDA tensors, its plain version for
                      CPU tensors. Causal layers only, as in the reference.

The reference's sharding constraints (``constrain``) are no-ops on one device
and are dropped. Decode writes the new token's K/V into the caller's cache in
place, where the reference's ``.at[...].set`` returns a new cache; the
functions still return the cache, so call sites read the same.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, rms_norm, trunc_normal, zeros

NEG_INF = -2.0e38


def init_attention(gen: torch.Generator, L: int, D: int, N: int, K: int, hd: int,
                   qk_norm: bool, dtype, device="cuda") -> Dict[str, torch.Tensor]:
    p = {
        "wq": trunc_normal(gen, (L, D, N, hd), 1.0, dtype, device),
        "wk": trunc_normal(gen, (L, D, K, hd), 1.0, dtype, device),
        "wv": trunc_normal(gen, (L, D, K, hd), 1.0, dtype, device),
        "wo": trunc_normal(gen, (L, N, hd, D), 1.0, dtype, device),
    }
    if qk_norm:
        p["q_norm"] = zeros((L, hd), dtype, device)
        p["k_norm"] = zeros((L, hd), dtype, device)
    return p


def _project_qkv(p, x, positions, theta, qk_norm):
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _gqa_scores_mask_values(q, k, v, mask, scale):
    """q:(B,S,N,hd) k,v:(B,T,K,hd) mask:(B?,S,T) bool -> (B,S,N,hd) in v's dtype.

    KV heads are broadcast up to N, as in the reference."""
    N = q.shape[2]
    K = k.shape[2]
    if K != N:
        G = N // K
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scores = torch.einsum("bsnh,btnh->bnst", q, k).float() * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def _auto_q_block(B: int, S: int, N: int) -> int:
    """Largest power-of-two query block whose score slab stays ~<=32 GB."""
    budget = 32e9
    qb = 1024
    while qb > 64 and B * N * qb * S * 4 > budget:
        qb //= 2
    return qb


def _chunked_attention(q, k, v, *, window: int, causal: bool, scale: float,
                       q_block: int = 0):
    """Blocked attention: a loop over query blocks so scores never materialize
    at (S x S). The plain stand-in for the flash kernel at long context."""
    B, S, N, hd = q.shape
    qb = min(q_block or _auto_q_block(B, S, N), S)
    kpos = torch.arange(S, dtype=torch.int32, device=q.device)[None, None, :]   # (1,1,S)
    outs = []
    for start in range(0, S, qb):
        # The reference pads q to a block multiple; the last block is cut
        # short here instead, which leaves every real row unchanged.
        qblk = q[:, start:start + qb]
        qpos = torch.arange(start, start + qblk.shape[1], dtype=torch.int32,
                            device=q.device)[None, :, None]
        mask = ((qpos >= kpos) & (qpos - kpos < window) if causal
                else torch.ones((1, qblk.shape[1], S), dtype=torch.bool, device=q.device))
        outs.append(_gqa_scores_mask_values(qblk, k, v, mask, scale))
    return torch.cat(outs, dim=1)


def full_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    window: int,                  # >= S means full attention
    causal: bool,
    theta: float,
    qk_norm: bool,
    attn_impl: str = "xla",
    segment_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill attention over the whole sequence. Returns (out, (k, v))."""
    B, S, D = x.shape
    positions = (
        segment_positions if segment_positions is not None
        else torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    )
    q, k, v = _project_qkv(p, x, positions, theta, qk_norm)
    scale = q.shape[-1] ** -0.5

    if attn_impl == "flash" and causal:
        out = flash_attention(q, k, v, window=window, scale=scale)
    elif attn_impl == "xla_chunked":
        out = _chunked_attention(q, k, v, window=window, causal=causal, scale=scale)
    else:
        qpos = positions[:, :, None]      # (B, S, 1)
        kpos = positions[:, None, :]      # (B, 1, S)
        mask = ((qpos >= kpos) & (qpos - kpos < window) if causal
                # encoder: all-to-all
                else (qpos - kpos).abs() < max(window, S + 1))
        out = _gqa_scores_mask_values(q, k, v, mask, scale)

    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"])
    return out, (k, v)


def decode_attention(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,               # (B, 1, D) current token
    k_cache: torch.Tensor,         # (B, T, K, hd)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,         # (B,) tokens already in cache
    *,
    window: int,
    theta: float,
    qk_norm: bool,
    flash_layout: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against the cache. Returns (out, k_cache, v_cache); the
    caches are the caller's tensors with the new token written in place.

    ``flash_layout`` selects the reference's sequence-sharded score layout only
    when the cache's sequence dim is sharded (``_cache_seq_sharded``), which
    is never the case without a device mesh; on one device both settings take
    the same einsum path, as here."""
    del flash_layout
    B = x.shape[0]
    T = k_cache.shape[1]
    positions = lengths[:, None].to(torch.int32)               # (B, 1)
    q, k_new, v_new = _project_qkv(p, x, positions, theta, qk_norm)

    bidx = torch.arange(B, device=x.device)
    pos = lengths.long()
    k_cache[bidx, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos] = v_new[:, 0].to(v_cache.dtype)

    jpos = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]   # (1, T)
    valid = (jpos <= lengths[:, None]) & (lengths[:, None] - jpos < window)

    scale = q.shape[-1] ** -0.5
    out = _gqa_scores_mask_values(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                                  valid[:, None, :], scale)
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"])
    return out, k_cache, v_cache


def decode_attention_ring(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,               # (B, 1, D) current token
    k_ring: torch.Tensor,          # (B, W, K, hd) ring buffer, W = window
    v_ring: torch.Tensor,
    lengths: torch.Tensor,         # (B,)
    *,
    theta: float,
    qk_norm: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sliding-window decode against a window-sized ring cache, written in place.

    Slot j holds absolute position p_j = lengths - ((lengths - j) mod W) after the
    write — only the last W tokens ever exist, so per-step KV traffic is O(window)
    instead of O(context). RoPE is applied at absolute positions before storing, so
    ring rotation never re-rotates keys.
    """
    B = x.shape[0]
    W = k_ring.shape[1]
    positions = lengths[:, None].to(torch.int32)
    q, k_new, v_new = _project_qkv(p, x, positions, theta, qk_norm)

    bidx = torch.arange(B, device=x.device)
    slot = (lengths % W).long()
    k_ring[bidx, slot] = k_new[:, 0].to(k_ring.dtype)
    v_ring[bidx, slot] = v_new[:, 0].to(v_ring.dtype)

    j = torch.arange(W, dtype=torch.int32, device=x.device)[None, :]      # (1, W)
    p_j = lengths[:, None] - torch.remainder(lengths[:, None] - j, W)      # absolute positions
    valid = p_j >= 0                                                       # early-fill guard

    scale = q.shape[-1] ** -0.5
    out = _gqa_scores_mask_values(q, k_ring.to(q.dtype), v_ring.to(q.dtype),
                                  valid[:, None, :], scale)
    out = torch.einsum("bsnh,nhd->bsd", out, p["wo"])
    return out, k_ring, v_ring
