"""GQA attention: full / sliding-window / bidirectional, with KV-cache decode.

The port of ``repro/models/attention.py``. The per-layer window is a Python
int here (the reference carries it as int32 data through ``lax.scan``): sliding
layers carry their window, global layers carry window >= seq_len.

Implementations of ``full_attention``:
  * ``xla``         — einsum reference with an explicit (S, T) mask;
  * ``xla_chunked`` — the same over query blocks, so scores never reach (S x S);
  * ``flash``       — the flash-attention kernel (``kernels/flash_attention``):
                      the CUDA kernel for CUDA tensors, its plain version for
                      CPU tensors. Causal layers, and the encoder's
                      all-to-all layers, which the reference sends to ``xla``
                      (ROADMAP C.6).

Decode writes the new token's K/V into the caller's cache in
place, where the reference's ``.at[...].set`` returns a new cache; the
functions still return the cache, so call sites read the same.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import (constrain, current_mesh, current_rules,
                                              global_out, local_in, logical_to_spec,
                                              shard_dims)
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
    if theta is not None:          # None: no position embedding (NoPE)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    # "seq" itself is deliberately unsharded here: under SP rules the sequence axis
    # is only sharded on the residual stream between blocks (Megatron-style).
    # "seq_attn" is the low-priority fallback: it claims the model axis only when
    # the head count cannot divide it (context-parallel q; k/v stay full-sequence).
    q = constrain(q, ("batch", "seq_attn", "heads", "head_dim"))
    k = constrain(k, ("batch", None, "kv_heads", "head_dim"))
    v = constrain(v, ("batch", None, "kv_heads", "head_dim"))
    return q, k, v


def _block_offset(size: int, device_mesh, placements, dim: int) -> int:
    """Where this rank's block of tensor dim `dim` starts (DTensor cuts a dim
    sharded over several mesh dims in mesh-dim order)."""
    coord = device_mesh.get_coordinate()
    off, block = 0, size
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            block //= device_mesh.size(md)
            off += coord[md] * block
    return off


def _write_token(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``cache[b, pos[b]] = new[b]`` for every row b of a (B, T, K, hd) cache, in
    place. On a DTensor cache each rank writes the rows of its batch block
    whose position falls in its block of T (a sequence-sharded cache): the
    reference's ``.at[bidx, pos].set`` on a sharded array."""
    if not isinstance(cache, DTensor):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, pos.long()] = new.to(cache.dtype)
        return cache
    mesh, pl = cache.device_mesh, cache.placements
    # new (B, K, hd) laid out as the cache's batch and head dims; pos as its batch
    new_pl = [Shard(p.dim - (p.dim >= 2)) if isinstance(p, Shard) and p.dim != 1
              else Replicate() for p in pl]
    pos_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    local = cache.to_local()
    new_l = _as_dtensor(new, mesh).redistribute(mesh, new_pl).to_local()
    pos_l = _as_dtensor(pos, mesh).redistribute(mesh, pos_pl).to_local().long()
    pos_l = pos_l - _block_offset(cache.shape[1], mesh, pl, 1)
    mine = (pos_l >= 0) & (pos_l < local.shape[1])
    pos_l = pos_l.clamp(0, local.shape[1] - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    local[bidx, pos_l] = torch.where(mine[:, None, None], new_l.to(local.dtype),
                                     local[bidx, pos_l])
    return cache


def _as_dtensor(x: torch.Tensor, device_mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, device_mesh, [Replicate()] * device_mesh.ndim,
                              run_check=False)


def _gqa_scores_mask_values(q, k, v, mask, scale):
    """q:(B,S,N,hd) k,v:(B,T,K,hd) mask:(B?,S,T) bool -> (B,S,N,hd) in v's dtype.

    KV heads are broadcast up to N, as in the reference. A DTensor q runs the
    same core on each rank's rows (``_local_attention``)."""
    if isinstance(q, DTensor):
        return _local_attention(q, k, v, mask, scale)
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


def _local_attention(q: DTensor, k, v, mask, scale):
    """The attention core on each rank's shards, a ``local_map`` of the plain
    core. Every (batch, query, head) row is independent, so with q as it is
    sharded (batch, query rows and heads) each rank needs its batch rows of
    k, v and the mask, all T keys, and the KV heads of its query heads: it
    computes its rows alone, and their gradients into k and v are summed
    over the ranks that split the queries or heads."""
    mesh = current_mesh()
    q_dims = shard_dims(q, mesh)
    if 3 in q_dims.values():
        raise ValueError("attention with the head dim sharded is not supported")
    batch = {a: 0 for a, d in q_dims.items() if d == 0}
    split = tuple(a for a, d in q_dims.items() if d in (1, 2))
    kl = local_in(k, mesh, batch, grad_partial=split)
    vl = local_in(v, mesh, batch, grad_partial=split)
    if mask.dim() == 2:
        mask = mask[None]
    ml = local_in(mask, mesh, {a: d for a, d in q_dims.items()
                               if d in (0, 1) and mask.shape[d] == q.shape[d]})
    ql = q.to_local()
    # the KV heads broadcast up to N, as the plain core does, cut to this
    # rank's query heads (on one rank the cut is the whole: the plain core)
    G = q.shape[2] // k.shape[2]
    n0 = _block_offset(q.shape[2], q.device_mesh, q.placements, 2)
    if G > 1:
        kl, vl = kl.repeat_interleave(G, dim=2), vl.repeat_interleave(G, dim=2)
    kl, vl = kl.narrow(2, n0, ql.shape[2]), vl.narrow(2, n0, ql.shape[2])
    out = _gqa_scores_mask_values(ql, kl, vl, ml, scale)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False)


def _out_projection(out, wo):
    """out (B, S, N, hd) @ wo (N, hd, D) -> (B, S, D). A DTensor `out` runs the
    reference's einsum on each rank's heads (its shards of out and of wo)
    and sums over the mesh axes that split the heads (tensor parallelism);
    DTensor's own einsum would flatten the heads behind the head dim, which
    it cannot do while they are sharded."""
    if not isinstance(out, DTensor):
        return torch.einsum("bsnh,nhd->bsd", out, wo)
    mesh = current_mesh()
    dims = shard_dims(out, mesh)
    heads = tuple(a for a, d in dims.items() if d == 2)
    rows = {a: d for a, d in dims.items() if d in (0, 1)}
    if len(heads) + len(rows) != len(dims):
        raise ValueError("attention output with the head dim sharded is not supported")
    w = local_in(wo, mesh, {a: 0 for a in heads}, grad_partial=tuple(rows))
    y = torch.einsum("bsnh,nhd->bsd", out.to_local(), w)
    return global_out(y, mesh, rows, reduce_axes=heads)


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
    theta: Optional[float],       # None: no RoPE
    qk_norm: bool,
    attn_impl: str = "xla",
    segment_positions: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,   # None: head_dim ** -0.5
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill attention over the whole sequence. Returns (out, (k, v))."""
    B, S, D = x.shape
    positions = (
        segment_positions if segment_positions is not None
        else torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    )
    q, k, v = _project_qkv(p, x, positions, theta, qk_norm)
    if scale is None:
        scale = q.shape[-1] ** -0.5

    if attn_impl == "flash":
        # An encoder layer attends all-to-all whatever its window, as the
        # masked path below computes it; the reference sends it there.
        out = flash_attention(q, k, v, window=window if causal else max(window, S + 1),
                              scale=scale, causal=causal)
    elif attn_impl == "xla_chunked":
        out = _chunked_attention(q, k, v, window=window, causal=causal, scale=scale)
    else:
        qpos = positions[:, :, None]      # (B, S, 1)
        kpos = positions[:, None, :]      # (B, 1, S)
        mask = ((qpos >= kpos) & (qpos - kpos < window) if causal
                # encoder: all-to-all
                else (qpos - kpos).abs() < max(window, S + 1))
        out = _gqa_scores_mask_values(q, k, v, mask, scale)

    out = _out_projection(out, p["wo"])
    # cache layout for the (k, v) return: prefill caches shard their seq dim when
    # kv heads cannot (GQA K < tp); no-op in train rules (cache_seq=None there).
    kv_out = (
        constrain(k, ("batch", "cache_seq", "kv_heads", "head_dim")),
        constrain(v, ("batch", "cache_seq", "kv_heads", "head_dim")),
    )
    return constrain(out, ("batch", "seq", "embed")), kv_out


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

    ``flash_layout`` selects the reference's sequence-sharded score layout when
    the cache's sequence dim is sharded (``_cache_seq_sharded``), which needs
    a mesh; without one both settings take the same einsum path."""
    T = k_cache.shape[1]
    positions = lengths[:, None].to(torch.int32)               # (B, 1)
    q, k_new, v_new = _project_qkv(p, x, positions, theta, qk_norm)

    k_cache = _write_token(k_cache, k_new[:, 0], lengths)
    v_cache = _write_token(v_cache, v_new[:, 0], lengths)
    k_cache = constrain(k_cache, ("batch", "cache_seq", "kv_heads", "head_dim"))
    v_cache = constrain(v_cache, ("batch", "cache_seq", "kv_heads", "head_dim"))

    jpos = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]   # (1, T)
    valid = (jpos <= lengths[:, None]) & (lengths[:, None] - jpos < window)

    scale = q.shape[-1] ** -0.5
    if flash_layout and _cache_seq_sharded(k_cache):
        # Flash-decoding layout: the cache is sequence-sharded (GQA K < tp), so
        # keep the WHOLE score/value computation sequence-sharded — the softmax
        # reductions over sharded T become two tiny all-reduces instead of
        # resharding the cache to head sharding and back every layer.
        N = q.shape[2]
        K = k_cache.shape[2]
        k = k_cache.to(q.dtype)
        v = v_cache.to(q.dtype)
        if K != N:
            G = N // K
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        k = constrain(k, ("batch", "cache_seq", None, "head_dim"),
                      priority=("cache_seq",))
        v = constrain(v, ("batch", "cache_seq", None, "head_dim"),
                      priority=("cache_seq",))
        scores = torch.einsum("bsnh,btnh->bnst", q, k).float() * scale
        scores = constrain(scores, ("batch", None, None, "cache_seq"),
                           priority=("cache_seq",))
        scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bnst,btnh->bsnh", probs, v)
    else:
        out = _gqa_scores_mask_values(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                                      valid[:, None, :], scale)
    out = _out_projection(out, p["wo"])
    return constrain(out, ("batch", "seq", "embed")), k_cache, v_cache


def _cache_seq_sharded(k_cache: torch.Tensor) -> bool:
    """True when the active rules shard this cache's sequence dim (GQA K < tp)."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return False
    spec = logical_to_spec(("batch", "cache_seq", "kv_heads", "head_dim"),
                           rules, mesh, k_cache.shape)
    return len(spec) > 1 and spec[1] is not None


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
    W = k_ring.shape[1]
    positions = lengths[:, None].to(torch.int32)
    q, k_new, v_new = _project_qkv(p, x, positions, theta, qk_norm)

    slot = lengths % W
    k_ring = _write_token(k_ring, k_new[:, 0], slot)
    v_ring = _write_token(v_ring, v_new[:, 0], slot)

    j = torch.arange(W, dtype=torch.int32, device=x.device)[None, :]      # (1, W)
    p_j = lengths[:, None] - torch.remainder(lengths[:, None] - j, W)      # absolute positions
    valid = p_j >= 0                                                       # early-fill guard

    scale = q.shape[-1] ** -0.5
    out = _gqa_scores_mask_values(q, k_ring.to(q.dtype), v_ring.to(q.dtype),
                                  valid[:, None, :], scale)
    out = _out_projection(out, p["wo"])
    return constrain(out, ("batch", "seq", "embed")), k_ring, v_ring


def attention_flops(S: int, B: int, D: int, N: int, K: int, hd: int,
                    causal: bool, window: int) -> int:
    """Model FLOPs for one attention layer (projections + scores/values)."""
    proj = 2 * B * S * D * (N + 2 * K + N) * hd
    eff_ctx = min(window, S) if window else S
    pair = B * S * eff_ctx * (0.5 if causal and eff_ctx == S else 1.0)
    scores = 2 * pair * N * hd * 2
    return int(proj + scores)
