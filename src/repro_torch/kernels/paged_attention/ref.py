"""Plain-torch paged decode attention: gather pages, repeat KV heads, mask, softmax.

Mirrors ``repro/kernels/paged_attention/ref.py``. It is the CPU path of
``ops.paged_attention`` and the version the CUDA kernel is held against.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def paged_attention_ref(q, k_pages, v_pages, block_table, lengths, window,
                        *, scale: float):
    """q: (B,N,hd); pages: (P,page_size,K,hd); table: (B,max_pages)."""
    B, N, hd = q.shape
    P, page_size, K, _ = k_pages.shape
    max_pages = block_table.shape[1]
    T = max_pages * page_size
    # gather each sequence's pages into a contiguous (B, T, K, hd) cache
    idx = block_table.long()
    k = k_pages[idx].reshape(B, T, K, hd)
    v = v_pages[idx].reshape(B, T, K, hd)
    if K != N:
        rep = N // K
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bnh,btnh->bnt", q.float(), k.float()) * scale
    pos = torch.arange(T, device=q.device)[None, :]
    q_pos = (lengths - 1)[:, None]
    mask = (pos < lengths[:, None]) & (q_pos - pos < window)
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnt,btnh->bnh", probs, v.float())
    return out.to(q.dtype)
