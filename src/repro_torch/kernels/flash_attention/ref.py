"""Plain-torch attention: repeat KV heads, fp32 scores and softmax, window and causal masks.

Mirrors ``repro/kernels/flash_attention/ref.py``. It is the CPU path of
``ops.flash_attention`` and the version the CUDA kernel is held against.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def attention_ref(q, k, v, window: int, *, causal: bool = True, scale: float = 1.0):
    """q: (B,S,N,hd); k,v: (B,T,K,hd); window: int. Returns (B,S,N,hd) in q's dtype."""
    B, S, N, hd = q.shape
    K = k.shape[2]
    if K != N:
        rep = N // K
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    T = k.shape[1]
    scores = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = qpos - kpos < window
    if causal:
        mask = mask & (qpos >= kpos)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnst,btnh->bsnh", probs, v.float())
    return out.to(q.dtype)
