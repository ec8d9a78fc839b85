"""GQA attention parameters, in the reference's layout (``repro/models/attention.py``).

Only ``init_attention`` is ported so far: the decode path runs attention
through the paged kernel (``serving/paged_decode.py``). The full-sequence
paths (``xla``/``flash``) are later work (ROADMAP A.6).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.layers import trunc_normal, zeros


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
