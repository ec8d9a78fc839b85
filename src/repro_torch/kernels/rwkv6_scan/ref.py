"""Plain-torch oracle for the WKV6 recurrence (RWKV6 "Finch" data-dependent decay).

Mirrors ``repro/kernels/rwkv6_scan/ref.py``: a loop over T in fp32. Per head,
with state S in R^{K x V}:
    y_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]

Shapes: r,k,w: (B,T,H,K); v: (B,T,H,V); u: (H,K); state: (B,H,K,V).
"""

from __future__ import annotations

from typing import Tuple

import torch


def wkv6_ref(r, k, v, w, u, state) -> Tuple[torch.Tensor, torch.Tensor]:
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                  # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S
