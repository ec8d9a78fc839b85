"""Plain-torch oracle for the Mamba2 SSD recurrence (scalar-per-head decay).

Mirrors ``repro/kernels/mamba2_ssd/ref.py``: a loop over T in fp32. Per head h
with state H in R^{P x N} (P = head dim, N = d_state):
    a_t = exp(A_h * dt_t)                       (A_h < 0, dt_t > 0)
    H_t = a_t * H_{t-1} + (dt_t * x_t) outer B_t
    y_t = H_t @ C_t + D_h * x_t

Shapes: x: (B,T,H,P); dt: (B,T,H); A,D: (H,); Bm,C: (B,T,N) (single group);
state: (B,H,P,N).
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_ref(x, dt, A, Bm, C, D, state) -> Tuple[torch.Tensor, torch.Tensor]:
    x, dt, Bm, C = (t.float() for t in (x, dt, Bm, C))
    A, D = A.float(), D.float()
    Hst = state.float()
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t, B_t, C_t = x[:, t], dt[:, t], Bm[:, t], C[:, t]
        a_t = torch.exp(A[None, :] * dt_t)                                  # (B,H)
        upd = (dt_t[..., None] * x_t)[..., None] * B_t[:, None, None, :]    # (B,H,P,N)
        Hst = a_t[..., None, None] * Hst + upd
        ys.append(torch.einsum("bhpn,bn->bhp", Hst, C_t) + D[None, :, None] * x_t)
    return torch.stack(ys, dim=1), Hst
