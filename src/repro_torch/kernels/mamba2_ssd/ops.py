"""Mamba2 SSD entry point: the oracle scan, the plain chunked form, and the CUDA kernel.

The port of ``repro/kernels/mamba2_ssd/ops.py``. Chunked form (the SSD
algorithm): with L_t = A * cumsum(dt) inside a chunk,
    y_t = exp(L_t) * (C_t . H0)  +  sum_{s<=t} (C_t . B_s) exp(L_t - L_s) dt_s x_s + D x_t
    H_c = exp(L_c) * (H0 + sum_s exp(-L_s) dt_s x_s (x) B_s)
— sequential steps become O(T/c) chunks of matmuls, identical math to ref.py.

``impl="pallas"`` keeps the reference's name, so a ``ModelOptions`` carries
across unchanged: it launches the CUDA kernel for CUDA tensors and takes the
plain chunked form for CPU tensors. There is no fallback for CUDA tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels.mamba2_ssd import mamba2_ssd as _kernel
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref

DEFAULT_CHUNK = 32


def _ssd_chunked(x, dt, A, Bm, C, D, state, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """In fp32 as the reference computes, or in fp64 when every input is fp64
    (the yardstick ``chip_smoke.py`` holds the kernel against on a model's
    inputs, where fp32 differences of large L lose digits)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    inputs = (x, dt, A, Bm, C, D, state)
    dtype = torch.float64 if all(t.dtype == torch.float64 for t in inputs) else torch.float32
    x, dt, A, Bm, C, D, Hst = (t.to(dtype) for t in inputs)

    if T % chunk:
        pad = chunk - T % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    Tp = x.shape[1]
    nc = Tp // chunk

    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    Bc = Bm.reshape(B, nc, chunk, N)
    Cc = C.reshape(B, nc, chunk, N)

    L = A * torch.cumsum(dtc, dim=2)                             # (B,nc,c,H) inclusive
    a_incl = torch.exp(L)                                        # exp(L_t) <= 1 (A<0)
    a_last = torch.exp(L[:, :, -1:, :])                          # (B,nc,1,H)
    # state-update decay exp(L_c - L_s) <= 1: numerically safe (never exp(-L))
    a_to_end = torch.exp(L[:, :, -1:, :] - L)                    # (B,nc,c,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=dtype, device=x.device))

    ys = []
    for i in range(nc):
        x_t, dt_t, B_t, C_t, L_t = xc[:, i], dtc[:, i], Bc[:, i], Cc[:, i], L[:, i]
        # scores_ts = (C_t.B_s) exp(L_t - L_s) dt_s, s<=t (inclusive diagonal)
        cb = torch.einsum("bcn,bsn->bcs", C_t, B_t)
        decay = torch.exp(torch.clamp(L_t[:, :, None, :] - L_t[:, None, :, :], max=0.0))
        scores = cb[..., None] * decay * dt_t[:, None, :, :] * mask[None, :, :, None]
        y_intra = torch.einsum("bcsh,bshp->bchp", scores, x_t)
        y_cross = a_incl[:, i, :, :, None] * torch.einsum("bcn,bhpn->bchp", C_t, Hst)
        u = (dt_t[..., None] * x_t)[..., None] * B_t[:, :, None, None, :]  # (B,c,H,P,N)
        Hst = (a_last[:, i, 0, :, None, None] * Hst
               + torch.einsum("bch,bchpn->bhpn", a_to_end[:, i], u))
        ys.append(y_intra + y_cross)
    y = torch.stack(ys, dim=1).reshape(B, Tp, H, P)[:, :T]
    y = y + D[None, None, :, None] * x[:, :T]
    return y, Hst


def ssd(x, dt, A, Bm, C, D, state, impl: str = "chunked", chunk: int = DEFAULT_CHUNK):
    spans.count("ssd_tokens", x.shape[0] * x.shape[1])
    if impl == "ref":
        return ssd_ref(x, dt, A, Bm, C, D, state)
    if impl == "chunked" or (impl == "pallas" and x.device.type == "cpu"):
        return _ssd_chunked(x, dt, A, Bm, C, D, state, chunk)
    if impl == "pallas":
        return _kernel.ssd_pallas(x.contiguous(), dt.float().contiguous(), A, Bm.contiguous(),
                                  C.contiguous(), D, state.float().contiguous(), chunk=chunk)
    raise ValueError(f"unknown ssd impl {impl!r}")


def ssd_decode_step(x, dt, A, Bm, C, D, state):
    """Single-token recurrence: x:(B,H,P) dt:(B,H) Bm,C:(B,N) state:(B,H,P,N)."""
    x, dt, Bm, C = (t.float() for t in (x, dt, Bm, C))
    a = torch.exp(A[None, :].float() * dt)
    upd = (dt[..., None] * x)[..., None] * Bm[:, None, None, :]
    H_new = a[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", H_new, C) + D[None, :, None].float() * x
    return y, H_new
