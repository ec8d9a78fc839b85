"""WKV6 entry point: the oracle scan, the plain chunked form, and the CUDA kernel.

The port of ``repro/kernels/rwkv6_scan/ops.py``. Within a chunk of length c,
with cum the inclusive cumsum of log w and cum_prev = cum - log w:
    y_t = (r_t * exp(cum_prev_t)) @ S
          + sum_{s<t} (sum_i r_t,i k_s,i exp(min(cum_prev_t,i - cum_s,i, 0))) v_s
          + (r_t . u . k_t) v_t
    S  <- exp(cum_last) * S + (k * exp(cum_last - cum))^T v
— O(T) sequential steps become O(T/c) chunks of matmuls, the same math as
ref.py. Every exponent is <= 0, so fp32 never overflows however hard the decay
resets.

``impl="pallas"`` keeps the reference's name, so a ``ModelOptions`` carries
across unchanged: it launches the CUDA kernel for CUDA tensors and takes the
plain chunked form for CPU tensors. There is no fallback for CUDA tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _kernel
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

DEFAULT_CHUNK = 16


def _wkv6_chunked(r, k, v, w, u, state, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked arithmetic in fp32. The intra-chunk terms of
    every chunk are formed at once; only the carried state loops over chunks."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u, S = u.float(), state.float()

    if T % chunk:
        pad = chunk - T % chunk
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    Tp = r.shape[1]
    nc = Tp // chunk
    # (B, nc, c, H, *)
    rc, kc, vc, wc = (t.reshape(B, nc, chunk, H, t.shape[-1]) for t in (r, k, v, w))

    logw = torch.log(torch.clamp(wc, min=1e-38))
    cum = torch.cumsum(logw, dim=2)                              # inclusive, <= 0
    cum_prev = cum - logw                                        # exclusive, <= 0
    a_last = torch.exp(cum[:, :, -1])                            # (B,nc,H,K)
    a_to_end = torch.exp(cum[:, :, -1:] - cum)                   # exponent <= 0
    r_tilde = rc * torch.exp(cum_prev)

    # Strict lower triangle: pairwise per-channel decay exp(cum_prev_t - cum_s),
    # clamped so the masked upper triangle never overflows before the mask.
    dmat = torch.exp(torch.clamp(cum_prev[:, :, :, None] - cum[:, :, None, :], max=0.0))
    scores = (rc[:, :, :, None] * kc[:, :, None, :] * dmat).sum(-1)   # (B,nc,t,s,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=r.device), -1)
    scores = scores * mask[:, :, None]
    y = torch.einsum("bntsh,bnshv->bnthv", scores, vc)
    # the bonus diagonal
    y = y + torch.einsum("bnthk,hk,bnthk->bnth", rc, u, kc)[..., None] * vc
    k_end = kc * a_to_end

    ys = []
    for i in range(nc):
        ys.append(torch.einsum("bthk,bhkv->bthv", r_tilde[:, i], S))
        S = a_last[:, i, :, :, None] * S + torch.einsum("bshk,bshv->bhkv", k_end[:, i], vc[:, i])
    y = y + torch.stack(ys, dim=1)
    return y.reshape(B, Tp, H, V)[:, :T], S


def wkv6(r, k, v, w, u, state, impl: str = "chunked", chunk: int = DEFAULT_CHUNK):
    """Dispatch: 'ref' (oracle scan), 'chunked' (plain), 'pallas' (the CUDA
    kernel for CUDA tensors, the plain chunked form for CPU tensors)."""
    if impl == "ref":
        return wkv6_ref(r, k, v, w, u, state)
    if impl == "chunked" or (impl == "pallas" and r.device.type == "cpu"):
        return _wkv6_chunked(r, k, v, w, u, state, chunk)
    if impl == "pallas":
        return _kernel.wkv6_pallas(r.contiguous(), k.contiguous(), v.contiguous(),
                                   w.float().contiguous(), u.float().contiguous(),
                                   state.float().contiguous(), chunk=chunk)
    raise ValueError(f"unknown wkv6 impl {impl!r}")


def wkv6_decode_step(r, k, v, w, u, state):
    """Single-token recurrence for serving: r,k,w:(B,H,K) v:(B,H,V) state:(B,H,K,V)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None].float() * kv)
    new_state = w[..., :, None] * state + kv
    return y, new_state
