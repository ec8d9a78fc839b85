"""Flash attention dispatch: the plain version on the CPU, the kernel on CUDA.

There is no fallback: CUDA tensors go to the CUDA kernel, which launches or
raises, and only CPU tensors take the plain version. Unlike the reference's
wrapper (``repro/kernels/flash_attention/ops.py:29``), K/V heads are not
repeated up to N: the kernel reads kv head ``n // G`` for query head ``n``.
"""

from __future__ import annotations

import operator

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, *, window: int, scale: float, causal: bool = True) -> torch.Tensor:
    """q: (B,S,N,hd); k,v: (B,T,K,hd) -> (B,S,N,hd) in q's dtype."""
    window = operator.index(window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, window, causal=causal, scale=scale)
    return _kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   window=window, scale=scale, causal=causal)
