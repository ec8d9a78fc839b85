"""CUDA flash-attention forward kernel: ctypes binding and launch wrapper.

The kernel (``csrc/flash_attention.cu``) is plain CUDA C++ for ``sm_90a``,
built by ``kernels/_nvcc.py`` into the git-ignored ``build/`` at its first
launch; nothing is built or loaded at import time. bf16 inputs run on the
tensor cores, fp32 inputs on the CUDA cores: a choice by dtype, not a fallback. ``flash_attention`` checks
its inputs, allocates the output with ``torch.empty``, and launches on the
current CUDA stream without synchronising. ``launches`` counts the launches
this process made.
"""

from __future__ import annotations

import operator
from pathlib import Path

import torch

from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels._nvcc import F32, I32, PTR, Kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# q, k, v, out; B, S, T, N, K, hd, window, causal; scale; is_bf16; stream
KERNEL = Kernel(SOURCE, "flash_attention_fwd", [*[PTR] * 4, *[I32] * 8, F32, I32, PTR])

HEAD_DIMS = (32, 64, 80, 128, 192, 256)
BLOCK_Q = 64

launches = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel. q (B,S,N,hd); k, v (B,T,K,hd); all fp32 or all
    bf16, contiguous, on one card; window a Python int >= 1. Returns
    (B,S,N,hd) in q's dtype."""
    global launches
    refuse_grad("flash_attention", q, k, v)
    window = operator.index(window)
    tensors = (q, k, v)
    _check(all(t.is_cuda for t in tensors), "all tensors must be CUDA tensors")
    _check(len({t.device for t in tensors}) == 1, "tensors are on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in tensors), "tensors must be 16-byte aligned")
    _check(q.dtype in (torch.float32, torch.bfloat16) and q.dtype == k.dtype == v.dtype,
           f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: all float32 or all bfloat16")
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, N, hd = q.shape
    _, T, K, hd_k = k.shape
    _check(k.shape[0] == B and hd_k == hd, f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _check(K >= 1 and N % K == 0, f"N/K = {N}/{K}: query heads must be a multiple of kv heads")
    _check(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _check(S >= 1 and T >= 1 and -(-S // BLOCK_Q) <= 65535, f"S={S}, T={T}")
    _check(1 <= window < 2**31, f"window {window} must be in [1, 2^31)")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      B, S, T, N, K, hd, window, int(causal), float(scale),
                      int(q.dtype == torch.bfloat16), stream)
    launches += 1
    return out
