"""CUDA paged-attention decode kernel: ctypes binding and launch wrapper.

The kernel (``csrc/paged_attention.cu``) is plain CUDA C++ for ``sm_90a`` with
an ``extern "C"`` entry point, built by ``kernels/_nvcc.py`` into the
repository's git-ignored ``build/`` at its first launch. Nothing is built or
loaded at import time.

``paged_attention`` checks its inputs, allocates the output with
``torch.empty``, and launches on the current CUDA stream without
synchronising. ``launches`` counts the launches this process made.
"""

from __future__ import annotations

import operator
from pathlib import Path

import torch

from repro_torch.kernels._nvcc import F32, I32, PTR, Kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
# q, k_pages, v_pages, block_table, lengths, out; B, N, K, hd, page, max_pages,
# window; scale; q_is_bf16; stream
KERNEL = Kernel(SOURCE, "paged_attention_fwd", [*[PTR] * 6, *[I32] * 7, F32, I32, PTR])

HEAD_DIMS = (32, 64, 128, 256)
PAGE_SIZES = (8, 16, 32)
GROUPS = (1, 2, 4, 8)

launches = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, lengths: torch.Tensor, window: int,
                    *, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel. q (B,N,hd) fp32/bf16; pages (P,page,K,hd) fp32;
    block_table (B,max_pages) int32; lengths (B,) int32; window a Python int.
    Returns (B,N,hd) in q's dtype."""
    global launches
    window = operator.index(window)
    tensors = (q, k_pages, v_pages, block_table, lengths)
    _check(all(t.is_cuda for t in tensors), "all tensors must be CUDA tensors")
    _check(len({t.device for t in tensors}) == 1, "tensors are on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(q.dtype in (torch.float32, torch.bfloat16), f"q dtype {q.dtype}")
    _check(k_pages.dtype == v_pages.dtype == torch.float32, "pages must be float32")
    _check(block_table.dtype == lengths.dtype == torch.int32, "table/lengths must be int32")
    _check(q.dim() == 3 and k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           f"shapes q {tuple(q.shape)}, pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    B, N, hd = q.shape
    _, page, K, hd_k = k_pages.shape
    _check(hd_k == hd, f"head_dim {hd} vs pages {hd_k}")
    _check(block_table.dim() == 2 and block_table.shape[0] == B,
           "block_table must be (B, max_pages)")
    _check(tuple(lengths.shape) == (B,), "lengths must be (B,)")
    _check(N % K == 0 and N // K in GROUPS, f"N/K = {N}/{K}: group size must be in {GROUPS}")
    _check(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _check(page in PAGE_SIZES, f"page size {page} not in {PAGE_SIZES}")
    _check(window >= 1, f"window {window} must be >= 1")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                      B, N, K, hd, page, block_table.shape[1], window, float(scale),
                      int(q.dtype == torch.bfloat16), stream)
    launches += 1
    return out
