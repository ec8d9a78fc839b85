"""CUDA paged-attention decode kernel: ctypes binding and launch wrapper.

The kernel (``csrc/paged_attention.cu``) is plain CUDA C++ for ``sm_90a`` with
an ``extern "C"`` entry point, built by ``kernels/_nvcc.py`` into the
repository's git-ignored ``build/`` at its first launch. Nothing is built or
loaded at import time.

``paged_attention`` checks its inputs, allocates the output (and, when a
sequence's table spans more than one partition of ``PARTITION_TOKENS``, the
fp32 scratch of the partials) with ``torch.empty``, and launches on the
current CUDA stream without synchronising. The number of partitions comes from
the table's width, never from ``lengths``, so a call does not sync the device.
``launches`` counts the calls this process made (a call with more than one
partition launches the partition kernel and then the combine).
"""

from __future__ import annotations

import operator
from pathlib import Path

import torch

from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels._nvcc import F32, I32, PTR, Kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
# q, k_pages, v_pages, block_table, lengths, out, part_ml, part_acc; B, N, K, hd,
# page, max_pages, window; scale; q_is_bf16, parts, part_tokens; stream
KERNEL = Kernel(SOURCE, "paged_attention_fwd",
                [*[PTR] * 8, *[I32] * 7, F32, *[I32] * 3, PTR])

HEAD_DIMS = (32, 64, 80, 128, 192, 256)
PAGE_SIZES = (8, 16, 32)
GROUPS = tuple(range(1, 17))     # query heads per kv head
PARTITION_TOKENS = 64     # tokens a block takes: kPartition in the source
NEG_INF = -1.0e30         # a masked score, in the kernel and its plain version

launches = 0


def num_partitions(max_pages: int, page: int) -> int:
    """Partitions of PARTITION_TOKENS that cover a table of `max_pages` pages."""
    return -(-max_pages * page // PARTITION_TOKENS)


def _check(cond: bool, msg: str, *args) -> None:
    """Raise unless `cond`. The message is formatted only on failure: a call
    that passes builds no strings on the decode path's host time."""
    if not cond:
        raise ValueError("paged_attention: " + (msg % args if args else msg))


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, lengths: torch.Tensor, window: int,
                    *, scale: float) -> torch.Tensor:
    """Launch the CUDA kernel. q (B,N,hd) fp32/bf16; pages (P,page,K,hd) fp32;
    block_table (B,max_pages) int32; lengths (B,) int32; window a Python int.
    Returns (B,N,hd) in q's dtype."""
    global launches
    refuse_grad("paged_attention", q, k_pages, v_pages)
    window = operator.index(window)
    tensors = (q, k_pages, v_pages, block_table, lengths)
    _check(all(t.is_cuda for t in tensors), "all tensors must be CUDA tensors")
    device = q.device
    _check(all(t.device == device for t in tensors), "tensors are on different devices")
    _check(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors),
           "tensors must be contiguous and 16-byte aligned")
    _check(q.dtype in (torch.float32, torch.bfloat16), "q dtype %s", q.dtype)
    _check(k_pages.dtype == v_pages.dtype == torch.float32, "pages must be float32")
    _check(block_table.dtype == lengths.dtype == torch.int32, "table/lengths must be int32")
    _check(q.dim() == 3 and k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           "shapes q %s, pages %s/%s", q.shape, k_pages.shape, v_pages.shape)
    B, N, hd = q.shape
    _, page, K, hd_k = k_pages.shape
    _check(hd_k == hd, "head_dim %d vs pages %d", hd, hd_k)
    _check(block_table.dim() == 2 and block_table.shape[0] == B,
           "block_table must be (B, max_pages)")
    _check(lengths.shape == (B,), "lengths must be (B,)")
    _check(N % K == 0 and N // K in GROUPS, "N/K = %d/%d: group size must be in 1..%d",
           N, K, GROUPS[-1])
    _check(hd in HEAD_DIMS, "head_dim %d not in %s", hd, HEAD_DIMS)
    _check(page in PAGE_SIZES, "page size %d not in %s", page, PAGE_SIZES)
    _check(1 <= window < 2**31, "window %d must be in [1, 2^31)", window)
    max_pages = block_table.shape[1]
    parts = num_partitions(max_pages, page)
    _check(max_pages >= 1 and parts <= 65535, "block_table width %d", max_pages)
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if parts > 1:
        # One fp32 scratch for the partials: acc (B*K, parts, G, hd), then (m, l).
        n_acc = B * N * parts * hd
        scratch = torch.empty(n_acc + B * N * parts * 2, dtype=torch.float32, device=device)
        part_acc = scratch.data_ptr()
        part_ml = part_acc + 4 * n_acc
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        KERNEL.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                      part_ml, part_acc, B, N, K, hd, page, max_pages, window, float(scale),
                      int(q.dtype == torch.bfloat16), parts, PARTITION_TOKENS, stream)
    launches += 1
    return out
