"""Paged decode attention dispatch: the plain version on the CPU, the kernel on CUDA.

There is no fallback: a CUDA tensor goes to the CUDA kernel, which launches or
raises, and only a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import paged_attention as _kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, block_table, lengths, window: int, *,
                    scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                                   window, scale=scale)
    return _kernel.paged_attention(q, k_pages, v_pages, block_table, lengths,
                                   window, scale=scale)
