"""CUDA WKV6 chunked-scan kernel: ctypes binding and launch wrapper.

The kernel (``csrc/rwkv6_scan.cu``) is plain CUDA C++ for ``sm_90a``, built
by ``kernels/_nvcc.py`` into the git-ignored ``build/`` at its first launch;
nothing is built or loaded at import time. ``wkv6_pallas`` keeps the
reference's name and signature (``repro/kernels/rwkv6_scan/rwkv6_scan.py:80``).
It checks its inputs, allocates y, the final state and the fp32 scratch the
kernel's three passes hand each other with ``torch.empty``, and launches them
on the current CUDA stream without synchronising. ``launches`` counts the
calls that launched the kernel in this process.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels._nvcc import I32, PTR, Kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
# r, k, v, w, u, state, y, state_out, dS, a_step; B, T, H, K, V, chunk; is_bf16; stream
KERNEL = Kernel(SOURCE, "rwkv6_wkv_fwd", [*[PTR] * 10, *[I32] * 6, I32, PTR])

CHUNKS = (16, 32)      # the chunk lengths the kernel is instantiated for
HEAD_DIMS = (16, 32, 64)         # and the key head dims
MAX_V = 128            # the value head dim: a multiple of 8 up to this
STEP = 64              # positions a step of the carried state covers

launches = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wkv6_pallas: {msg}")


def wkv6_pallas(r, k, v, w, u, state, *, chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w: (B,T,H,K); v: (B,T,H,V); u: (H,K); state: (B,H,K,V). r, k, v
    all fp32 or all bf16; w, u and state fp32. Returns y (B,T,H,V) and the
    final state (B,H,K,V), both fp32."""
    global launches
    refuse_grad("wkv6_pallas", r, k, v, w, u, state)
    tensors = (r, k, v, w, u, state)
    _check(all(t.is_cuda for t in tensors), "all tensors must be CUDA tensors")
    _check(len({t.device for t in tensors}) == 1, "tensors are on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w, state)),
           "r, k, v, w and state must start on 16-byte boundaries")
    _check(r.dtype in (torch.float32, torch.bfloat16) and r.dtype == k.dtype == v.dtype,
           f"dtypes r {r.dtype}, k {k.dtype}, v {v.dtype}: all float32 or all bfloat16")
    _check(w.dtype == u.dtype == state.dtype == torch.float32, "w, u and state must be float32")
    _check(r.dim() == 4, f"r shape {tuple(r.shape)}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    _check(tuple(k.shape) == tuple(w.shape) == (B, T, H, K), "k and w must be shaped as r")
    _check(tuple(v.shape) == (B, T, H, V), f"v shape {tuple(v.shape)}")
    _check(tuple(u.shape) == (H, K), f"u shape {tuple(u.shape)}")
    _check(tuple(state.shape) == (B, H, K, V), f"state shape {tuple(state.shape)}")
    _check(chunk in CHUNKS, f"chunk {chunk} not in {CHUNKS}")
    _check(K in HEAD_DIMS, f"K={K} not in {HEAD_DIMS}")
    _check(8 <= V <= MAX_V and V % 8 == 0, f"V={V}: must be a multiple of 8 in [8, {MAX_V}]")
    _check(T >= 1 and B * H <= 65535, f"T={T}, B * H = {B * H}")
    y = torch.empty((B, T, H, V), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    # Pass 1 -> 2 -> 3: each step's own state contribution, overwritten by
    # pass 2 with the state the step starts from; each step's decay.
    steps = -(-T // STEP)
    d_s = torch.empty((B, H, steps, K, V), dtype=torch.float32, device=r.device)
    a_step = torch.empty((B, H, steps, K), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                      state.data_ptr(), y.data_ptr(), s_out.data_ptr(), d_s.data_ptr(),
                      a_step.data_ptr(), B, T, H, K, V, chunk,
                      int(r.dtype == torch.bfloat16), stream)
    launches += 1
    return y, s_out
