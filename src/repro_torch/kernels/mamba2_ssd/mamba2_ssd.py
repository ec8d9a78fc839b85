"""CUDA Mamba2 SSD chunked-scan kernel: ctypes binding and launch wrapper.

The kernel (``csrc/mamba2_ssd.cu``) is plain CUDA C++ for ``sm_90a``, built
by ``kernels/_nvcc.py`` into the git-ignored ``build/`` at its first launch;
nothing is built or loaded at import time. ``ssd_pallas`` keeps the
reference's name and signature (``repro/kernels/mamba2_ssd/mamba2_ssd.py:82``).
It checks its inputs, casts A and D to fp32 as the reference does, allocates
y, the final state and the fp32 scratch the kernel's three passes hand each
other with ``torch.empty``, and launches them on the current CUDA stream
without synchronising. ``launches`` counts the calls that launched the kernel
in this process.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels._nvcc import I32, PTR, Kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba2_ssd.cu"
# x, dt, A, Bm, C, D, state, y, state_out, dH, a_last, cb; B, T, H, P, N, chunk; is_bf16; stream
KERNEL = Kernel(SOURCE, "mamba2_ssd_fwd", [*[PTR] * 12, *[I32] * 6, I32, PTR])

CHUNKS = (16, 32)      # the chunk lengths the kernel is instantiated for
MAX_WIDTH = 64         # the largest head dim P and state size N; both multiples of 4

launches = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_pallas: {msg}")


def ssd_pallas(x, dt, A, Bm, C, D, state, *, chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H) fp32; A,D: (H,); Bm,C: (B,T,N); state:
    (B,H,P,N) fp32. x, Bm, C all fp32 or all bf16. Returns y (B,T,H,P) and
    the final state (B,H,P,N), both fp32."""
    global launches
    refuse_grad("ssd_pallas", x, dt, A, Bm, C, D, state)
    A, D = A.float().contiguous(), D.float().contiguous()
    tensors = (x, dt, A, Bm, C, D, state)
    _check(all(t.is_cuda for t in tensors), "all tensors must be CUDA tensors")
    _check(len({t.device for t in tensors}) == 1, "tensors are on different devices")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    _check(x.dtype in (torch.float32, torch.bfloat16) and x.dtype == Bm.dtype == C.dtype,
           f"dtypes x {x.dtype}, Bm {Bm.dtype}, C {C.dtype}: all float32 or all bfloat16")
    _check(dt.dtype == state.dtype == torch.float32, "dt and state must be float32")
    _check(x.dim() == 4, f"x shape {tuple(x.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    _check(tuple(dt.shape) == (B, T, H), f"dt shape {tuple(dt.shape)}")
    _check(tuple(A.shape) == tuple(D.shape) == (H,), "A and D must be (H,)")
    _check(tuple(Bm.shape) == tuple(C.shape) == (B, T, N), "Bm and C must be (B, T, N)")
    _check(tuple(state.shape) == (B, H, P, N), f"state shape {tuple(state.shape)}")
    _check(chunk in CHUNKS, f"chunk {chunk} not in {CHUNKS}")
    _check(all(4 <= n <= MAX_WIDTH and n % 4 == 0 for n in (P, N)),
           f"P={P}, N={N}: each must be a multiple of 4 in [4, {MAX_WIDTH}]")
    _check(T >= 1 and B <= 65535 and H <= 65535, f"B={B}, T={T}, H={H}")
    _check(all(t.data_ptr() % 16 == 0 for t in (x, Bm, C, state)),
           "x, Bm, C and state must start on 16-byte boundaries")
    nc = -(-T // chunk)
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=x.device)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # Pass 1 -> 2 -> 3: each chunk's own state contribution, overwritten by
    # pass 2 with the state the chunk starts from; exp(L_last); C B^T per chunk.
    d_h = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=x.device)
    a_last = torch.empty((B, H, nc), dtype=torch.float32, device=x.device)
    cb = torch.empty((B, nc, chunk, chunk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                      D.data_ptr(), state.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                      d_h.data_ptr(), a_last.data_ptr(), cb.data_ptr(), B, T, H, P, N, chunk,
                      int(x.dtype == torch.bfloat16), stream)
    launches += 1
    return y, h_out
