"""CUDA Mamba2 SSD chunked-scan kernel: ctypes binding and launch wrapper.

The kernel (``csrc/mamba2_ssd.cu``) is plain CUDA C++ for ``sm_90a``, built
by ``kernels/_nvcc.py`` into the git-ignored ``build/`` at its first launch;
nothing is built or loaded at import time. ``ssd_pallas`` keeps the
reference's name and signature (``repro/kernels/mamba2_ssd/mamba2_ssd.py:82``).
It checks its inputs, casts A and D to fp32 as the reference does, allocates
y and the final state with ``torch.empty``, and launches on the current CUDA
stream without synchronising. ``launches`` counts the launches this process
made.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels._nvcc import I32, PTR, Kernel

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba2_ssd.cu"
# x, dt, A, Bm, C, D, state, y, state_out; B, T, H, P, N, chunk; is_bf16; stream
KERNEL = Kernel(SOURCE, "mamba2_ssd_fwd", [*[PTR] * 9, *[I32] * 6, I32, PTR])

MAX_CHUNK = 64
MAX_SHARED_BYTES = 232448        # dynamic shared memory one block may use on Hopper

launches = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_pallas: {msg}")


def shared_bytes(P: int, N: int, chunk: int) -> int:
    """The kernel's shared memory: fp64 L, then the fp32 state, x, B, C, scores
    and three chunk vectors."""
    ns = N + 1
    return 8 * chunk + 4 * (P * ns + chunk * P + 2 * chunk * ns + chunk * (chunk + 1) + 3 * chunk)


def ssd_pallas(x, dt, A, Bm, C, D, state, *, chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,H,P); dt: (B,T,H) fp32; A,D: (H,); Bm,C: (B,T,N); state:
    (B,H,P,N) fp32. x, Bm, C all fp32 or all bf16. Returns y (B,T,H,P) and
    the final state (B,H,P,N), both fp32."""
    global launches
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
    _check(1 <= chunk <= MAX_CHUNK, f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    _check(shared_bytes(P, N, chunk) <= MAX_SHARED_BYTES,
           f"P={P}, N={N}, chunk={chunk} need more shared memory than a block has")
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=x.device)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                      D.data_ptr(), state.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                      B, T, H, P, N, chunk, int(x.dtype == torch.bfloat16), stream)
    launches += 1
    return y, h_out
