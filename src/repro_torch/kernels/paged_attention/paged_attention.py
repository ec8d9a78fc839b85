"""CUDA paged-attention decode kernel: build, ctypes binding, and launch wrapper.

The kernel (``csrc/paged_attention.cu``) is plain CUDA C++ for ``sm_90a`` with
an ``extern "C"`` entry point. ``build()`` compiles it with ``nvcc`` into the
repository's git-ignored ``build/`` directory at first use, named by a hash of
the source and flags so an edit rebuilds, and ``ctypes`` loads the result.
Nothing is built or loaded at import time.

``paged_attention`` checks its inputs, allocates the output with
``torch.empty``, and launches on the current CUDA stream without
synchronising. ``launches`` counts the launches this process made.
"""

from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HEAD_DIMS = (32, 64, 128, 256)
PAGE_SIZES = (8, 16, 32)
GROUPS = (1, 2, 4, 8)

launches = 0
_fn = None
_err_str = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"    # the toolkit's standard install prefix
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Tuple[Path, str]:
    """Compile the kernel if this source has not been built; returns the
    shared library's path and nvcc's output (empty when it was cached)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"paged_attention_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)     # atomic: a concurrent loader never sees half a file
    return lib, proc.stdout + proc.stderr


def _load():
    global _fn, _err_str
    if _fn is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.paged_attention_fwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # q, k_pages, v_pages, block_table, lengths, out; B, N, K, hd, page,
        # max_pages, window; scale; q_is_bf16; stream
        fn.argtypes = [*[ptr] * 6, *[i32] * 7, ctypes.c_float, i32, ptr]
        fn.restype = ctypes.c_int
        err_str = lib.paged_attention_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fn, _err_str = fn, err_str
    return _fn


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
    fn = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 B, N, K, hd, page, block_table.shape[1], window, float(scale),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention launch failed: CUDA error {err} "
            f"({_err_str(err).decode()})")
    launches += 1
    return out
