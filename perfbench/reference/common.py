"""What every architecture's reference shares: the compute precisions, the
served dtypes, RMSNorm, RoPE, causal grouped-query attention, a SwiGLU block,
and the two readings the drivers compare by (``gaps``, ``relative``).

An architecture module (``perfbench/reference/<name>.py``) imports these
instead of copying them; like every file here, this one imports nothing of
the program.

Precisions (``mode``):
  * ``fp32``: float32 with TF32 off, the reference the program is held to;
  * ``fp64``: float64, for the CPU checks of the fp32 path;
  * ``fp8``: the control, every matmul's operands rounded to float8 e4m3
    (activations a scale a row, weights a scale an output column) and
    multiplied in float32: the step below the configuration's bf16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}
E4M3_MAX = 448.0
Q_BLOCK = 1024


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for every float32 product inside."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _to_e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` rounded to float8 e4m3 with one scale along `dim`, back in x's dtype."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Precision:
    def __init__(self, mode: str):
        if mode not in ("fp32", "fp64", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "fp64" else torch.float32

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (in, out) weight in compute precision; under fp8 rounded with
        one scale per output column."""
        w = w.to(self.dtype)
        return _to_e4m3(w, 0) if self.mode == "fp8" else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A matmul's activation operand (rows are tokens)."""
        return _to_e4m3(x, -1) if self.mode == "fp8" else x


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.to(x.dtype))


def _rope(x, theta):
    """x (S, H, hd) at positions 0..S-1: the two halves rotated."""
    S, _, hd = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=x.dtype, device=x.device) / hd))
    ang = torch.arange(S, dtype=x.dtype, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal GQA over one sequence: q (S, N, hd), k and v (S, K, hd)."""
    S, N, hd = q.shape
    K = k.shape[1]
    G = N // K
    qg = q.reshape(S, K, G, hd).permute(1, 2, 0, 3)             # (K, G, S, hd)
    kt = k.permute(1, 2, 0)                                     # (K, hd, S)
    vt = v.permute(1, 0, 2)                                     # (K, S, hd)
    out = torch.empty_like(qg)
    keys = torch.arange(S, device=q.device)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        s = (qg[:, :, a:b] @ kt[:, None]) * hd ** -0.5            # (K, G, rows, S)
        mask = keys[None, :] > torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, :, a:b] = torch.softmax(s, dim=-1) @ vt[:, None]
    return out.permute(2, 0, 1, 3).reshape(S, N * hd)


def _swiglu(x, wg, wu, wd, prec: Precision):
    xa = prec.act(x)
    h = F.silu(xa @ wg) * (xa @ wu)
    return prec.act(h) @ wd


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below its row's best, (rows,)."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, tokens.long()[:, None])[:, 0]


def relative(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref||, in float64."""
    a, ref = a.double(), ref.double()
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))
