"""Plain PyTorch reference of the served decoders (dense, and MoE with top-k of
the router's softmax), for the comparison that decides ``correct``.

It reads the configuration file and the benchmark's own weight tree (the
layout of ``lib/weights.py``), never anything of the program, and computes
one layer at a time: each layer's weights are raised from their served dtype
to the compute precision, used by every sequence, and dropped, so the
reference fits beside the served weights on the card.

Precisions (``mode``):
  * ``fp32``: float32 with TF32 off, the reference the program is held to;
  * ``fp64``: float64, for the CPU checks of the fp32 path;
  * ``fp8``: the control, every matmul's operands rounded to float8 e4m3
    (activations a scale a row, weights a scale an output column) and
    multiplied in float32: the step below the configuration's bf16.

The architecture as the port runs it (``as_run`` in the configuration file):
pre-norm blocks, RMSNorm as ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``,
RoPE rotating the two halves of a head, optional RMSNorm of each head of q
and k before RoPE, causal grouped-query attention, a SwiGLU MLP or a MoE of
SwiGLU experts, final norm, an untied unembedding over the published vocab.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

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


def _moe(x, lw, model, prec: Precision):
    """Softmax over the router's logits, the top-k experts each token, their
    outputs weighted by the softmax (renormalised only where the config says)."""
    E, k = model["num_experts"], model["num_experts_per_tok"]
    logits = x @ lw["router"].to(prec.dtype)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    if model.get("norm_topk_prob", False):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(E):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(x[rows], prec.weight(lw["w_gate"][e]), prec.weight(lw["w_up"][e]),
                    prec.weight(lw["w_down"][e]), prec)
        out.index_add_(0, rows, y * top_p[rows, slot, None])
    return out


def _layer_weights(stack: dict, i: int) -> dict:
    flat = {}
    for group in ("attn", "mlp", "moe"):
        for name, leaf in stack.get(group, {}).items():
            flat[name] = leaf[i]
    flat["ln1"], flat["ln2"] = stack["ln1"][i], stack["ln2"][i]
    return flat


def forward(weights: dict, model: dict, seqs: Sequence[torch.Tensor], *,
            mode: str = "fp32",
            logits_at: Optional[Sequence[Optional[torch.Tensor]]] = None,
            on_kv: Optional[Callable[[int, int, torch.Tensor, torch.Tensor], None]] = None
            ) -> List[torch.Tensor]:
    """Logits of each token sequence in `seqs` (1-D int tensors), at the
    positions ``logits_at[i]`` (all where None), over the published vocab.
    ``on_kv(layer, i, k, v)`` sees sequence i's keys (after RoPE) and values
    of each layer, (S, K, hd) in the compute precision."""
    prec = Precision(mode)
    run_as = {**model, **model.get("as_run", {})}
    eps = float(run_as["rms_norm_eps"])
    theta = float(run_as["rope_theta"])
    D, N = model["hidden_size"], model["num_attention_heads"]
    K = model["num_key_value_heads"]
    hd = model.get("head_dim", D // N)
    L, V = model["num_hidden_layers"], model["vocab_size"]
    stack = weights["stack"]
    ctx = exact_fp32() if prec.dtype == torch.float32 else contextlib.nullcontext()
    with ctx, torch.no_grad():
        hs = [weights["embed"][s.long()].to(prec.dtype) for s in seqs]
        for i in range(L):
            lw = _layer_weights(stack, i)
            wq = prec.weight(lw["wq"].reshape(D, N * hd))
            wk = prec.weight(lw["wk"].reshape(D, K * hd))
            wv = prec.weight(lw["wv"].reshape(D, K * hd))
            wo = prec.weight(lw["wo"].reshape(N * hd, D))
            if "router" not in lw:
                mlp = [prec.weight(lw[n]) for n in ("w_gate", "w_up", "w_down")]
            for j, h in enumerate(hs):
                S = h.shape[0]
                x = prec.act(_rms(h, lw["ln1"], eps))
                q = (x @ wq).reshape(S, N, hd)
                k = (x @ wk).reshape(S, K, hd)
                v = (x @ wv).reshape(S, K, hd)
                if "q_norm" in lw:
                    q, k = _rms(q, lw["q_norm"], eps), _rms(k, lw["k_norm"], eps)
                q, k = _rope(q, theta), _rope(k, theta)
                if on_kv is not None:
                    on_kv(i, j, k, v)
                h = h + prec.act(_attention(q, k, v)) @ wo
                x = _rms(h, lw["ln2"], eps)
                if "router" in lw:
                    h = h + _moe(x, lw, model, prec)
                else:
                    h = h + _swiglu(x, *mlp, prec)
                hs[j] = h
            del lw
        wu = prec.weight(weights["unembed"][:, :V])
        out = []
        for j, h in enumerate(hs):
            rows = None if logits_at is None else logits_at[j]
            h = h if rows is None else h[rows]
            out.append(prec.act(_rms(h, weights["final_norm"], eps)) @ wu)
        return out


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below its row's best, (rows,)."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, tokens.long()[:, None])[:, 0]


def relative(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref||, in float64."""
    a, ref = a.double(), ref.double()
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))
