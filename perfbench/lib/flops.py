"""The yardstick's arithmetic: peaks of the card, and the operations and bytes
that a decode step, a prefill and each kernel call need, from their shapes.

Frozen copies: the kernel counts follow ``chip_smoke.py``'s ``paged_bytes``
and ``flash_flops``; the step counts are the work the step needs, so a MoE
counts its routed experts only (``num_experts_per_tok``), whatever a path
computes, and attention counts each (query, key) pair it must score.
"""

from __future__ import annotations

from typing import Iterable

from perfbench.lib.weights import dims

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W.
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def matmul_params(model: dict) -> int:
    """Weights a token multiplies through in the layers, per token: the
    attention projections, the MLP or the routed experts and the router."""
    d = dims(model)
    D, N, K, hd, F = d["D"], d["N"], d["K"], d["hd"], d["F"]
    attn = D * N * hd + 2 * D * K * hd + N * hd * D
    ffn = d["k"] * 3 * D * F + D * d["E"] if d["E"] else 3 * D * F
    return d["L"] * (attn + ffn)


def attention_pair_flops(model: dict) -> int:
    """Flops of one (query, key) pair over every head and layer: q.k and p.v,
    2 * hd each a head."""
    d = dims(model)
    return d["L"] * 4 * d["N"] * d["hd"]


def decode_flops(model: dict, contexts: Iterable[int]) -> float:
    """A decode step over tokens whose attention spans `contexts` keys each
    (the cached tokens and the new one): every layer, the unembedding."""
    d = dims(model)
    per_token = 2 * (matmul_params(model) + d["D"] * d["V"])
    ctx = list(contexts)
    return float(len(ctx) * per_token + attention_pair_flops(model) * sum(ctx))


def prefill_flops(model: dict, S: int, logits_rows: int = 1) -> float:
    """One causal prefill of S tokens, logits for `logits_rows` positions."""
    d = dims(model)
    pairs = S * (S + 1) // 2
    return float(2 * matmul_params(model) * S + 2 * d["D"] * d["V"] * logits_rows
                 + attention_pair_flops(model) * pairs)


def paged_bytes(model: dict, kv_lengths: Iterable[int], page: int,
                q_bytes: int = 2, kv_bytes: int = 4) -> int:
    """Bytes one paged-attention call (one layer) must move: each sequence's
    live K and V rows read once, its table entries and its length, q read and
    the output written once."""
    d = dims(model)
    n = list(kv_lengths)
    kv = sum(2 * t * d["K"] * d["hd"] * kv_bytes for t in n)
    table = sum(-(-t // page) * 4 for t in n) + 4 * len(n)
    return kv + table + 2 * len(n) * d["N"] * d["hd"] * q_bytes


def paged_seconds(model: dict, kv_lengths: Iterable[int], page: int) -> float:
    """Least time of one paged call: its bytes over the HBM rate or its
    flops (4 a query head and live element) over the fp32 rate."""
    d = dims(model)
    n = list(kv_lengths)
    t_bytes = paged_bytes(model, n, page) / HBM_BYTES
    t_ops = 4 * d["N"] * d["hd"] * sum(n) / FP32_FLOPS
    return max(t_bytes, t_ops)


def flash_seconds(model: dict, B: int, S: int, elem_bytes: int = 2) -> float:
    """Least time of one causal flash call (one layer): attention's 4 * hd
    flops a causal pair and head over the bf16 peak, or q, k, v read and the
    output written once over the HBM rate."""
    d = dims(model)
    pairs = S * (S + 1) // 2
    t_ops = 4 * B * d["N"] * d["hd"] * pairs / BF16_FLOPS
    t_bytes = (2 * B * S * d["N"] * d["hd"] + 2 * B * S * d["K"] * d["hd"]) * elem_bytes
    return max(t_ops, t_bytes / HBM_BYTES)
