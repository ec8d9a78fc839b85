"""The yardstick's arithmetic: peaks of the card, and the operations and bytes
that a decode step, a prefill and each kernel call need, from their shapes.

Frozen copies: the kernel counts follow ``chip_smoke.py``'s ``paged_bytes``
and ``flash_flops``; the step counts are the work the step needs, so a MoE
counts its routed experts only (``num_experts_per_tok``), whatever a path
computes, and attention counts each (query, key) pair it must score. What
depends on the architecture (the weights a token multiplies through, the
layers that run attention, their widths) is asked of its module,
``files.architecture(model)``; a kernel count is per call, one call a layer
that runs attention (``attention_layer_count``).
"""

from __future__ import annotations

from typing import Iterable

from perfbench.lib import files

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W.
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def matmul_params(model: dict) -> int:
    """Weights a token multiplies through in the layers, per token (the
    architecture's count: for the decoder, the attention projections, the MLP
    or the routed experts and the router)."""
    return files.architecture(model).matmul_params(model)


def attention_pair_flops(model: dict) -> int:
    """Flops of one (query, key) pair over every head of every layer that
    runs attention (the architecture's count: q.k and p.v, 2 * hd each a
    head)."""
    return files.architecture(model).attention_pair_flops(model)


def mixer_token_flops(model: dict) -> int:
    """Flops a token needs in mixers other than attention beyond their
    matmuls (a state-space scan's update and readout), over every layer: the
    architecture's ``mixer_token_flops``, 0 where it has none."""
    count = getattr(files.architecture(model), "mixer_token_flops", None)
    return count(model) if count is not None else 0


def attention_layer_count(model: dict) -> int:
    """Layers that run attention: each calls the attention kernel once a
    prefill or a decode step."""
    return len(files.architecture(model).attention_layers(model))


def _dims(model: dict) -> dict:
    return files.architecture(model).dims(model)


def decode_flops(model: dict, contexts: Iterable[int]) -> float:
    """A decode step over tokens whose attention spans `contexts` keys each
    (the cached tokens and the new one): every layer, the unembedding."""
    d = _dims(model)
    per_token = 2 * (matmul_params(model) + d["D"] * d["V"]) + mixer_token_flops(model)
    ctx = list(contexts)
    return float(len(ctx) * per_token + attention_pair_flops(model) * sum(ctx))


def prefill_flops(model: dict, S: int, logits_rows: int = 1) -> float:
    """One causal prefill of S tokens, logits for `logits_rows` positions."""
    d = _dims(model)
    pairs = S * (S + 1) // 2
    return float(2 * matmul_params(model) * S + mixer_token_flops(model) * S
                 + 2 * d["D"] * d["V"] * logits_rows + attention_pair_flops(model) * pairs)


def paged_bytes(model: dict, kv_lengths: Iterable[int], page: int,
                q_bytes: int = 2, kv_bytes: int = 4) -> int:
    """Bytes one paged-attention call (one layer) must move: each sequence's
    live K and V rows read once, its table entries and its length, q read and
    the output written once."""
    d = _dims(model)
    n = list(kv_lengths)
    kv = sum(2 * t * d["K"] * d["hd"] * kv_bytes for t in n)
    table = sum(-(-t // page) * 4 for t in n) + 4 * len(n)
    return kv + table + 2 * len(n) * d["N"] * d["hd"] * q_bytes


def paged_seconds(model: dict, kv_lengths: Iterable[int], page: int) -> float:
    """Least time of one paged call: its bytes over the HBM rate or its
    flops (4 a query head and live element) over the fp32 rate."""
    d = _dims(model)
    n = list(kv_lengths)
    t_bytes = paged_bytes(model, n, page) / HBM_BYTES
    t_ops = 4 * d["N"] * d["hd"] * sum(n) / FP32_FLOPS
    return max(t_bytes, t_ops)


def flash_seconds(model: dict, B: int, S: int, elem_bytes: int = 2) -> float:
    """Least time of one causal flash call (one layer): attention's 4 * hd
    flops a causal pair and head over the bf16 peak, or q, k, v read and the
    output written once over the HBM rate."""
    d = _dims(model)
    pairs = S * (S + 1) // 2
    t_ops = 4 * B * d["N"] * d["hd"] * pairs / BF16_FLOPS
    t_bytes = (2 * B * S * d["N"] * d["hd"] + 2 * B * S * d["K"] * d["hd"]) * elem_bytes
    return max(t_ops, t_bytes / HBM_BYTES)
