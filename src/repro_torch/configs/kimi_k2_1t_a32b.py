"""Kimi K2 — trillion-parameter MoE, 32B active (paper-table config).

[arXiv:2501.kimi2; unverified]. 61L, d_model=7168, 64H (GQA kv=8), 384 experts top-8,
expert d_ff=2048, 1 shared expert, 1 leading dense layer, vocab=163840. head_dim=128
(DeepSeek-V3 lineage). The assignment specifies GQA kv=8 (not MLA) — we follow the
assignment table.

This is the arch where the paper's technique is load-bearing: optimizer moments +
fp32 master params live in the emulated-CXL host tier (see core/offload.py manifest);
HBM holds bf16 params/grads sharded 512-way.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=18432,              # dense-layer ffn (DeepSeek-V3 lineage first dense layer)
    vocab_size=163840,
    head_dim=128,
    moe=True,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    moe_first_dense=1,
    moe_renormalize=True,
    source="[arXiv:2501.kimi2; unverified]",
))
