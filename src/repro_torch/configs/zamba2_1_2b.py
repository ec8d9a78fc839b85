"""Zamba2-1.2B — Mamba2 backbone with a shared attention block every 6 SSM layers.

[arXiv:2411.15242; hf]. 38 Mamba2 layers, d_model=2048, shared attn 32H (kv=32,
head_dim=64), shared-block d_ff=8192, vocab=32000, ssm_state=64. long_500k runs
(O(1) SSM state; the shared attention invocations attend over the cache O(L)/token).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    attention_kind="hybrid",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_attn_every=6,
    source="[arXiv:2411.15242; hf]",
))
