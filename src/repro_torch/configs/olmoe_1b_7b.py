"""OLMoE-1B-7B — 64-expert top-8 MoE, 1B active / 7B total.

[arXiv:2409.02060; hf]. 16L, d_model=2048, 16H (kv=16, i.e. MHA), expert d_ff=1024,
vocab=50304. OLMoE routes with softmax-then-top8 without renormalization.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    qk_norm=True,
    moe=True,
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    moe_renormalize=False,
    source="[arXiv:2409.02060; hf]",
))
