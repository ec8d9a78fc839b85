"""InternVL2-1B — InternViT frontend + Qwen2-0.5B language backbone.

[arXiv:2404.16821; hf]. Backbone only (assignment): 24L, d_model=896, 14H (GQA kv=2),
d_ff=4864, vocab=151655. The ViT frontend is a STUB — ``input_specs()`` provides
precomputed patch embeddings (B, S, d_model).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    tie_embeddings=True,
    input_mode="embeddings",
    rope_theta=1_000_000.0,
    source="[arXiv:2404.16821; hf]",
))
