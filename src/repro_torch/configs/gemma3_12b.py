"""Gemma 3 12B — dense, 5:1 local:global sliding-window attention, 128k-class context.

[hf:google/gemma-3-1b-pt family; unverified]. 48L, d_model=3840, 16H (GQA kv=8),
head_dim=256, d_ff=15360, vocab=262144, window=1024, every 6th layer global.
long_500k runs (see gemma3-1b note).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    mlp_activation="gelu_glu",
    attention_kind="sliding_global",
    sliding_window=1024,
    global_every=6,
    qk_norm=True,
    post_norms=True,
    scale_embedding=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="[hf:google/gemma-3-1b-pt; unverified]",
))
