"""Gemma 3 1B — dense, 5:1 local:global sliding-window attention, 128k-class context.

[hf:google/gemma-3-1b-pt; unverified]. 26L, d_model=1152, 4H (GQA kv=1), head_dim=256,
d_ff=6912, vocab=262144, window=512, every 6th layer global. long_500k RUNS: 5/6 of
layers are sliding-window (sub-quadratic); the global layers decode O(L) against the
paged cache (see DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    mlp_activation="gelu_glu",      # gemma uses GeGLU
    attention_kind="sliding_global",
    sliding_window=512,
    global_every=6,
    qk_norm=True,
    post_norms=True,
    scale_embedding=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="[hf:google/gemma-3-1b-pt; unverified]",
))
