"""HuBERT X-Large — encoder-only audio transformer (wav2vec2 architecture).

[arXiv:2106.07447; unverified]. 48L, d_model=1280, 16H (kv=16), d_ff=5120, vocab=504
(500 cluster targets + specials). The CNN feature extractor is a STUB —
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
Encoder-only: no decode shapes (decode_32k and long_500k are documented skips).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    mlp_activation="gelu",
    causal=False,
    input_mode="embeddings",
    source="[arXiv:2106.07447; unverified]",
))
