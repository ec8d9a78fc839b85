"""Granite-4.0-H-Small — 40 layers, 36 Mamba2 mixers and 4 NoPE GQA mixers, each
followed by a 72-expert top-10 MoE with a shared SwiGLU expert; 32B total, 9B active.

[hf: ibm-granite/granite-4.0-h-small config.json, model_type granitemoehybrid].
d_model=4096; attention at layers 5, 15, 25, 35: 32 heads over 8 at head_dim 128,
no position embedding, scores times attention_multiplier 1/128; Mamba2: 128 heads
of 64 (expand 2), d_state 128, 1 group, conv 4; experts of 768, top-10 with the
softmax over the top-k logits (the renormalised softmax over all experts), a
shared expert of 1536 (two of 768 side by side); embeddings times 12, every
sub-block's output times 0.22, logits over 16; tied embeddings, vocab 100352,
RMSNorm eps 1e-5. d_ff is the published intermediate_size, the expert width.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=768,
    vocab_size=100352,
    head_dim=128,
    attention_kind="hybrid",
    tie_embeddings=True,
    use_rope=False,
    rms_norm_eps=1e-5,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=1.0 / 128,
    logits_scaling=16.0,
    moe=True,
    num_experts=72,
    experts_per_token=10,
    moe_d_ff=768,
    num_shared_experts=2,
    moe_renormalize=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    attention_layers=(5, 15, 25, 35),
    source="[hf: ibm-granite/granite-4.0-h-small config.json]",
))
