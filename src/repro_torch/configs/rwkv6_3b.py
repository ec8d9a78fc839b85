"""RWKV6 "Finch" 3B — attention-free linear RNN with data-dependent decay.

[arXiv:2404.05892; hf]. 32L, d_model=2560, d_ff=8960, vocab=65536, head_dim=64
(40 WKV heads). No attention anywhere; long_500k runs (O(1) recurrent state).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # WKV heads = d_model / rwkv_head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    attention_kind="none",
    mlp_activation="relu_sq_channelmix",  # RWKV channel-mix uses squared ReLU
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    source="[arXiv:2404.05892; hf]",
))
