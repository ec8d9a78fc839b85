"""Nemotron-4 340B — dense, GQA, squared-ReLU MLP.

[arXiv:2402.16819; unverified]. 96L, d_model=18432, 96H (GQA kv=8), head_dim=192,
d_ff=73728, vocab=256000. The largest dense arch in the pool — optimizer-state offload
to the emulated-CXL host tier is required to fit training state on 16 GB chips.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    mlp_activation="squared_relu",
    source="[arXiv:2402.16819; unverified]",
))
