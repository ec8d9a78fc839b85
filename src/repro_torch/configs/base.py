"""ArchConfig: one declarative description drives model init, sharding, and launch.

Every assigned architecture gets a module in this package defining ``CONFIG``; the
registry maps ``--arch <id>`` to it. ``reduced()`` produces a same-family micro config
for CPU smoke tests (the FULL configs are only ever lowered via the dry-run).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

ARCH_IDS = (
    "rwkv6-3b",
    "olmoe-1b-7b",
    "kimi-k2-1t-a32b",
    "internvl2-1b",
    "deepseek-coder-33b",
    "gemma3-1b",
    "nemotron-4-340b",
    "gemma3-12b",
    "zamba2-1.2b",
    "hubert-xlarge",
)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | hybrid_moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # -- block structure ----------------------------------------------------------
    mlp_activation: str = "swiglu"   # swiglu | gelu | squared_relu
    causal: bool = True              # False => encoder-only (no decode shapes)
    attention_kind: str = "full"     # full | sliding_global | none (rwkv) | hybrid (zamba)
    sliding_window: int = 0          # window size for sliding layers
    global_every: int = 0            # sliding_global: every k-th layer is global (gemma3: 6)
    qk_norm: bool = False
    post_norms: bool = False         # gemma3 sandwich norms
    scale_embedding: bool = False    # gemma: embed * sqrt(d_model)
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True            # False: no position embedding (granite's NoPE)
    rms_norm_eps: float = 1e-6       # hybrid_moe's norms and final norm
    # granite's multipliers: embeddings times embedding_multiplier, each
    # sub-block's output times residual_multiplier, attention scores times
    # attention_multiplier (0: head_dim ** -0.5), logits over logits_scaling
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0

    # -- MoE ------------------------------------------------------------------------
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    moe_first_dense: int = 0         # leading dense layers (kimi: 1)
    moe_renormalize: bool = True
    moe_aux_loss_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # -- SSM / RWKV -----------------------------------------------------------------
    ssm_state: int = 0               # mamba2 d_state
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_attn_every: int = 0          # zamba2: shared attn block every k ssm layers
    attention_layers: Tuple[int, ...] = ()   # hybrid_moe: the layers that run attention
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # -- modality -------------------------------------------------------------------
    input_mode: str = "tokens"       # tokens | embeddings (audio/vlm frontend stubs)

    # -- numerics -------------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    source: str = ""                 # provenance: [arXiv/hf; verification tier]

    # -- skips ----------------------------------------------------------------------
    # decode shapes skipped for encoders; long_500k skipped for pure full attention.
    def supports_shape(self, shape: ShapeConfig) -> Tuple[bool, str]:
        if shape.kind == "decode" and not self.causal:
            return False, "encoder-only arch has no decode step"
        if shape.name == "long_500k" and self.attention_kind == "full":
            return False, "long_500k requires sub-quadratic attention (pure full-attn arch)"
        return True, ""

    # -- derived --------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab dim shards on any mesh
        axis (embedding tables are padded; padded logits are masked at unembed)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs and memory budgets)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, N, K = self.resolved_head_dim, self.num_heads, self.num_kv_heads
        glu = self.mlp_activation in ("swiglu", "gelu_glu")
        mlp_mats = 3 if glu else 2
        total = V * D  # embed
        if not self.tie_embeddings:
            total += D * V
        per_layer = 0
        if self.attention_kind in ("full", "sliding_global"):
            per_layer += D * N * hd + 2 * D * K * hd + N * hd * D  # q,k,v,o
        if self.family == "ssm":  # rwkv6
            per_layer += 5 * D * D + 2 * D * self.rwkv_decay_lora  # r,k,v,g,o + decay lora
            per_layer += D * F + F * D + D * D  # channel mix
        elif self.family == "hybrid":  # mamba2 layers; shared attn counted ONCE below
            d_in = self.ssm_expand * D
            per_layer += D * (2 * d_in + 2 * self.ssm_state) + d_in * D + d_in
            total += D * N * hd + 2 * D * K * hd + N * hd * D + mlp_mats * D * F
        elif self.family == "hybrid_moe":  # a Mamba2 or an attention mixer a layer
            d_in, N_s = self.ssm_expand * D, self.ssm_state
            H, conv_dim = d_in // self.ssm_head_dim, d_in + 2 * self.ssm_state
            mamba = (D * (2 * d_in + 2 * N_s + H) + (self.ssm_conv + 1) * conv_dim
                     + 3 * H + d_in + d_in * D)
            n_attn = len(self.attention_layers)
            total += (n_attn * (D * N * hd + 2 * D * K * hd + N * hd * D)
                      + (L - n_attn) * mamba)
        if self.moe:
            ff_dense = mlp_mats * D * F
            ff_exp = self.num_experts * 3 * D * self.moe_d_ff
            ff_shared = self.num_shared_experts * 3 * D * self.moe_d_ff
            router = D * self.num_experts
            n_moe = L - self.moe_first_dense
            total += self.moe_first_dense * ff_dense + n_moe * (ff_exp + ff_shared + router)
        elif self.family not in ("ssm", "hybrid", "hybrid_moe"):
            per_layer += mlp_mats * D * F
        total += L * per_layer + L * 2 * D + D  # norms
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        D, L = self.d_model, self.num_layers
        ff_act = (self.experts_per_token + self.num_shared_experts) * 3 * D * self.moe_d_ff
        ff_all = self.num_experts * 3 * D * self.moe_d_ff
        ff_shared = self.num_shared_experts * 3 * D * self.moe_d_ff
        n_moe = L - self.moe_first_dense
        return self.param_count() - n_moe * (ff_all + ff_shared) + n_moe * ff_act

    def reduced(self) -> "ArchConfig":
        """Same-family micro config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            num_layers=min(self.num_layers, 4 if self.ssm_attn_every else 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            dtype="float32",
            param_dtype="float32",
        )
        if self.moe:
            kw.update(num_experts=8, experts_per_token=2, moe_d_ff=64,
                      moe_first_dense=min(self.moe_first_dense, 1),
                      num_shared_experts=min(self.num_shared_experts, 1))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16)
        if self.family == "ssm":
            kw.update(rwkv_head_dim=32, rwkv_decay_lora=16)
        if self.ssm_attn_every:
            kw.update(ssm_attn_every=2)
        if self.family == "hybrid_moe":   # two Mamba2 layers around one attention layer
            kw.update(num_layers=3, attention_layers=(1,))
        if self.global_every:
            kw.update(global_every=2, sliding_window=8)
        elif self.sliding_window:
            kw.update(sliding_window=8)
        return ArchConfig(**kw)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY) or ARCH_IDS}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    for a in ARCH_IDS:
        get_config(a)
    return dict(_REGISTRY)
