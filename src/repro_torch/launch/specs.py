"""Shape stand-ins + sharding trees for every (arch x shape) cell.

The port of ``repro/launch/specs.py``. The reference's
``jax.ShapeDtypeStruct``/``eval_shape`` stand-ins become tensors on the meta
device: shapes and dtypes, no memory, so the full configs build in
seconds. For [audio]/[vlm] archs the modality frontend is a stub: specs hand
the backbone precomputed frame/patch embeddings, as the reference's do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import named_sharding
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

META = "meta"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# --------------------------------------------------------------------- rule choice
def is_small_arch(cfg: ArchConfig) -> bool:
    """Archs where TP would mostly replicate (few heads / narrow ff): go pure DP."""
    return cfg.param_count() < 2_000_000_000 and not cfg.moe


def rules_for(cfg: ArchConfig, shape: ShapeConfig) -> str:
    """Default rule set per cell (the §Perf baselines; hillclimbs override)."""
    if shape.kind == "train":
        return "train_dp_all" if is_small_arch(cfg) else "train_fsdp"
    if shape.name == "long_500k":
        return "serve_sp_cache"
    # serving: pure TP unless bf16 weights exceed ~half of HBM across the model
    # axis. Archs whose head count cannot divide the 16-way model axis keep their
    # attention weights replicated under TP, so size them by their REPLICATED bytes.
    tp = 16
    bf16_bytes = cfg.param_count() * 2
    effective = bf16_bytes / tp
    if cfg.num_heads % tp != 0 and bf16_bytes > 16 * 2**30:
        effective = bf16_bytes / 2  # attention weights ~replicated
    if effective > 8 * 2**30:
        return "serve_fsdp_tp"
    return "serve_tp"


def opt_rules_for(rules: str) -> str:
    """Optimizer-state rule set (ZeRO-1 sharding when params are replicated)."""
    return "train_zero1" if rules == "train_dp_all" else rules


# --------------------------------------------------------------------- batch specs
def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    act = dtype_of(cfg.dtype)
    if shape.kind == "train":
        inp = (_meta((B, S), torch.int32) if cfg.input_mode == "tokens"
               else _meta((B, S, cfg.d_model), act))
        return {"inputs": inp, "targets": _meta((B, S), torch.int32)}
    if shape.kind == "prefill":
        if cfg.input_mode == "tokens":
            return {"inputs": _meta((B, S), torch.int32)}
        return {"inputs": _meta((B, S, cfg.d_model), act)}
    # decode: one new token against a cache of S
    if cfg.input_mode == "tokens":
        return {"inputs": _meta((B, 1), torch.int32)}
    return {"inputs": _meta((B, 1, cfg.d_model), act)}


def batch_axes(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    inp_ax = ("batch", "seq") if cfg.input_mode == "tokens" \
        else ("batch", "seq", None)
    ax = {"inputs": inp_ax}
    if shape.kind == "train":
        ax["targets"] = ("batch", "seq")
    return ax


# --------------------------------------------------------------------- state specs
def decode_state_specs(cfg: ArchConfig, shape: ShapeConfig,
                       sliding_ring: bool = False):
    B, S = shape.global_batch, shape.seq_len
    return tf.init_decode_state(params_specs(cfg), cfg, B, S, sliding_ring=sliding_ring)


def params_specs(cfg: ArchConfig):
    return tf.init_params(None, cfg, device=META)


def opt_state_specs(cfg: ArchConfig, hp: adamw.OptimizerConfig):
    """The optimizer state's shapes, as ``adamw.init_state`` lays it out (the
    host tier is a placement, given by ``opt_state_shardings``)."""
    params = params_specs(cfg)
    f32 = lambda p: _meta(p.shape, torch.float32)   # noqa: E731
    out: Dict[str, Any] = {"m": tree_map(f32, params), "v": tree_map(f32, params),
                           "step": _meta((), torch.int32)}
    if hp.use_master_fp32:
        out["master"] = tree_map(f32, params)
    return out


# --------------------------------------------------------------------- shardings
def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_shardings(axes_tree: Any, shapes_tree: Any, mesh, rules,
                   memory_kind: Optional[str] = None):
    """Map (logical-axes tree, shapes tree) -> NamedSharding tree."""

    def one(axes, sds):
        return named_sharding(axes, mesh, rules, memory_kind=memory_kind,
                              shape=sds.shape)

    return tree_map(one, axes_tree, shapes_tree, is_leaf=_is_axes)


def param_shardings(cfg: ArchConfig, mesh, rules):
    return tree_shardings(tf.param_axes(cfg), params_specs(cfg), mesh, rules)


def opt_state_shardings(cfg: ArchConfig, hp: adamw.OptimizerConfig, mesh, rules):
    """Optimizer-state shardings; moments/master go to the host tier when offloaded.

    When params are replicated (train_dp_all) the state still shards ZeRO-1-style
    over all axes (opt_rules_for), so per-device optimizer bytes scale down with
    the mesh.
    """
    if isinstance(rules, str):
        rules = opt_rules_for(rules)
    pax = tf.param_axes(cfg)
    specs = opt_state_specs(cfg, hp)
    kind = "pinned_host" if hp.offload_state else None
    out = {
        "m": tree_shardings(pax, specs["m"], mesh, rules, memory_kind=kind),
        "v": tree_shardings(pax, specs["v"], mesh, rules, memory_kind=kind),
        "step": named_sharding((), mesh, rules),
    }
    if "master" in specs:
        out["master"] = tree_shardings(pax, specs["master"], mesh, rules,
                                       memory_kind=kind)
    return out


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh, rules):
    specs = batch_specs(cfg, shape)
    axes = batch_axes(cfg, shape)
    return {
        k: named_sharding(axes[k], mesh, rules, shape=specs[k].shape) for k in specs
    }


def decode_state_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh, rules,
                           sliding_ring: bool = False):
    axes = tf.decode_state_axes(cfg, sliding_ring=sliding_ring)
    specs = decode_state_specs(cfg, shape, sliding_ring=sliding_ring)
    return tree_shardings(axes, specs, mesh, rules)


# --------------------------------------------------------------------- offload manifest
def offload_manifest(cfg: ArchConfig, hp: adamw.OptimizerConfig):
    """Ledger of host-tier residency for the roofline's host-DMA term."""
    from repro_torch.core.offload import OffloadManifest

    man = OffloadManifest()
    if hp.offload_state:
        specs = opt_state_specs(cfg, hp)
        man.add_tree("adamw.m", specs["m"])
        man.add_tree("adamw.v", specs["v"])
        if "master" in specs:
            man.add_tree("adamw.master", specs["master"])
    return man
