"""AdamW with bf16 params + fp32 master copy and offloadable state.

The port of ``repro/optim/adamw.py``. The optimizer state (moments + master
params) is the single largest persistent training tensor set (12 bytes/param
vs 2 for bf16 weights). With ``offload_state`` it lives in the emulated-CXL
host tier, the paper's technique: on a card ``m``, ``v`` and ``master`` are
pinned host tensors (the one-device form of the reference's
``memory_kind="pinned_host"`` state shardings), and each step fetches a
leaf's state to the device, updates it there and writes it back into the
same pinned buffers with ``non_blocking`` copies on the current stream.

The step counter, ``lr`` and the bias corrections are fp32 tensors on the
device, as the reference computes them, never Python floats. The update is
in place (ROADMAP C.6): ``apply_update`` returns the caller's parameter and
state tensors, updated; only ``step`` is a new tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.offload import DEVICE, HOST, to_tier
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    use_master_fp32: bool = True
    offload_state: bool = False     # remote-tier residency for m/v/master


def schedule(step: torch.Tensor, hp: OptimizerConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio."""
    step = step.float()
    warm = step / max(hp.warmup_steps, 1)
    prog = torch.clamp(
        (step - hp.warmup_steps) / max(hp.decay_steps - hp.warmup_steps, 1), 0.0, 1.0,
    )
    cos = hp.min_lr_ratio + (1 - hp.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return hp.learning_rate * torch.where(step < hp.warmup_steps, warm, cos)


def _state_tier(hp: OptimizerConfig) -> str:
    return HOST if hp.offload_state else DEVICE


def init_state(params: Any, hp: OptimizerConfig) -> Dict[str, Any]:
    """Zero moments, a zero step and (with ``use_master_fp32``) fp32 masters,
    in the tier ``hp.offload_state`` names, on the parameters' device."""
    dev = leaves(params)[0].device
    tier = _state_tier(hp)

    def zeros32(p):
        return to_tier(torch.zeros(p.shape, dtype=torch.float32, device=dev), tier, dev)

    state: Dict[str, Any] = {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if hp.use_master_fp32:
        # a copy even of an fp32 parameter: the master is updated in place
        state["master"] = tree_map(
            lambda p: to_tier(p.to(torch.float32, copy=True), tier, dev), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _fetch(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=True) if t.device != dev else t


def apply_update(
    params: Any,
    grads: Any,
    state: Dict[str, Any],
    hp: OptimizerConfig,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (params, state, metrics).

    Clipping is FUSED into the moment update (g * scale inline) rather than
    materializing a scaled fp32 copy of the gradient tree. One leaf at a
    time: the state of a leaf held in the host tier crosses to the device
    and back once."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(hp.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        step = state["step"] + 1
        lr = schedule(step, hp)
        b1, b2 = hp.b1, hp.b2
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())
        masters = leaves(state["master"]) if hp.use_master_fp32 else [None] * len(leaves(params))
        for p, g, m_s, v_s, w_s in zip(leaves(params), leaves(grads), leaves(state["m"]),
                                       leaves(state["v"]), masters, strict=True):
            dev = p.device
            m, v = _fetch(m_s, dev), _fetch(v_s, dev)
            g32 = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            p32 = _fetch(w_s, dev) if w_s is not None else p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps) + hp.weight_decay * p32
            p32.sub_(lr * u)
            p.copy_(p32)
            for dst, src in ((m_s, m), (v_s, v), (w_s, p32)):
                if dst is not None and dst is not src:
                    dst.copy_(src, non_blocking=True)
    new_state = dict(state, step=step)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def state_axes(param_axes_tree: Any, hp: OptimizerConfig) -> Dict[str, Any]:
    """Logical axes for the optimizer state (mirrors params; step is replicated)."""
    state_ax: Dict[str, Any] = {
        "m": param_axes_tree,
        "v": param_axes_tree,
        "step": (),
    }
    if hp.use_master_fp32:
        state_ax["master"] = param_axes_tree
    return state_ax
