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

On a mesh the parameters, gradients and state are DTensors, the state placed
by ``launch/specs.py::opt_state_shardings`` and, with ``offload_state``,
each rank's shards in pinned host memory. The update runs shard-locally on
the state's placements: under ``train_zero1`` the state is sharded over all
axes while the parameters are replicated, so each rank updates its slice of
the master and the new parameters are all-gathered from the slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

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
    in the tier ``hp.offload_state`` names, on the parameters' device. DTensor
    parameters give DTensor state on their placements, on the device; the
    launcher places it by ``opt_state_shardings``, host tier included."""
    p0 = leaves(params)[0]
    if isinstance(p0, DTensor):
        return {
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
            "step": DTensor.from_local(
                torch.zeros((), dtype=torch.int32, device=p0.to_local().device),
                p0.device_mesh, [Replicate()] * p0.device_mesh.ndim, run_check=False),
            **({"master": tree_map(lambda p: p.to(torch.float32, copy=True), params)}
               if hp.use_master_fp32 else {}),
        }
    dev = p0.device
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
    # a DTensor leaf's sum is reduced over its shards first (one all-reduce
    # a leaf), so the stack sums plain scalars
    sq = [s.full_tensor() if isinstance(s, DTensor) else s for s in sq]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _fetch(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=True) if t.device != dev else t


def _plain(x):
    """A replicated DTensor scalar as a plain tensor; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _shard_local(p, g, m_s, v_s, w_s):
    """The update's operands as local tensors on the state's placements. A
    parameter (and its gradient) placed otherwise, as replicated ones under
    ``train_zero1``, contributes its slice; the returned `finish` writes the
    updated fp32 slice back into the parameter, all-gathering it there."""
    if not isinstance(p, DTensor):
        return p, g, m_s, v_s, w_s, lambda p32: p.copy_(p32)
    mesh, target = m_s.device_mesh, m_s.placements
    same = tuple(target) == tuple(p.placements)
    g_l = (g if same else g.redistribute(mesh, target)).to_local()
    p_l = p.to_local() if same else p.redistribute(mesh, target).to_local()

    def finish(p32):
        if same:
            p_l.copy_(p32)
            return
        piece = DTensor.from_local(p32.to(p.dtype), mesh, target, run_check=False,
                                   shape=p.shape, stride=p.stride())
        p.to_local().copy_(piece.redistribute(mesh, p.placements).to_local())

    local = (lambda s: s.to_local() if s is not None else None)
    return p_l, g_l, local(m_s), local(v_s), local(w_s), finish


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
        step = _plain(state["step"]) + 1
        lr = schedule(step, hp)
        b1, b2 = hp.b1, hp.b2
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())
        masters = leaves(state["master"]) if hp.use_master_fp32 else [None] * len(leaves(params))
        for p, g, m_s, v_s, w_s in zip(leaves(params), leaves(grads), leaves(state["m"]),
                                       leaves(state["v"]), masters, strict=True):
            p, g, m_s, v_s, w_s, finish = _shard_local(p, g, m_s, v_s, w_s)
            dev = p.device
            m, v = _fetch(m_s, dev), _fetch(v_s, dev)
            g32 = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * torch.square(g32))
            p32 = _fetch(w_s, dev) if w_s is not None else p.float()
            u = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps) + hp.weight_decay * p32
            p32.sub_(lr * u)
            finish(p32)
            for dst, src in ((m_s, m), (v_s, v), (w_s, p32)):
                if dst is not None and dst is not src:
                    dst.copy_(src, non_blocking=True)
    if isinstance(state["step"], DTensor):
        step = DTensor.from_local(step, state["step"].device_mesh,
                                  state["step"].placements, run_check=False)
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
