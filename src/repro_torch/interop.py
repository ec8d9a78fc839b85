"""Carry a reference parameter tree, or optimizer state, into the port.

The port cannot reproduce ``jax.random`` streams, so parity tests build the
parameters with the reference's ``init_params``, convert the tree to numpy
themselves (the port never sees JAX), and hand it to ``from_reference``.
Both packages keep the layer-stacked ``(L, ...)`` layout, so the mapping is
one-to-one, key for key, and every leaf keeps its dtype: the fp32 leaves of a
bf16 tree (Mamba2's ``A_log``, ``D``, ``dt_bias``; RWKV6's ``w0``, ``wA``,
``wB``, ``u``) stay fp32, and so does the MoE router.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.offload import HOST, to_tier
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.tree import tree_map


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")          # a C-ordered copy; keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch.from_numpy mapping: carry the bits.
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)


def _expected_shapes(params_np, cfg: ArchConfig):
    """(path, shape found, shape `cfg` needs) for the leaves that fix the widths."""
    attn_w = (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)
    if cfg.family == "ssm":
        L, D, hd = cfg.num_layers, cfg.d_model, cfg.rwkv_head_dim
        blocks = params_np["blocks"]
        return [("blocks/wr", blocks["wr"].shape, (L, D, D)),
                ("blocks/u", blocks["u"].shape, (L, D // hd, hd))]
    if cfg.family == "hybrid":
        d_in, _, H, N = m2._dims(cfg)
        return [("shared_attn/attn/wq", params_np["shared_attn"]["attn"]["wq"].shape,
                 (1, *attn_w)),
                ("blocks/in_proj", params_np["blocks"]["in_proj"].shape,
                 (cfg.num_layers, cfg.d_model, 2 * d_in + 2 * N + H))]
    L1 = cfg.moe_first_dense if cfg.moe else 0
    stack = params_np["stack"]
    found = [("stack/attn/wq", stack["attn"]["wq"].shape, (cfg.num_layers - L1, *attn_w))]
    if L1:
        found.append(("dense_stack/attn/wq", params_np["dense_stack"]["attn"]["wq"].shape,
                      (L1, *attn_w)))
        found.append(("dense_stack/mlp/w_down", params_np["dense_stack"]["mlp"]["w_down"].shape,
                      (L1, cfg.d_ff, cfg.d_model)))
    if cfg.moe:
        E, D, Fm = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        moe = stack["moe"]
        found.append(("stack/moe/router", moe["router"].shape, (cfg.num_layers - L1, D, E)))
        found.append(("stack/moe/w_gate", moe["w_gate"].shape, (cfg.num_layers - L1, E, D, Fm)))
        if cfg.num_shared_experts:
            found.append(("stack/moe/s_down", moe["s_down"].shape,
                          (cfg.num_layers - L1, Fm * cfg.num_shared_experts, D)))
    return found


def from_reference(params_np: Dict[str, Any], cfg: ArchConfig, device="cuda") -> Dict[str, Any]:
    """Port's parameters from the reference's tree of numpy arrays."""
    dev = resolve_device(device)
    for path, found, want in _expected_shapes(params_np, cfg):
        if tuple(found) != want:
            raise ValueError(f"{path} has shape {tuple(found)}; {cfg.name} needs {want}")
    return _convert(params_np, dev)


def opt_state_from_reference(tree: Dict[str, Any], device="cuda",
                             pinned: bool = False) -> Dict[str, Any]:
    """Port's AdamW state from the reference's ``init_state``/``apply_update``
    tree of numpy arrays, so both packages can start a step from one state.
    ``m``, ``v`` and ``master`` go to pinned host memory when `pinned` (the
    state of ``OptimizerConfig(offload_state=True)``), else to `device`;
    ``step`` goes to `device`."""
    dev = resolve_device(device)

    def place(a):
        t = _tensor(np.asarray(a), dev)
        return to_tier(t, HOST, dev) if pinned else t

    out = {k: tree_map(place, tree[k]) for k in ("m", "v", "master") if k in tree}
    out["step"] = _tensor(np.asarray(tree["step"]), dev)
    return out
