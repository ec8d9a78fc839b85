"""Carry a reference parameter tree into the port.

The port cannot reproduce ``jax.random`` streams, so parity tests build the
parameters with the reference's ``init_params``, convert the tree to numpy
themselves (the port never sees JAX), and hand it to ``from_reference``.
Both packages keep the layer-stacked ``(L, ...)`` layout, so the mapping is
one-to-one, key for key.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch.from_numpy mapping: carry the bits.
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)


def from_reference(params_np: Dict[str, Any], cfg: ArchConfig, device="cuda") -> Dict[str, Any]:
    """Port's parameters from the reference's tree of numpy arrays."""
    dev = resolve_device(device)
    tf.require_dense(cfg)
    wq = params_np["stack"]["attn"]["wq"]
    want = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.resolved_head_dim)
    if tuple(wq.shape) != want:
        raise ValueError(f"stack/attn/wq has shape {tuple(wq.shape)}; {cfg.name} needs {want}")
    return _convert(params_np, dev)
