"""The weights both sides get: drawn from the seed on the device, in the tree
layout that ``repro_torch.models.transformer`` reads.

The layout is a copy kept here (``checks/check_weights.py`` holds it against
the port's meta-device tree), so the benchmark builds its inputs without the
port's initializer: the reference may take nothing the port made.

Every matrix is drawn ``N(0, std^2)`` with ``std`` the configuration's
assumed ``weights.std`` (the published ``initializer_range``), in the dtype
it is served in (the router in fp32, as the port keeps it), one call a leaf
with a generator on the device. Norm scales are zero, the port's ``1 +
scale`` parameterisation of a unit gain.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def dims(model: dict) -> dict:
    """The sizes the layout and the counts need, from a configuration file."""
    D, N = model["hidden_size"], model["num_attention_heads"]
    V = model["vocab_size"]
    return {
        "L": model["num_hidden_layers"], "D": D, "N": N,
        "K": model["num_key_value_heads"], "hd": model.get("head_dim", D // N),
        "F": model["intermediate_size"], "V": V, "Vp": -(-V // 256) * 256,
        "E": model.get("num_experts", 0), "k": model.get("num_experts_per_tok", 0),
        "qk_norm": bool(model.get("qk_norm", False)),
    }


def layout(model: dict) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Dotted leaf name -> (shape, dtype), in draw order."""
    d = dims(model)
    L, D, N, K, hd, F, E = d["L"], d["D"], d["N"], d["K"], d["hd"], d["F"], d["E"]
    dt = DTYPES[model["torch_dtype"]]
    out = {
        "embed": ((d["Vp"], D), dt),
        "stack.ln1": ((L, D), dt),
        "stack.ln2": ((L, D), dt),
        "stack.attn.wq": ((L, D, N, hd), dt),
        "stack.attn.wk": ((L, D, K, hd), dt),
        "stack.attn.wv": ((L, D, K, hd), dt),
        "stack.attn.wo": ((L, N, hd, D), dt),
    }
    if d["qk_norm"]:
        out["stack.attn.q_norm"] = ((L, hd), dt)
        out["stack.attn.k_norm"] = ((L, hd), dt)
    if E:
        out["stack.moe.router"] = ((L, D, E), torch.float32)
        out["stack.moe.w_gate"] = ((L, E, D, F), dt)
        out["stack.moe.w_up"] = ((L, E, D, F), dt)
        out["stack.moe.w_down"] = ((L, E, F, D), dt)
    else:
        out["stack.mlp.w_gate"] = ((L, D, F), dt)
        out["stack.mlp.w_up"] = ((L, D, F), dt)
        out["stack.mlp.w_down"] = ((L, F, D), dt)
    out["final_norm"] = ((D,), dt)
    out["unembed"] = ((D, d["Vp"]), dt)
    return out


def is_norm(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


def draw(model: dict, seed: int, device) -> dict:
    """The nested weight tree for `model`, drawn from `seed` on `device`."""
    std = float(model["assumed"]["weights"]["std"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for name, (shape, dtype) in layout(model).items():
        leaf = torch.empty(shape, dtype=dtype, device=device)
        if is_norm(name):
            leaf.zero_()
        else:
            leaf.normal_(0.0, std, generator=gen)
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def leaves(tree: dict, prefix: str = ""):
    """(dotted name, tensor) for every leaf of a nested tree."""
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from leaves(value, name + ".")
        else:
            yield name, value
