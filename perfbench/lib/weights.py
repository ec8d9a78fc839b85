"""The weights both sides get: drawn from the seed on the device, in the tree
layout of the configuration's architecture (``files.architecture(model)``'s
``layout``), which is the tree the port reads.

The layout is a copy kept in the architecture's module
(``checks/check_weights.py`` holds it against the port's meta-device tree),
so the benchmark builds its inputs without the port's initializer: the
reference may take nothing the port made.

Every matrix is drawn ``N(0, std^2)`` with ``std`` the configuration's
assumed ``weights.std`` (the published ``initializer_range``), in the dtype
it is served in (the router in fp32, as the port keeps it), one call a leaf
with a generator on the device. Norm scales (the module's ``is_norm``) are
zero, the port's ``1 + scale`` parameterisation of a unit gain.
"""

from __future__ import annotations

import torch

from perfbench.lib import files


def draw(model: dict, seed: int, device) -> dict:
    """The nested weight tree for `model`, drawn from `seed` on `device`."""
    arch = files.architecture(model)
    std = float(model["assumed"]["weights"]["std"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for name, (shape, dtype) in arch.layout(model).items():
        leaf = torch.empty(shape, dtype=dtype, device=device)
        if arch.is_norm(name):
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
