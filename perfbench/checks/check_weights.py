"""The benchmark's weight layout (each configuration's architecture module)
is the port's tree, leaf for leaf, and its draw repeats per seed."""

import pytest
import torch

from perfbench.checks.tiny import tiny_model
from perfbench.lib import files, weights

CONFIGS = [c["name"] for c in files.benchmark()["configs"]]


def _port_tree(model):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    return tf.init_params(None, get_config(model["registry"]), device="meta")


@pytest.mark.parametrize("config", CONFIGS)
def test_layout_is_the_ports_meta_tree(config):
    model = files.load_json("configs", config)
    port = {name: (tuple(t.shape), t.dtype) for name, t in weights.leaves(_port_tree(model))}
    ours = {name: (tuple(shape), dtype)
            for name, (shape, dtype) in files.architecture(model).layout(model).items()}
    assert ours == port


@pytest.mark.parametrize("config", CONFIGS)
def test_draw_repeats_per_seed(config):
    model = tiny_model(files.load_json("configs", config))
    arch = files.architecture(model)
    a, b = weights.draw(model, 2**31 + 5, "cpu"), weights.draw(model, 2**31 + 5, "cpu")
    c = weights.draw(model, 2**31 + 6, "cpu")
    for (name, x), (_, y), (_, z) in zip(weights.leaves(a), weights.leaves(b), weights.leaves(c),
                                         strict=True):
        assert torch.equal(x, y), name
        if arch.is_norm(name):
            assert not x.any(), name
        else:
            assert not torch.equal(x, z), name
            std = model["assumed"]["weights"]["std"]
            assert abs(float(x.double().std()) - std) < 0.15 * std, name
