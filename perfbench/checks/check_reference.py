"""The plain reference, each configuration through its own architecture
module: its fp32 path against its float64 path, and against the port's own
forward at a tiny size (the port in fp32 on the CPU), so that the reference
computes the architecture the port runs."""

import pytest
import torch

from perfbench.checks.tiny import tiny_arch, tiny_model
from perfbench.lib import files, weights
from perfbench.reference.common import gaps, relative

CONFIGS = [c["name"] for c in files.benchmark()["configs"]]
S = 24


def _setup(config, seed=3):
    model = tiny_model(files.load_json("configs", config))
    w = weights.draw(model, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, model["vocab_size"], (S,), generator=gen)
    return files.architecture(model), model, w, toks


@pytest.mark.parametrize("config", CONFIGS)
def test_fp32_against_float64(config):
    ref, model, w, toks = _setup(config)
    (a,) = ref.forward(w, model, [toks], mode="fp32")
    (b,) = ref.forward(w, model, [toks], mode="fp64")
    assert a.dtype == torch.float32 and b.dtype == torch.float64
    assert relative(a, b) < 1e-5


@pytest.mark.parametrize("config", CONFIGS)
def test_float64_against_the_ports_forward(config):
    from repro_torch.models import transformer as tf

    ref, model, w, toks = _setup(config)
    kv = {}
    (want,) = ref.forward(w, model, [toks], mode="fp64",
                          on_kv=lambda layer, _j, k, v: kv.__setitem__(layer, (k, v)))
    logits, _, caches = tf.forward(w, tiny_arch(model), toks[None], tf.ModelOptions(),
                                   collect_kv=True)
    assert relative(logits[0, :, :model["vocab_size"]], want) < 1e-5
    ks, vs = caches["kv"]
    slots = {layer: n for n, layer in enumerate(ref.attention_layers(model))}
    assert set(kv) == set(slots) and ks.shape[0] == len(slots)
    for layer, (k, v) in kv.items():
        assert relative(ks[slots[layer], 0], k) < 1e-5
        assert relative(vs[slots[layer], 0], v) < 1e-5


def test_logits_at_rows_and_gaps():
    ref, model, w, toks = _setup(CONFIGS[0])
    (full,) = ref.forward(w, model, [toks], mode="fp32")
    rows = torch.tensor([3, 7])
    (part,) = ref.forward(w, model, [toks], mode="fp32", logits_at=[rows])
    assert torch.allclose(part, full[rows], atol=1e-6)
    best = full.argmax(-1)
    assert float(gaps(full, best).abs().max()) == 0.0
    worst = full.argmin(-1)
    assert torch.allclose(gaps(full, worst), full.max(-1).values - full.min(-1).values)


@pytest.mark.parametrize("config", CONFIGS)
def test_fp8_control_departs(config):
    ref, model, w, toks = _setup(config)
    (a,) = ref.forward(w, model, [toks], mode="fp32")
    (c,) = ref.forward(w, model, [toks], mode="fp8")
    assert relative(c, a) > 1e-2
