"""A new architecture needs no edit to the harness: the stand-in of
``alternating.py`` (attention in the even layers only), named by its
configuration's ``"architecture"`` key, goes through every caller at the tiny
size: the lookup, the layout and the draw, the reference in its three
precisions, the step counts and both rooflines over its attention layers
alone, the registry check and the tiny cut, and both drivers' comparisons,
the prefill's K and V mapped onto the program's caches by its attention
layers."""

import dataclasses
import sys
import types

import pytest
import torch

from perfbench.checks import alternating
from perfbench.checks.check_metrics import _fake_prof
from perfbench.checks.tiny import tiny_arch, tiny_model
from perfbench.lib import files, flops, profile, weights
from perfbench.lib.cell import Cell, Record
from perfbench.reference.common import relative

MODEL = {"name": "alternating-stand-in", "registry": "alternating-stand-in",
         "architecture": "alternating", "hidden_size": 256, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 64, "num_hidden_layers": 6,
         "intermediate_size": 512, "vocab_size": 1000, "rope_theta": 10000.0,
         "rms_norm_eps": 1e-6, "torch_dtype": "bfloat16",
         "assumed": {"weights": {"std": 0.02}}}
S = 20
# the tiny cut's tree, stated here since the port has no such model
TINY_LEAVES = [
    ("embed", (256, 32)), ("attn.ln", (2, 32)), ("attn.wq", (2, 32, 4, 8)),
    ("attn.wk", (2, 32, 2, 8)), ("attn.wv", (2, 32, 2, 8)), ("attn.wo", (2, 4, 8, 32)),
    ("mlp.ln", (3, 32)), ("mlp.w_gate", (3, 32, 48)), ("mlp.w_up", (3, 32, 48)),
    ("mlp.w_down", (3, 48, 32)), ("final_norm", (32,)), ("unembed", (32, 256)),
]
LIMITS = {"logits_rel": 1e-6, "kv_rel": 1e-6, "top_gap": 1e-6, "max_gap": 1e-6}


@pytest.fixture(autouse=True)
def registered(monkeypatch):
    monkeypatch.setitem(sys.modules, "perfbench.reference.alternating", alternating)


def _tiny(seed=4):
    model = tiny_model(MODEL)
    w = weights.draw(model, seed, "cpu")
    toks = torch.randint(0, model["vocab_size"], (S,), generator=torch.Generator().manual_seed(seed))
    return model, w, toks


def test_the_lookup_takes_the_configurations_key():
    assert files.architecture(MODEL) is alternating
    decoder = files.architecture(files.load_json("configs", "olmoe-1b-7b"))
    assert decoder.__name__ == "perfbench.reference.model"
    for bad in ("../lib/files", "a.b", "", 3):
        with pytest.raises(ValueError):
            files.architecture({**MODEL, "architecture": bad})


def test_layout_and_draw():
    model, w, _ = _tiny()
    layout = files.architecture(model).layout(model)
    assert [(n, tuple(s)) for n, (s, _) in layout.items()] == TINY_LEAVES
    again, other = weights.draw(model, 4, "cpu"), weights.draw(model, 5, "cpu")
    for (name, x), (_, y), (_, z) in zip(weights.leaves(w), weights.leaves(again),
                                         weights.leaves(other), strict=True):
        assert (name, tuple(x.shape)) in TINY_LEAVES and torch.equal(x, y), name
        assert not x.any() if alternating.is_norm(name) else not torch.equal(x, z), name


def test_reference_in_three_precisions():
    model, w, toks = _tiny()
    arch = files.architecture(model)
    seen = []
    (a,) = arch.forward(w, model, [toks], mode="fp32",
                        on_kv=lambda layer, _j, k, v: seen.append((layer, tuple(k.shape))))
    (b,) = arch.forward(w, model, [toks], mode="fp64")
    (c,) = arch.forward(w, model, [toks], mode="fp8")
    assert a.dtype == torch.float32 and b.dtype == torch.float64
    assert relative(a, b) < 1e-5 and relative(c, a) > 1e-2
    assert seen == [(0, (S, 2, 8)), (2, (S, 2, 8))]


def test_counts_follow_the_architecture(monkeypatch):
    D, N, K, hd, F, V = 256, 4, 2, 64, 512, 1000
    params = 3 * (2 * D * N * hd + 2 * D * K * hd) + 6 * 3 * D * F
    pair = 3 * 4 * N * hd
    assert flops.matmul_params(MODEL) == params
    assert flops.attention_pair_flops(MODEL) == pair
    assert flops.attention_layer_count(MODEL) == 3
    assert flops.prefill_flops(MODEL, 10) == 2 * params * 10 + 2 * D * V + pair * 55
    assert flops.decode_flops(MODEL, [5, 7]) == 2 * 2 * (params + D * V) + pair * 12
    # a mixer beyond attention adds its count a token
    monkeypatch.setattr(alternating, "mixer_token_flops", lambda m: 1000, raising=False)
    assert flops.prefill_flops(MODEL, 10) == 2 * params * 10 + 10_000 + 2 * D * V + pair * 55
    assert flops.decode_flops(MODEL, [5, 7]) == 2 * 2 * (params + D * V) + 2000 + pair * 12


def test_rooflines_count_its_attention_layers_alone():
    prof = profile.summarize(_fake_prof([
        ("paged_partition_kernel<64, 1>", True, 0, 10),
        ("flash_attention_wgmma_kernel<64>", True, 20, 25),
    ]), 100e-6)
    serve = Record(window_s=1.0, profile=prof)
    serve.data = {"kind": "serve", "model": MODEL, "page": 16,
                  "slice": {"decodes": [(0.0, 0.0, [20, 3])]}}
    assert files.load_module("metrics", "paged_attn_roofline").read(serve) == pytest.approx(
        100 * 3 * flops.paged_seconds(MODEL, [20, 3], 16) / 10e-6)
    pre = Record(window_s=1.0, profile=prof)
    pre.data = {"kind": "prefill", "model": MODEL, "batch": 1, "slice_units": [(64, 0.0, 0.0)]}
    assert files.load_module("metrics", "flash_roofline").read(pre) == pytest.approx(
        100 * 3 * flops.flash_seconds(MODEL, 1, 64) / 5e-6)


@dataclasses.dataclass
class PortConfig:
    """What the port's registry entry for the stand-in would hold."""

    name: str = "alternating-stand-in"
    num_layers: int = 6
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1000
    attention_every: int = 2


def test_registry_check_and_tiny_cut(monkeypatch):
    import repro_torch.configs

    entry = [PortConfig()]
    monkeypatch.setattr(repro_torch.configs, "get_config", lambda name: entry[0])
    cell = Cell("stand-in", {}, MODEL, {}, 1, 1.0, False, torch.device("cpu"), 0.0)
    assert cell.port_config() is entry[0]
    entry[0] = PortConfig(attention_every=1)
    with pytest.raises(SystemExit):
        cell.port_config()
    entry[0] = PortConfig()
    assert tiny_arch(tiny_model(MODEL)) == PortConfig(
        num_layers=3, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=48,
        vocab_size=128)


def _stacked(kv: dict, layers) -> tuple:
    """K and V of `layers`, in that order, as the program's caches: (n, 1, S, K, hd)."""
    return (torch.stack([kv[i][0] for i in layers])[:, None],
            torch.stack([kv[i][1] for i in layers])[:, None])


def test_the_drivers_compare_through_it():
    model, w, toks = _tiny()
    arch = files.architecture(model)
    kv = {}
    (logits,) = arch.forward(w, model, [toks], mode="fp32",
                             on_kv=lambda layer, _j, k, v: kv.__setitem__(layer, (k, v)))
    cell = types.SimpleNamespace(model=model, workload={"limits": LIMITS},
                                 device=torch.device("cpu"))
    prefill = files.load_module("drivers", "prefill_stream")
    assert prefill.kv_slots(model) == {0: 0, 2: 1}
    sound = {0: (toks[None], logits[-1:], _stacked(kv, [0, 2]))}
    assert Record(checks=prefill.compare(cell, w, sound)).correct
    swapped = {0: (toks[None], logits[-1:], _stacked(kv, [2, 0]))}
    assert not Record(checks=prefill.compare(cell, w, swapped)).correct
    control = prefill.control(cell, Record(inputs={"params": w, "kept": sound}))
    assert {c.name for c in control} == set(prefill.CHECKS)
    assert not Record(checks=control).correct

    serve = files.load_module("drivers", "serve_closed")
    prompt, served = toks[:8].tolist(), []
    for _ in range(6):                                  # greedy, as the engine serves
        (row,) = arch.forward(w, model, [torch.tensor(prompt + served)], mode="fp32",
                              logits_at=[torch.tensor([len(prompt + served) - 1])])
        served.append(int(row[0].argmax()))
    assert Record(checks=serve.compare(cell, w, [(prompt, served)])).correct
    wrong = [(prompt, served[:3] + [(served[3] + 1) % model["vocab_size"]] + served[4:])]
    assert not Record(checks=serve.compare(cell, w, wrong)).correct
    control = serve.control(cell, Record(inputs={"params": w, "served": [(prompt, served)]}))
    assert [c.name for c in control] == ["max_gap"]
