"""Every published architecture through both packages, reduced, fp32, on the CPU.

The port's counterpart of tests/test_arch_smoke.py, held against the
reference instead of checked for shapes alone. For each of the ten
``ARCH_IDS`` the reference's ``init_params`` draws the parameters and
``repro_torch.interop.from_reference`` carries them across; then, with the
default ``ModelOptions`` on both sides:

| check | tolerance |
| --- | --- |
| ``forward`` logits | 1e-3 (tests/test_torch_forward.py) |
| the MoE balance loss (0 for the others) | 1e-5 |
| one ``make_train_step`` step: loss | 1e-5 |
| the same step's gradient norm | 1e-4 relative; zamba2 3x the reference's SSD spread (C.4) |
| one ``decode_step``'s logits | 1e-3; the encoder has none (tests/test_arch_smoke.py:62) |
| ``model_flops``, ``attention_flops``, ``mlp_flops`` | ``==`` |

Each arch and check is its own case. ``trunc_normal``'s layer-by-layer
draw of a leaf past 1 GiB of fp32, which lets the largest config that one
card holds be built there, is checked at the end.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_configs
import repro.models.attention as r_attn
import repro.models.layers as r_ll
import repro.models.transformer as r_tf
from repro.launch.steps import make_train_step as r_make_train_step
from repro.optim import adamw as r_adamw
from repro_torch.configs import get_config
from repro_torch.interop import from_reference
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_ll
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

ARCHS = list(r_configs.ARCH_IDS)
DECODE_ARCHS = [a for a in ARCHS if r_configs.get_config(a).causal]
ATOL = 1e-3
AUX_ATOL = 1e-5
LOSS_ATOL = 1e-5
GRAD_NORM_RTOL = 1e-4
HP = dict(learning_rate=1e-3, warmup_steps=1)
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg_r = r_configs.get_config(arch).reduced()
    params_r = r_tf.init_params(jax.random.PRNGKey(0), cfg_r)
    cfg_t = get_config(arch).reduced()
    params_t = from_reference(jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    return cfg_r, params_r, cfg_t, params_t


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    inputs = (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
              if cfg.input_mode == "tokens"
              else rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    return {"inputs": inputs,
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _forwards(arch):
    """(reference logits, aux), (port logits, aux) of one forward."""
    cfg_r, params_r, cfg_t, params_t = _models(arch)
    inputs = _batch(cfg_r, seed=1)["inputs"]
    logits_r, aux_r, _ = r_tf.forward(params_r, cfg_r, jnp.asarray(inputs))
    with torch.no_grad():
        logits_t, aux_t, _ = t_tf.forward(params_t, cfg_t, torch.from_numpy(inputs))
    return (np.asarray(logits_r), float(aux_r)), (logits_t.numpy(), float(aux_t))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    (logits_r, _), (logits_t, _) = _forwards(arch)
    cfg = _models(arch)[2]
    assert logits_t.shape == logits_r.shape == (B, S, cfg.padded_vocab)
    assert np.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t, logits_r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_balance_loss_matches_reference(arch):
    (_, aux_r), (_, aux_t) = _forwards(arch)
    assert abs(aux_t - aux_r) <= AUX_ATOL
    if _models(arch)[2].moe:
        assert aux_t > 0


def _ref_step(cfg_r, params_r, batch, opts):
    hp = r_adamw.OptimizerConfig(**HP)
    step = jax.jit(r_make_train_step(cfg_r, opts, hp))
    _, _, metrics = step(params_r, r_adamw.init_state(params_r, hp),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    return float(metrics["loss"]), float(metrics["grad_norm"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step from the same parameters and batch: the loss and the gradient
    norm (the port updates in place, so it steps a copy)."""
    cfg_r, params_r, cfg_t, params_t = _models(arch)
    batch = _batch(cfg_r, seed=2)
    loss_r, gnorm_r = _ref_step(cfg_r, params_r, batch, r_tf.ModelOptions())
    hp = adamw.OptimizerConfig(**HP)
    params = tree_map(lambda t: t.clone(), params_t)
    new_params, opt, metrics = make_train_step(cfg_t, t_tf.ModelOptions(), hp)(
        params, adamw.init_state(params, hp), {k: torch.from_numpy(v) for k, v in batch.items()})
    loss_t, gnorm_t = float(metrics["loss"]), float(metrics["grad_norm"])
    assert np.isfinite(loss_t) and int(opt["step"]) == 1
    assert abs(loss_t - loss_r) <= LOSS_ATOL
    bound = GRAD_NORM_RTOL
    if arch == "zamba2-1.2b":
        _, gnorm_seq = _ref_step(cfg_r, params_r, batch, r_tf.ModelOptions(ssd_impl="ref"))
        bound = max(bound, 3 * abs(gnorm_seq - gnorm_r) / gnorm_r)
    assert abs(gnorm_t - gnorm_r) <= bound * gnorm_r
    moved = max(float((a - b).abs().max()) for a, b in zip(
        jax.tree.leaves(params_t), jax.tree.leaves(new_params), strict=True))
    assert moved > 0


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_reference(arch):
    """One decode step from an empty cache of 32; hubert-xlarge, the encoder,
    has no decode step (the reference's documented skip) and no case here."""
    cfg_r, params_r, cfg_t, params_t = _models(arch)
    rng = np.random.default_rng(3)
    tok = (np.array([[1], [2]], np.int32) if cfg_r.input_mode == "tokens"
           else rng.standard_normal((2, 1, cfg_r.d_model)).astype(np.float32))
    state_r = r_tf.init_decode_state(params_r, cfg_r, 2, 32)
    logits_r, new_r = r_tf.decode_step(params_r, cfg_r, state_r, jnp.asarray(tok))
    state_t = t_tf.init_decode_state(params_t, cfg_t, 2, 32)
    with torch.no_grad():
        logits_t, new_t = t_tf.decode_step(params_t, cfg_t, state_t, torch.from_numpy(tok))
    assert tuple(logits_t.shape) == (2, cfg_t.padded_vocab)
    assert int(new_t["lengths"][0]) == int(new_r["lengths"][0]) == 1
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_r), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_the_reference(arch):
    """The FLOP accounting at the published and the reduced widths, both
    modes, every attention window the arch has and none."""
    for cfg_r, cfg_t in ((r_configs.get_config(arch), get_config(arch)),
                         (r_configs.get_config(arch).reduced(), get_config(arch).reduced())):
        for tokens in (1, 4096, 2 * 32768):
            for mode in ("train", "inference"):
                assert t_tf.model_flops(cfg_t, tokens, mode) == \
                    r_tf.model_flops(cfg_r, tokens, mode)
            widths = [cfg_r.d_ff] + ([cfg_r.moe_d_ff] if cfg_r.moe else [])
            for F in widths:
                assert t_ll.mlp_flops(cfg_t.d_model, F, cfg_t.mlp_activation, tokens) == \
                    r_ll.mlp_flops(cfg_r.d_model, F, cfg_r.mlp_activation, tokens)
        dims = (cfg_r.d_model, cfg_r.num_heads, cfg_r.num_kv_heads, cfg_r.resolved_head_dim)
        for seq in (1, 2048, 32768):
            for window in (0, cfg_r.sliding_window or 0, 1024, seq):
                for causal in (cfg_r.causal, not cfg_r.causal):
                    assert t_attn.attention_flops(seq, 2, *dims, causal, window) == \
                        r_attn.attention_flops(seq, 2, *dims, causal, window)
    assert t_tf.model_flops(get_config(arch), 1) == 6.0 * get_config(arch).active_param_count()


# ------------------------------------------------------------------ trunc_normal by layers
# The std of a unit normal truncated to [-2, 2]: the sample std the draw has,
# times the stated scale / sqrt(fan_in).
_PHI2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
TRUNC_STD = math.sqrt(1 - 4 * _PHI2 / math.erf(2 / math.sqrt(2)))


@pytest.fixture
def by_layers(monkeypatch):
    """Every stacked leaf drawn a layer slice at a time, as the ones past
    WHOLE_DRAW_LIMIT (1 GiB of fp32) are."""
    monkeypatch.setattr(t_ll, "WHOLE_DRAW_LIMIT", 0)


def _draw(seed, shape, scale, dtype=torch.float32):
    return t_ll.trunc_normal(torch.Generator().manual_seed(seed), shape, scale, dtype, "cpu")


def test_trunc_normal_by_layers_is_deterministic_per_seed(by_layers):
    shape = (3, 64, 32)
    a, b, c = _draw(0, shape, 1.0), _draw(0, shape, 1.0), _draw(1, shape, 1.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # each layer slice is a draw of its own, a bf16 stack the fp32 draw rounded once
    assert not torch.equal(a[0], a[1])
    assert torch.equal(_draw(0, shape, 1.0, torch.bfloat16), a.to(torch.bfloat16))
    gen = torch.Generator().manual_seed(0)
    first = torch.empty(shape[1:])
    torch.nn.init.trunc_normal_(first, 0.0, 1.0, -2.0, 2.0, generator=gen)
    assert torch.equal(a[0], first * (1.0 / math.sqrt(shape[-2])))


def test_trunc_normal_under_the_limit_is_one_whole_draw():
    """Below WHOLE_DRAW_LIMIT a leaf is one fp32 draw, scaled, rounded once:
    the values the port drew before the limit existed."""
    for shape in ((3, 64, 32), (100, 20)):
        gen = torch.Generator().manual_seed(0)
        whole = torch.empty(shape)
        torch.nn.init.trunc_normal_(whole, 0.0, 1.0, -2.0, 2.0, generator=gen)
        whole.mul_(0.5 / math.sqrt(shape[-2]))
        assert torch.equal(_draw(0, shape, 0.5, torch.bfloat16), whole.to(torch.bfloat16))
    big = (62, 7168, 19200)
    assert math.prod(big) > t_ll.WHOLE_DRAW_LIMIT >= math.prod(big[1:])


@pytest.mark.parametrize("shape,scale", [((4, 128, 256), 1.0), ((3, 16, 256, 64), 0.1),
                                         ((512, 96), 2.0)],
                         ids=["stack", "expert-stack", "matrix"])
def test_trunc_normal_std_and_bounds_per_slice(by_layers, shape, scale):
    """Every layer slice: sample std within 2% of TRUNC_STD * scale /
    sqrt(fan_in) (fan_in = shape[-2], as the reference), mean near 0, every
    value within +-2 std."""
    t = _draw(3, shape, scale)
    std = scale / math.sqrt(shape[-2])
    for part in (t.unbind(0) if t.dim() >= 3 else (t,)):
        x = part.double()
        assert abs(x.std().item() / (TRUNC_STD * std) - 1) < 0.02
        assert abs(x.mean().item()) < 0.02 * std
        assert x.abs().max().item() <= 2 * std * (1 + 1e-6)


def test_trunc_normal_meta_and_empty_draw_nothing():
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    meta = t_ll.trunc_normal(gen, (62, 7168, 19200), 1.0, torch.bfloat16, "meta")
    assert meta.is_meta and tuple(meta.shape) == (62, 7168, 19200)
    assert tuple(t_ll.trunc_normal(gen, (0, 8, 4), 1.0, device="cpu").shape) == (0, 8, 4)
    assert torch.equal(gen.get_state(), state)
