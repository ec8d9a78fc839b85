"""Serving parity: layer functions, paged decode, the paged KV pool and the
preemption scenario, the port (on the CPU) against the reference.

Tolerances: layer functions agree to 1e-5 in fp32; decode logits to 1e-3 over
12 steps, as tests/test_serving.py:41 holds paged against dense decode.
Generated token ids, tier statistics and modeled times must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as tp  # noqa: E402
import repro.models.layers as r_layers  # noqa: E402
import repro.models.transformer as r_tf  # noqa: E402
import repro.serving.paged_decode as r_pd  # noqa: E402
import repro_torch.models.layers as t_layers  # noqa: E402
import repro_torch.models.transformer as t_tf  # noqa: E402
import repro_torch.serving.paged_decode as t_pd  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return tp.models()


@pytest.fixture(scope="module")
def preemption(model):
    cfg_r, params_r, cfg_t, params_t = model
    return (tp.preemption_run(tp.REF, params_r, cfg_r),
            tp.preemption_run(tp.PORT, params_t, cfg_t))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ layers
def test_rms_norm_matches():
    x, s = _np((3, 5, 64), 0), _np((64,), 1, 0.1)
    ref = r_layers.rms_norm(jnp.asarray(x), jnp.asarray(s))
    out = t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_apply_rope_matches():
    x = _np((2, 3, 4, 32), 2)
    pos = np.array([[0, 7, 300], [5, 6, 100000]], np.int32)
    ref = r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    out = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_gelu_glu_mlp_matches():
    p = {k: _np(s, i, 0.1) for i, (k, s) in
         enumerate([("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64))])}
    x = _np((2, 1, 64), 9)
    ref = r_layers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "gelu_glu")
    out = t_layers.mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                       "gelu_glu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bf16_embedding_scale_rounds_like_the_reference(model):
    """sqrt(1152) = 33.94 rounds to 34.0 in bf16 before the multiply."""
    cfg_r = dataclasses.replace(model[0], d_model=1152, dtype="bfloat16",
                                param_dtype="bfloat16")
    cfg_t = dataclasses.replace(model[2], d_model=1152, dtype="bfloat16",
                                param_dtype="bfloat16")
    params_r = r_tf.init_params(jax.random.PRNGKey(1), cfg_r)
    params_t = from_reference(jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    toks = np.array([[3], [400]], np.int32)
    ref = r_tf.embed_inputs(params_r, cfg_r, jnp.asarray(toks))
    out = t_tf.embed_inputs(params_t, cfg_t, torch.from_numpy(toks))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    ref_logits = r_tf.unembed(params_r, cfg_r, ref)
    out_logits = t_tf.unembed(params_t, cfg_t, out)
    np.testing.assert_allclose(out_logits.numpy(), np.asarray(ref_logits), atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------------ paged decode
def test_paged_decode_matches_reference(model):
    cfg_r, params_r, cfg_t, params_t = model
    B, page, maxp = 2, 8, 4
    shape = (cfg_r.num_layers, 16, page, cfg_r.num_kv_heads, cfg_r.resolved_head_dim)
    k_r = v_r = jnp.zeros(shape, jnp.float32)
    k_t, v_t = torch.zeros(shape), torch.zeros(shape)
    table = np.stack([np.arange(maxp), np.arange(maxp) + maxp]).astype(np.int32)
    toks = np.random.default_rng(0).integers(0, cfg_r.vocab_size, (B, 12)).astype(np.int32)
    for t in range(12):
        tok = toks[:, t : t + 1]
        lengths = np.full((B,), t, np.int32)
        ref, k_r, v_r = r_pd.paged_decode_step(params_r, cfg_r, k_r, v_r, jnp.asarray(table),
                                               jnp.asarray(lengths), jnp.asarray(tok))
        out, k_t, v_t = t_pd.paged_decode_step(params_t, cfg_t, k_t, v_t,
                                               torch.from_numpy(table),
                                               torch.from_numpy(lengths), torch.from_numpy(tok))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_r), atol=1e-4)


# ------------------------------------------------------------------ paged KV pool
def _pool_program(P, scenario):
    lib = P.ecxl.EmuCXL()
    lib.init(local_capacity=1 << 24, remote_capacity=1 << 26, **P.lib_kw)
    obs = []
    if scenario == "roundtrip":
        pool = P.kv.PagedKVPool(2, 4, 8, 2, 16, lib=lib, **P.dev_kw)
        pool.alloc_page(0, 0)
        payload = np.random.default_rng(0).standard_normal((2, 8, 2, 16)).astype(np.float32)
        pool.write_token(0, (P.asarray(payload[:, 3]), P.asarray(payload[:, 3] * 2)), 3)
        pool.demote(0, 0)
        obs += [pool.residency(0), lib.stats(1)]
        pool.promote(0, 0)
        slot = int(pool.hot_table(0, 1)[0])
        obs += [pool.residency(0), np.asarray(pool.k_pool[:, slot, 3]),
                np.asarray(pool.v_pool[:, slot, 3])]
    elif scenario == "policy2":
        pool = P.kv.PagedKVPool(1, 4, 8, 2, 16, lib=lib, policy=P.policy.Policy2(),
                                **P.dev_kw)
        pool.alloc_page(0, 0)
        pool.demote(0, 0)
        obs += [pool.touch(0, 0) for _ in range(3)]
        obs += [pool.stats.remote_hits, pool.residency(0)]
    else:  # eviction under promote pressure: 2 hot slots
        pool = P.kv.PagedKVPool(1, 2, 8, 2, 16, lib=lib, **P.dev_kw)
        pool.alloc_page(0, 0)
        pool.alloc_page(1, 0)
        pool.demote(0, 0)
        pool.alloc_page(2, 0)
        pool.promote(0, 0)
        obs += [pool.residency(s) for s in (0, 1, 2)]
    obs += [pool.stats.local_hits, pool.stats.remote_hits, lib.stats(0), lib.stats(1),
            dict(lib.modeled_time)]
    lib.exit()
    return obs


@pytest.mark.parametrize("scenario", ["roundtrip", "policy2", "eviction"])
def test_paged_kv_pool_matches(scenario):
    ref, out = _pool_program(tp.REF, scenario), _pool_program(tp.PORT, scenario)
    assert len(ref) == len(out)
    for r, o in zip(ref, out, strict=True):
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(o, r)
        else:
            assert o == r


# ------------------------------------------------------------------ engine
def test_engine_preemption_tokens_equal(preemption):
    ref, out = preemption
    assert all(len(v) == 6 for v in out["tokens"].values())
    assert out["tokens"] == ref["tokens"]


def test_engine_preemption_tier_stats_equal(preemption):
    ref, out = preemption
    assert out["tier_stats"]["preemptions"] > 0
    assert out["tier_stats"] == ref["tier_stats"]
    assert out["modeled_time"] == ref["modeled_time"]
