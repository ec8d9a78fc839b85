"""MoE: the port's ``models/moe.py`` (on the CPU) against the reference's, on
the reduced olmoe-1b-7b (8 experts, top-2, no renormalisation) and kimi-k2
(renormalised top-2, one shared expert) configs.

The same numpy-seeded activations and the reference's own parameters (one
layer of ``init_params``' MoE stack, carried across as numpy) go through both.
Tolerances: fp32 outputs 1e-5 and the aux loss 1e-6 (fp32 summation order);
which assignments survive the capacity cut, and which experts a tied router
picks, match exactly. bf16 at the reference's own ep-vs-dense tolerance, 5e-2
(tests/test_perf_variants.py:81).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs  # noqa: E402
import repro.models.moe as r_moe  # noqa: E402
import repro.models.transformer as r_tf  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
import repro_torch.models.moe as t_moe  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

ATOL, AUX_ATOL, BF16_ATOL = 1e-5, 1e-6, 5e-2
ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


def _configs(arch, **changes):
    cfg_r = dataclasses.replace(r_configs.get_config(arch).reduced(), **changes)
    cfg_t = dataclasses.replace(t_configs.get_config(arch).reduced(), **changes)
    return cfg_r, cfg_t


def _layer(arch, **changes):
    """(reference cfg, reference layer params, port cfg, port layer params)."""
    cfg_r, cfg_t = _configs(arch, **changes)
    params = r_tf.init_params(jax.random.PRNGKey(0), cfg_r)
    p_r = jax.tree.map(lambda a: a[0], params["stack"]["moe"])
    p_np = jax.tree.map(np.asarray, params)
    p_t = from_reference(p_np, cfg_t, device="cpu")["stack"]["moe"]
    return cfg_r, p_r, cfg_t, {k: v[0] for k, v in p_t.items()}


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    return request.param, _layer(request.param)


def _x(cfg, B, S, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(dtype)


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)


def test_route_matches(layer):
    _, (cfg_r, p_r, cfg_t, p_t) = layer
    x = _x(cfg_t, 1, 64, seed=1).reshape(64, -1)
    w_r, e_r, probs_r = r_moe._route(p_r["router"], jnp.asarray(x), cfg_r)
    w_t, e_t, probs_t = t_moe._route(p_t["router"], torch.from_numpy(x), cfg_t)
    assert np.array_equal(e_t.numpy(), np.asarray(e_r))
    _close(w_t, w_r, ATOL)
    _close(probs_t, probs_r, ATOL)


def test_tied_router_picks_the_reference_experts(layer):
    """Zero router weights tie every expert: jax.lax.top_k takes the lowest
    indices first, and so must the port's stable sort."""
    _, (cfg_r, p_r, cfg_t, p_t) = layer
    x = _x(cfg_t, 1, 16, seed=2).reshape(16, -1)
    zero = np.zeros(tuple(p_t["router"].shape), np.float32)
    w_r, e_r, _ = r_moe._route(jnp.asarray(zero), jnp.asarray(x), cfg_r)
    w_t, e_t, _ = t_moe._route(torch.from_numpy(zero), torch.from_numpy(x), cfg_t)
    assert np.array_equal(e_t.numpy(), np.asarray(e_r))
    assert np.array_equal(e_t.numpy(), np.tile(np.arange(cfg_t.experts_per_token), (16, 1)))
    _close(w_t, w_r, ATOL)


def test_aux_loss_matches(layer):
    _, (cfg_r, p_r, cfg_t, p_t) = layer
    x = _x(cfg_t, 1, 64, seed=3).reshape(64, -1)
    _, e_r, probs_r = r_moe._route(p_r["router"], jnp.asarray(x), cfg_r)
    _, e_t, probs_t = t_moe._route(p_t["router"], torch.from_numpy(x), cfg_t)
    ref = r_moe._aux_loss(probs_r, e_r, cfg_r.num_experts)
    out = t_moe._aux_loss(probs_t, e_t, cfg_t.num_experts)
    assert abs(float(out) - float(ref)) <= AUX_ATOL


def test_shared_expert_matches():
    cfg_r, p_r, cfg_t, p_t = _layer("kimi-k2-1t-a32b")
    assert "s_gate" in p_t
    x = _x(cfg_t, 1, 24, seed=4).reshape(24, -1)
    _close(t_moe._shared_expert(p_t, torch.from_numpy(x)),
           r_moe._shared_expert(p_r, jnp.asarray(x)), ATOL)


def test_expert_ffn_dense_matches(layer):
    _, (_, p_r, cfg_t, p_t) = layer
    x = _x(cfg_t, 1, 24, seed=5).reshape(24, -1)
    ref = r_moe._expert_ffn_dense(p_r["w_gate"], p_r["w_up"], p_r["w_down"], jnp.asarray(x))
    out = t_moe._expert_ffn_dense(p_t["w_gate"], p_t["w_up"], p_t["w_down"],
                                  torch.from_numpy(x))
    assert tuple(out.shape) == (24, cfg_t.num_experts, cfg_t.d_model)
    _close(out, ref, ATOL)


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_moe_layer_matches(layer, impl):
    _, (cfg_r, p_r, cfg_t, p_t) = layer
    x = _x(cfg_t, 2, 24, seed=6)
    ref, aux_r = r_moe.moe_layer(p_r, jnp.asarray(x), cfg_r, impl=impl)
    out, aux_t = t_moe.moe_layer(p_t, torch.from_numpy(x), cfg_t, impl=impl)
    _close(out, ref, ATOL)
    assert abs(float(aux_t) - float(aux_r)) <= AUX_ATOL


def test_ep_matches_dense_in_the_port(layer):
    """At the default capacity factor no assignment is dropped, so the
    production path equals the oracle."""
    _, (_, _, cfg_t, p_t) = layer
    x = torch.from_numpy(_x(cfg_t, 2, 40, seed=7))
    ep, aux_ep = t_moe.moe_layer(p_t, x, cfg_t, impl="ep")
    dense, aux_dense = t_moe.moe_layer(p_t, x, cfg_t, impl="dense")
    torch.testing.assert_close(ep, dense, atol=ATOL, rtol=0)
    assert float(aux_ep) == float(aux_dense)


def _reference_survivors(cfg_r, p_r, x, capacity):
    """The reference's _local_expert_pass dispatch, step for step: the tokens
    of the assignments it keeps, in order."""
    T = x.shape[0]
    _, top_e, _ = r_moe._route(p_r["router"], jnp.asarray(x), cfg_r)
    flat_e = top_e.reshape(-1)
    tok = jnp.repeat(jnp.arange(T, dtype=jnp.int32), cfg_r.experts_per_token)
    order = jnp.argsort(flat_e)
    return np.asarray(tok[order[:capacity]]), np.asarray(flat_e[order[:capacity]])


def test_capacity_cut_drops_the_reference_assignments():
    """T = 256, k = 2 at capacity factor 0.5: capacity 256 of 512 assignments,
    so half are dropped, and the stable sort decides which."""
    cfg_r, p_r, cfg_t, p_t = _layer("olmoe-1b-7b", moe_capacity_factor=0.5)
    T = 256
    capacity = t_moe._capacity(T, cfg_t, 1)
    assert capacity == r_moe._capacity(T, cfg_r, 1) == T * cfg_t.experts_per_token // 2
    x = _x(cfg_t, 1, T, seed=8)
    xt = x.reshape(T, -1)
    top_p, top_e, _ = t_moe._route(p_t["router"], torch.from_numpy(xt), cfg_t)
    sel_t, sel_p, sizes = t_moe._dispatch(top_p, top_e, cfg_t, 0, cfg_t.num_experts, capacity)
    ref_t, ref_e = _reference_survivors(cfg_r, p_r, xt, capacity)
    assert np.array_equal(sel_t.numpy(), ref_t)
    assert np.array_equal(sizes.numpy(), np.bincount(ref_e, minlength=cfg_t.num_experts))
    assert int(sizes.sum()) == capacity
    ref, aux_r = r_moe.moe_layer(p_r, jnp.asarray(x), cfg_r, impl="ep")
    out, aux_t = t_moe.moe_layer(p_t, torch.from_numpy(x), cfg_t, impl="ep")
    _close(out, ref, ATOL)
    assert abs(float(aux_t) - float(aux_r)) <= AUX_ATOL
    dense, _ = t_moe.moe_layer(p_t, torch.from_numpy(x), cfg_t, impl="dense")
    assert float((out - dense).abs().max()) > 1e-2, "the cut dropped nothing"


def test_grouped_ffn_leaves_rows_past_the_groups_zero():
    """ragged_dot's contract: rows past sum(group_sizes) give zeros."""
    _, _, cfg_t, p_t = _layer("olmoe-1b-7b")
    xe = torch.from_numpy(_x(cfg_t, 1, 10, seed=9).reshape(10, -1))
    sizes = torch.tensor([3, 0, 4] + [0] * (cfg_t.num_experts - 3))
    ye = t_moe._grouped_ffn(xe, p_t["w_gate"], p_t["w_up"], p_t["w_down"], sizes)
    assert torch.equal(ye[7:], torch.zeros_like(ye[7:]))
    one = t_moe._expert_ffn_dense(p_t["w_gate"], p_t["w_up"], p_t["w_down"], xe[3:7])[:, 2]
    torch.testing.assert_close(ye[3:7], one, atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_bf16_moe_layer_matches(impl):
    cfg_r, p_r, cfg_t, p_t = _layer("olmoe-1b-7b", dtype="bfloat16", param_dtype="bfloat16")
    assert p_t["router"].dtype == torch.float32 and p_t["w_up"].dtype == torch.bfloat16
    x = _x(cfg_t, 2, 24, seed=10)
    ref, aux_r = r_moe.moe_layer(p_r, jnp.asarray(x, jnp.bfloat16), cfg_r, impl=impl)
    out, aux_t = t_moe.moe_layer(p_t, torch.from_numpy(x).to(torch.bfloat16), cfg_t,
                                 impl=impl)
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(ref.astype(jnp.float32)), BF16_ATOL)
    assert abs(float(aux_t) - float(aux_r)) <= 1e-3


@pytest.mark.parametrize("impl", ["ep_ff", "ep_exact", "ep_ff_exact"])
def test_mesh_variants_name_their_roadmap_item(impl):
    """The mesh variants, once left to ROADMAP A.10, match the reference's
    layer with no mesh: ep_ff falls back to ep, and *_exact is the
    reference's flop-exact stand-in for ragged_dot."""
    cfg_r, p_r, cfg_t, p_t = _layer("olmoe-1b-7b")
    x = _x(cfg_t, 2, 24, seed=6)
    ref, aux_r = r_moe.moe_layer(p_r, jnp.asarray(x), cfg_r, impl=impl)
    out, aux_t = t_moe.moe_layer(p_t, torch.from_numpy(x), cfg_t, impl=impl)
    _close(out, ref, ATOL)
    assert abs(float(aux_t) - float(aux_r)) <= AUX_ATOL


def test_init_moe_keeps_the_reference_tree():
    """The port's own init: the reference's keys, shapes and dtypes, the router
    fp32 inside a bf16 tree."""
    cfg_r, cfg_t = _configs("kimi-k2-1t-a32b", dtype="bfloat16", param_dtype="bfloat16")
    ref = r_moe.init_moe(jax.random.PRNGKey(0), 3, cfg_r, jnp.bfloat16)
    own = t_moe.init_moe(torch.Generator().manual_seed(0), 3, cfg_t, torch.bfloat16,
                         device="cpu")
    assert own.keys() == ref.keys()
    for k in ref:
        assert tuple(own[k].shape) == ref[k].shape
        assert str(own[k].dtype).removeprefix("torch.") == ref[k].dtype.name
