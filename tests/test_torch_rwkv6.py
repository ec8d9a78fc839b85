"""rwkv6 (the ssm family): the port's full-sequence forward and cached decode
(on the CPU) against the reference, on reduced rwkv6-3b in fp32 (2 layers,
d_model 128, 4 heads of 32, decay LoRA 16).

The reference runs ``ModelOptions(wkv_impl=...)`` with its Pallas kernel in
interpret mode for "pallas"; the port runs the same options, which on CPU
tensors take the plain chunked form. Parameters are the reference's, carried
across with ``from_reference``. Tolerances: logits 1e-3, and decode logits
1e-3 over 12 steps, as tests/test_torch_forward.py holds the other families.
Caches and states are held at 1e-3 of their own largest magnitude with no
floor at 1: the WKV states sit near 2e-2 and the token-shift carries near
0.2, where an absolute 1e-3 would pass a lost chunk. Decode against teacher
forcing is held at 2e-2, as tests/test_arch_smoke.py:76 holds the reference.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as r_configs  # noqa: E402
import repro.models.transformer as r_tf  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
import repro_torch.models.transformer as t_tf  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

ARCH = "rwkv6-3b"
ATOL = 1e-3


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params), reduced fp32."""
    cfg_r = r_configs.get_config(ARCH).reduced()
    params_r = r_tf.init_params(jax.random.PRNGKey(0), cfg_r)
    cfg_t = t_configs.get_config(ARCH).reduced()
    params_t = from_reference(jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
    return cfg_r, params_r, cfg_t, params_t


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _assert_close(port, ref, atol, relative=False):
    """Leaf by leaf; with `relative`, atol is taken of the leaf's largest |value|."""
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for k in ref:
            _assert_close(port[k], ref[k], atol, relative)
        return
    ref = np.asarray(ref, np.float32)
    assert tuple(port.shape) == ref.shape
    tol = atol * float(np.abs(ref).max()) if relative else atol
    np.testing.assert_allclose(port.float().numpy(), ref, atol=tol, rtol=0)


def _chip_smoke():
    """chip_smoke.py as a module: it imports torch and nothing of the card at
    module level, so its helpers run here on CPU tensors."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("impl", ["chunked", "pallas", "ref"])
@pytest.mark.parametrize("last_only", [False, True], ids=["all", "last"])
def test_forward_and_prefill_caches_match_reference(model, impl, last_only):
    cfg_r, params_r, cfg_t, params_t = model
    toks = _tokens(cfg_t, 2, 37, seed=1)          # 37: two chunks of 16 and a ragged one
    ref_logits, _, ref_caches = r_tf.forward(params_r, cfg_r, jnp.asarray(toks),
                                             r_tf.ModelOptions(wkv_impl=impl),
                                             collect_kv=True, last_only=last_only)
    logits, aux, caches = t_tf.forward(params_t, cfg_t, torch.from_numpy(toks),
                                       t_tf.ModelOptions(wkv_impl=impl), collect_kv=True,
                                       last_only=last_only)
    assert float(aux) == 0.0
    assert caches["rwkv"]["wkv"].dtype == torch.float32
    assert tuple(caches["rwkv"]["wkv"].shape) == (cfg_t.num_layers, 2, 4, 32, 32)
    _assert_close(logits, ref_logits, ATOL)
    _assert_close(caches, ref_caches, ATOL, relative=True)


def test_forward_without_collect_kv_returns_no_caches(model):
    _, _, cfg, params = model
    logits, _, caches = t_tf.forward(params, cfg, torch.from_numpy(_tokens(cfg, 1, 5, seed=2)))
    assert caches == {} and tuple(logits.shape) == (1, 5, cfg.padded_vocab)


def test_decode_matches_reference(model):
    """12 decode steps from the empty state, logits and the final states."""
    cfg_r, params_r, cfg_t, params_t = model
    B, steps = 2, 12
    toks = _tokens(cfg_t, B, steps, seed=3)
    r_step = jax.jit(r_tf.decode_step, static_argnums=(1, 4))
    r_state = r_tf.init_decode_state(params_r, cfg_r, B, steps + 4)
    t_state = t_tf.init_decode_state(params_t, cfg_t, B, steps + 4)
    assert t_state.keys() == r_state.keys()
    _assert_close(t_state["rwkv"], r_state["rwkv"], 0.0)
    for t in range(steps):
        ref, r_state = r_step(params_r, cfg_r, r_state, jnp.asarray(toks[:, t:t + 1]),
                              r_tf.ModelOptions())
        out, t_state = t_tf.decode_step(params_t, cfg_t, t_state,
                                        torch.from_numpy(toks[:, t:t + 1]))
        _assert_close(out, ref, ATOL)
    assert int(t_state["lengths"][0]) == steps
    _assert_close(t_state["rwkv"], r_state["rwkv"], ATOL, relative=True)


def test_decode_from_the_prefill_state_matches_reference(model):
    """Prefill 20 tokens with the kernels' paths, then 12 decode steps from
    caches["rwkv"] in each package."""
    cfg_r, params_r, cfg_t, params_t = model
    B, S, steps = 2, 20, 12
    toks = _tokens(cfg_t, B, S + steps, seed=4)
    _, _, r_caches = r_tf.forward(params_r, cfg_r, jnp.asarray(toks[:, :S]),
                                  r_tf.ModelOptions(wkv_impl="pallas"), collect_kv=True,
                                  last_only=True)
    _, _, t_caches = t_tf.forward(params_t, cfg_t, torch.from_numpy(toks[:, :S]),
                                  t_tf.ModelOptions(wkv_impl="pallas"), collect_kv=True,
                                  last_only=True)
    r_state = {"lengths": jnp.full((B,), S, jnp.int32), "rwkv": r_caches["rwkv"]}
    t_state = {"lengths": torch.full((B,), S, dtype=torch.int32), "rwkv": t_caches["rwkv"]}
    r_step = jax.jit(r_tf.decode_step, static_argnums=(1, 4))
    for t in range(S, S + steps):
        ref, r_state = r_step(params_r, cfg_r, r_state, jnp.asarray(toks[:, t:t + 1]),
                              r_tf.ModelOptions())
        out, t_state = t_tf.decode_step(params_t, cfg_t, t_state,
                                        torch.from_numpy(toks[:, t:t + 1]))
        _assert_close(out, ref, ATOL)
    _assert_close(t_state["rwkv"], r_state["rwkv"], ATOL, relative=True)


def test_prefill_then_decode_matches_teacher_forcing(model):
    """The main path as chip_smoke.py drives it: prefill with collect_kv and
    last_only, then decode from caches["rwkv"] through its own
    decode_state_from_prefill; each step's logits match a full forward over
    the tokens so far."""
    _, _, cfg, params = model
    B, S, steps = 2, 18, 6
    toks = torch.from_numpy(_tokens(cfg, B, S + steps, seed=5))
    opts = t_tf.ModelOptions(wkv_impl="pallas")
    full, _, _ = t_tf.forward(params, cfg, toks, opts)
    last, _, caches = t_tf.forward(params, cfg, toks[:, :S], opts, collect_kv=True,
                                   last_only=True)
    torch.testing.assert_close(last[:, 0], full[:, S - 1], atol=ATOL, rtol=0)
    state = _chip_smoke().decode_state_from_prefill(t_tf, params, cfg, caches, B, S,
                                                    S + steps)
    for t in range(S, S + steps):
        logits, state = t_tf.decode_step(params, cfg, state, toks[:, t:t + 1], opts)
        torch.testing.assert_close(logits, full[:, t], atol=ATOL, rtol=0)


def test_decode_matches_teacher_forcing(model):
    """tests/test_arch_smoke.py:76 in the port alone."""
    _, _, cfg, params = model
    S = 12
    toks = torch.from_numpy(_tokens(cfg, 1, S, seed=6))
    full, _, _ = t_tf.forward(params, cfg, toks)
    state = t_tf.init_decode_state(params, cfg, 1, S + 4)
    errs = []
    for t in range(S):
        logits, state = t_tf.decode_step(params, cfg, state, toks[:, t:t + 1])
        errs.append(float((logits[0] - full[0, t]).abs().max()))
    assert max(errs) < 2e-2, f"decode/teacher-forcing divergence: {max(errs)}"


def test_params_match_the_reference_tree():
    """The port's own init gives the reference's tree: keys, shapes and dtypes,
    with w0, wA, wB and u fp32 inside a bf16 tree; from_reference keeps them
    and rejects a tree of another width or head size."""
    cfg_r = dataclasses.replace(r_configs.get_config(ARCH).reduced(),
                                dtype="bfloat16", param_dtype="bfloat16")
    cfg_t = dataclasses.replace(t_configs.get_config(ARCH).reduced(),
                                dtype="bfloat16", param_dtype="bfloat16")
    ref = jax.tree.map(np.asarray, r_tf.init_params(jax.random.PRNGKey(0), cfg_r))
    own = t_tf.init_params(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    carried = from_reference(ref, cfg_t, device="cpu")
    for tree in (own, carried):
        assert jax.tree.structure(jax.tree.map(lambda a: 0, ref)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, tree))
        for r, t in zip(jax.tree.leaves(ref), jax.tree.leaves(tree), strict=True):
            assert tuple(t.shape) == r.shape
            assert str(t.dtype).removeprefix("torch.") == r.dtype.name
        for name in ("w0", "wA", "wB", "u"):
            assert tree["blocks"][name].dtype == torch.float32
        assert tree["blocks"]["wr"].dtype == torch.bfloat16
    np.testing.assert_array_equal(carried["blocks"]["u"].numpy(), ref["blocks"]["u"])
    with pytest.raises(ValueError, match="blocks/wr"):
        from_reference(ref, dataclasses.replace(cfg_t, d_model=256), device="cpu")
    with pytest.raises(ValueError, match="blocks/u"):
        from_reference(ref, dataclasses.replace(cfg_t, rwkv_head_dim=16), device="cpu")


def test_bf16_forward_and_decode_run_on_the_port_alone():
    """The full model's dtypes at reduced width: bf16 activations and weights,
    fp32 decay and WKV state; prefill then decode stay finite and keep them."""
    cfg = dataclasses.replace(t_configs.get_config(ARCH).reduced(), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = t_tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 21, seed=7))
    logits, _, caches = t_tf.forward(params, cfg, toks[:, :20],
                                     t_tf.ModelOptions(wkv_impl="pallas"), collect_kv=True,
                                     last_only=True)
    rwkv = caches["rwkv"]
    assert rwkv["tm_x"].dtype == rwkv["cm_x"].dtype == torch.bfloat16
    assert rwkv["wkv"].dtype == torch.float32
    state = {"lengths": torch.full((2,), 20, dtype=torch.int32), "rwkv": rwkv}
    step_logits, state = t_tf.decode_step(params, cfg, state, toks[:, 20:21])
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())
    assert state["rwkv"]["wkv"].dtype == torch.float32
