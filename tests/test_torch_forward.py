"""Full-sequence forward and cached decode: the port (on the CPU) against the
reference, on reduced configs in fp32.

The reference runs ``ModelOptions(attn_impl="flash", ssd_impl="pallas")`` with
its Pallas kernels in interpret mode; the port runs the same options, which on
CPU tensors take the kernels' plain versions. Parameters are the reference's,
carried across with ``from_reference``. Tolerances: logits 1e-3, and decode
logits 1e-3 over 12 steps, as tests/test_serving.py:41 holds paged against
dense decode. Caches and states are held at 1e-3 of their largest magnitude:
the reduced zamba2's SSD states grow to ~1e4 over four layers of random
weights, where the reference's own ``ref``, ``chunked`` and ``pallas`` paths
already differ by up to ~1 (1e-4 of the magnitude, fp32 summation order). Decode against teacher forcing is held at 2e-2 and
ring decode against dense decode at 1e-3, as tests/test_arch_smoke.py:76 and
:99 hold the reference. The MoE balance loss is held at 1e-5. Paged decode
runs the port's and the reference's ``paged_decode_step`` over the same
pools, the reference's Pallas kernel in interpret mode.
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
import repro.serving.paged_decode as r_pd  # noqa: E402
import repro_torch.configs as t_configs  # noqa: E402
import repro_torch.models.transformer as t_tf  # noqa: E402
import repro_torch.serving.paged_decode as t_pd  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

ATOL = 1e-3
AUX_ATOL = 1e-5
FLASH = dict(attn_impl="flash", ssd_impl="pallas")
MOE = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, reference params, port cfg, port params), reduced fp32."""
    out = {}
    for arch in ("gemma3-1b", "zamba2-1.2b", "internvl2-1b", "hubert-xlarge", *MOE):
        cfg_r = r_configs.get_config(arch).reduced()
        params_r = r_tf.init_params(jax.random.PRNGKey(0), cfg_r)
        cfg_t = t_configs.get_config(arch).reduced()
        params_t = from_reference(jax.tree.map(np.asarray, params_r), cfg_t, device="cpu")
        out[arch] = (cfg_r, params_r, cfg_t, params_t)
    return out


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _assert_tree_close(port, ref, atol, scaled=False):
    """Leaf by leaf; with `scaled`, atol is relative to the leaf's largest |value|."""
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for k in ref:
            _assert_tree_close(port[k], ref[k], atol, scaled)
    elif isinstance(ref, tuple):
        assert len(port) == len(ref)
        for p, r in zip(port, ref, strict=True):
            _assert_tree_close(p, r, atol, scaled)
    else:
        ref = np.asarray(ref, np.float32)
        assert tuple(port.shape) == ref.shape
        tol = atol * max(1.0, float(np.abs(ref).max())) if scaled else atol
        np.testing.assert_allclose(port.float().numpy(), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b", *MOE])
@pytest.mark.parametrize("last_only", [False, True], ids=["all", "last"])
def test_forward_and_prefill_caches_match_reference(models, arch, last_only):
    """Logits, the aux loss (the MoE balance loss summed over layers, 0
    elsewhere) and the prefill caches (kimi-k2's leading dense layer in
    ``dense_kv``)."""
    cfg_r, params_r, cfg_t, params_t = models[arch]
    toks = _inputs(cfg_t, 2, 20, seed=1)
    ref_logits, ref_aux, ref_caches = r_tf.forward(params_r, cfg_r, jnp.asarray(toks),
                                                   r_tf.ModelOptions(**FLASH), collect_kv=True,
                                                   last_only=last_only)
    logits, aux, caches = t_tf.forward(params_t, cfg_t, torch.from_numpy(toks),
                                       t_tf.ModelOptions(**FLASH), collect_kv=True,
                                       last_only=last_only)
    assert abs(float(aux) - float(ref_aux)) <= AUX_ATOL
    assert (float(aux) > 0.0) == cfg_t.moe
    assert ("dense_kv" in caches) == bool(cfg_t.moe_first_dense)
    _assert_tree_close(logits, ref_logits, ATOL)
    _assert_tree_close(caches, ref_caches, ATOL, scaled=True)


@pytest.mark.parametrize("arch,impl", [("gemma3-1b", "xla"), ("gemma3-1b", "xla_chunked"),
                                       ("zamba2-1.2b", "xla"), ("internvl2-1b", "flash"),
                                       ("hubert-xlarge", "flash")])
def test_forward_matches_reference(models, arch, impl):
    """The other attention paths, and the embeddings input of the vlm/audio
    families (hubert is non-causal, so "flash" takes the xla mask there too)."""
    cfg_r, params_r, cfg_t, params_t = models[arch]
    inputs = _inputs(cfg_t, 2, 16, seed=2)
    ref, _, _ = r_tf.forward(params_r, cfg_r, jnp.asarray(inputs),
                             r_tf.ModelOptions(attn_impl=impl))
    out, _, _ = t_tf.forward(params_t, cfg_t, torch.from_numpy(inputs),
                             t_tf.ModelOptions(attn_impl=impl))
    _assert_tree_close(out, ref, ATOL)


@pytest.mark.parametrize("arch,ring", [("gemma3-1b", False), ("gemma3-1b", True),
                                       ("zamba2-1.2b", False), *[(a, False) for a in MOE]],
                         ids=["gemma3-1b", "gemma3-1b-ring", "zamba2-1.2b", *MOE])
def test_decode_matches_reference(models, arch, ring):
    cfg_r, params_r, cfg_t, params_t = models[arch]
    B, steps = 2, 12
    toks = _inputs(cfg_t, B, steps, seed=3)
    r_opts, t_opts = r_tf.ModelOptions(sliding_ring=ring), t_tf.ModelOptions(sliding_ring=ring)
    r_step = jax.jit(r_tf.decode_step, static_argnums=(1, 4))
    r_state = r_tf.init_decode_state(params_r, cfg_r, B, steps + 4, sliding_ring=ring)
    t_state = t_tf.init_decode_state(params_t, cfg_t, B, steps + 4, sliding_ring=ring)
    assert t_state.keys() == r_state.keys()
    for t in range(steps):
        ref, r_state = r_step(params_r, cfg_r, r_state, jnp.asarray(toks[:, t:t + 1]), r_opts)
        out, t_state = t_tf.decode_step(params_t, cfg_t, t_state,
                                        torch.from_numpy(toks[:, t:t + 1]), t_opts)
        _assert_tree_close(out, ref, ATOL)
    _assert_tree_close(t_state, r_state, ATOL, scaled=True)


def _chip_smoke():
    """chip_smoke.py as a module: it imports torch and nothing of the card at
    module level, so its helpers run here on CPU tensors."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b"])
def test_prefill_then_decode_matches_teacher_forcing(models, arch):
    """The main path as chip_smoke.py drives it: prefill with collect_kv and
    last_only, then decode from those caches through its own
    decode_state_from_prefill; each step's logits match a full forward over
    the tokens so far."""
    _, _, cfg, params = models[arch]
    B, S, steps = 2, 10, 6
    toks = torch.from_numpy(_inputs(cfg, B, S + steps, seed=4))
    opts = t_tf.ModelOptions(**FLASH)
    full, _, _ = t_tf.forward(params, cfg, toks, opts)
    last, _, caches = t_tf.forward(params, cfg, toks[:, :S], opts, collect_kv=True,
                                   last_only=True)
    torch.testing.assert_close(last[:, 0], full[:, S - 1], atol=ATOL, rtol=0)
    state = _chip_smoke().decode_state_from_prefill(t_tf, params, cfg, caches, B, S,
                                                    S + steps)
    for t in range(S, S + steps):
        logits, state = t_tf.decode_step(params, cfg, state, toks[:, t:t + 1], opts)
        torch.testing.assert_close(logits, full[:, t], atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b"])
def test_decode_matches_teacher_forcing(models, arch):
    """tests/test_arch_smoke.py:76 in the port alone."""
    _, _, cfg, params = models[arch]
    S = 12
    toks = torch.from_numpy(_inputs(cfg, 1, S, seed=5))
    full, _, _ = t_tf.forward(params, cfg, toks)
    state = t_tf.init_decode_state(params, cfg, 1, S + 4)
    errs = []
    for t in range(S):
        logits, state = t_tf.decode_step(params, cfg, state, toks[:, t:t + 1])
        errs.append(float((logits[0] - full[0, t]).abs().max()))
    assert max(errs) < 2e-2, f"decode/teacher-forcing divergence: {max(errs)}"


def test_sliding_ring_decode_matches_dense(models):
    """tests/test_arch_smoke.py:99 in the port alone."""
    _, _, cfg, params = models["gemma3-1b"]
    B, S = 2, 24
    toks = torch.from_numpy(_inputs(cfg, B, S, seed=6))
    state_d = t_tf.init_decode_state(params, cfg, B, S + 4)
    state_r = t_tf.init_decode_state(params, cfg, B, S + 4, sliding_ring=True)
    opts_r = t_tf.ModelOptions(sliding_ring=True)
    for t in range(S):
        ld, state_d = t_tf.decode_step(params, cfg, state_d, toks[:, t:t + 1])
        lr, state_r = t_tf.decode_step(params, cfg, state_r, toks[:, t:t + 1], opts_r)
        torch.testing.assert_close(ld, lr, atol=1e-3, rtol=0)
    assert state_r["kv_ring"][0].shape[2] == cfg.sliding_window


def test_hybrid_params_match_the_reference_tree():
    """The port's own init gives the reference's tree: keys, shapes and dtypes,
    with A_log, D and dt_bias fp32 inside a bf16 tree; from_reference keeps them."""
    cfg_r = dataclasses.replace(r_configs.get_config("zamba2-1.2b").reduced(),
                                dtype="bfloat16", param_dtype="bfloat16")
    cfg_t = dataclasses.replace(t_configs.get_config("zamba2-1.2b").reduced(),
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
    assert carried["blocks"]["A_log"].dtype == torch.float32
    assert carried["blocks"]["in_proj"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="blocks/in_proj"):
        from_reference(ref, dataclasses.replace(cfg_t, ssm_state=32), device="cpu")


@pytest.mark.parametrize("arch,item", [("olmoe-1b-7b", "ROADMAP A.10"),
                                       ("kimi-k2-1t-a32b", "ROADMAP A.10")])
def test_unported_families_name_their_roadmap_item(models, arch, item):
    """The MoE layer's mesh variants, the last part of the families left
    unported, are ported by the multi-device layer (`item`): without a mesh
    each runs the forward and a decode step and gives the reference's
    logits (ep_ff falls back to ep; *_exact is the roofline stand-in)."""
    del item
    cfg_r, params_r, cfg, params = models[arch]
    toks = _inputs(cfg, 1, 4, seed=11)
    for impl in ("ep_ff", "ep_exact", "ep_ff_exact"):
        opts = t_tf.ModelOptions(moe_impl=impl)
        ref, _, _ = r_tf.forward(params_r, cfg_r, jnp.asarray(toks),
                                 r_tf.ModelOptions(moe_impl=impl))
        with torch.no_grad():
            out, _, _ = t_tf.forward(params, cfg, torch.from_numpy(toks), opts)
            state = t_tf.init_decode_state(params, cfg, 1, 8)
            step, _ = t_tf.decode_step(params, cfg, state, torch.from_numpy(toks[:, :1]), opts)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        assert torch.isfinite(step).all() and tuple(step.shape) == (1, cfg.padded_vocab)


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_match_the_reference_tree(arch):
    """The port's own init gives the reference's MoE tree (kimi-k2's
    dense_stack and shared expert included): keys, shapes and dtypes, the
    router fp32 inside a bf16 tree; from_reference keeps them and refuses a
    tree of other widths."""
    cfg_r = dataclasses.replace(r_configs.get_config(arch).reduced(),
                                dtype="bfloat16", param_dtype="bfloat16")
    cfg_t = dataclasses.replace(t_configs.get_config(arch).reduced(),
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
    assert carried["stack"]["moe"]["router"].dtype == torch.float32
    assert carried["stack"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert ("dense_stack" in carried) == bool(cfg_t.moe_first_dense)
    with pytest.raises(ValueError, match="stack/moe/w_gate"):
        from_reference(ref, dataclasses.replace(cfg_t, moe_d_ff=2 * cfg_t.moe_d_ff),
                       device="cpu")


def test_remat_names_the_training_item(models):
    """remat "full" and "offload" (ROADMAP A.9, ported) change only where the
    backward finds its activations: the loss and every gradient equal those
    without remat within 1e-6, and the loss the reference's under the same
    remat within 1e-5."""
    cfg_r, params_r, cfg, params = models["gemma3-1b"]
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}

    def port(remat):
        from repro_torch.tree import leaves, tree_map

        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = t_tf.loss_fn(live, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                               t_tf.ModelOptions(remat=remat))
        return float(loss), torch.autograd.grad(loss, leaves(live))

    loss0, g0 = port("none")
    for remat in ("full", "offload"):
        loss, g = port(remat)
        assert abs(loss - loss0) <= 1e-6 * abs(loss0)
        for a, b in zip(g0, g, strict=True):
            assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
        ref, _ = r_tf.loss_fn(params_r, cfg_r, {k: jnp.asarray(v) for k, v in batch.items()},
                              r_tf.ModelOptions(remat=remat))
        assert abs(loss - float(ref)) < 1e-5


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "internvl2-1b", "hubert-xlarge"])
def test_paged_decode_matches_reference_across_families(models, arch):
    """The paged decode serves what the reference's serves: olmoe (MoE, token
    ids) and internvl2 and hubert ((B, 1, D) embeddings). 12 steps over one
    block table, logits at 1e-3 and the pools at 1e-4 of their largest |value|
    (unit-normal embeddings give K/V up to ~20) against the reference's, both
    at the engine's default moe_impl="dense"."""
    cfg_r, params_r, cfg_t, params_t = models[arch]
    B, page, maxp, steps = 2, 8, 2, 12
    shape = (cfg_r.num_layers, 2 * maxp, page, cfg_r.num_kv_heads, cfg_r.resolved_head_dim)
    k_r = v_r = jnp.zeros(shape, jnp.float32)
    k_t, v_t = torch.zeros(shape), torch.zeros(shape)
    table = np.stack([np.arange(maxp), np.arange(maxp) + maxp]).astype(np.int32)
    inputs = _inputs(cfg_t, B, steps, seed=7)
    r_opts, t_opts = r_tf.ModelOptions(moe_impl="dense"), t_tf.ModelOptions(moe_impl="dense")
    for t in range(steps):
        x = inputs[:, t:t + 1]
        lengths = np.full((B,), t, np.int32)
        ref, k_r, v_r = r_pd.paged_decode_step(params_r, cfg_r, k_r, v_r, jnp.asarray(table),
                                               jnp.asarray(lengths), jnp.asarray(x), r_opts)
        out, k_t, v_t = t_pd.paged_decode_step(params_t, cfg_t, k_t, v_t,
                                               torch.from_numpy(table),
                                               torch.from_numpy(lengths), torch.from_numpy(x),
                                               t_opts)
        _assert_tree_close(out, ref, ATOL)
    _assert_tree_close((k_t, v_t), (k_r, v_r), 1e-4, scaled=True)


@pytest.mark.parametrize("arch,message", [
    ("kimi-k2-1t-a32b", "use uniform stacks for paged demo"),
    ("zamba2-1.2b", "paged decode is for attention archs"),
    ("rwkv6-3b", "paged decode is for attention archs"),
])
def test_paged_decode_refuses_what_the_reference_refuses(arch, message):
    """kimi-k2 (a leading dense layer), zamba2 (hybrid) and rwkv6 (ssm): the
    reference asserts with these words, the port raises with them."""
    cfg_r = r_configs.get_config(arch).reduced()
    cfg_t = t_configs.get_config(arch).reduced()
    shape = (cfg_t.num_layers, 2, 8, cfg_t.num_kv_heads, cfg_t.resolved_head_dim)
    table, lengths = np.zeros((1, 2), np.int32), np.zeros((1,), np.int32)
    toks = np.zeros((1, 1), np.int32)
    with pytest.raises(AssertionError, match=message):
        r_pd.paged_decode_step({}, cfg_r, jnp.zeros(shape), jnp.zeros(shape),
                               jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(toks))
    with pytest.raises(NotImplementedError, match=message):
        t_pd.paged_decode_step({}, cfg_t, torch.zeros(shape), torch.zeros(shape),
                               torch.from_numpy(table), torch.from_numpy(lengths),
                               torch.from_numpy(toks))
