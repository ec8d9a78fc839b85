"""granite-4.0-h-small on the port (the ``hybrid_moe`` family): the stack against
the benchmark's plain reference (``perfbench/reference/granite.py``, the one
module the cell's ``correct`` is decided by), its registry entry, its spans
and counts, and what it refuses.

The comparisons run the port in float32 on the CPU against the reference in
float64, at the reference's tiny cut (three Mamba2 layers around one
attention layer, 64 wide). The decay leaves take the published Mamba2 init
(A in [1, 16], dt log-uniform in [0.001, 0.1] through the inverse softplus,
D = 1), under which the state carries across the chunks of a 100-token
sequence: the port's SSD runs 4 chunks of 32, the reference 5 of 24.

No JAX here: the JAX package has no granite.
"""

import dataclasses
import math

import pytest
import torch

from perfbench.lib import files, weights
from perfbench.reference import granite
from perfbench.reference.common import relative
from repro_torch import spans
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.mamba2_ssd import mamba2_ssd as ssd_kernel
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf

NAME = "granite-4.0-h-small"
S = 100
# The port in fp32 against the reference in fp64: each differs from exact
# arithmetic by fp32 rounding, ~2e-7 of each number's size through these four
# layers (measured up to 6e-7 on the SSD states); 1e-5 leaves a factor of 15
# and stays 1000x below what dropping the carried state costs (the test below).
TOL = 1e-5


def _published_model():
    return files.load_json("configs", NAME)


def _tiny(seed: int, **sizes):
    """The tiny cut's configuration file, the port's config and weights with
    the published Mamba2 init on the decay leaves."""
    model = granite.tiny_model(_published_model(), mamba_chunk_size=24, **sizes)
    cfg = dataclasses.replace(get_config(NAME), **granite.tiny_port(model, get_config(NAME)))
    w = weights.draw(model, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    Lm, H = w["mamba"]["A_log"].shape
    w["mamba"]["A_log"] = torch.log(torch.rand((Lm, H), generator=g) * 15 + 1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((Lm, H), generator=g) * (hi - lo) + lo)
    w["mamba"]["dt_bias"] = dt + torch.log(-torch.expm1(-dt))     # softplus^-1(dt)
    w["mamba"]["D"] = torch.ones((Lm, H))
    toks = torch.randint(0, model["vocab_size"], (2, S), generator=g)
    return model, cfg, w, toks


def _reference(model, w, toks):
    kv, states = {}, {}
    logits = granite.forward(w, model, list(toks), mode="fp64",
                             on_kv=lambda l, j, k, v: kv.__setitem__((l, j), (k, v)),
                             on_state=lambda l, j, c, s: states.__setitem__((l, j), (c, s)))
    return logits, kv, states


def _worst(model, got, want) -> dict:
    """The largest relative error of the logits, K and V, and the Mamba2
    conv and SSD states, over both sequences and every layer."""
    logits, _, caches = got
    ref_logits, kv, states = want
    V = model["vocab_size"]
    ks, vs = caches["kv"]
    worst = {"logits": 0.0, "kv": 0.0, "conv": 0.0, "ssd": 0.0}
    for j in range(2):
        worst["logits"] = max(worst["logits"], relative(logits[j, :, :V], ref_logits[j]))
        for n, layer in enumerate(granite.attention_layers(model)):
            k, v = kv[(layer, j)]
            worst["kv"] = max(worst["kv"], relative(ks[n, j], k), relative(vs[n, j], v))
        for m, layer in enumerate(granite.mamba_layers(model)):
            conv, ssd = states[(layer, j)]
            worst["conv"] = max(worst["conv"], relative(caches["mamba"]["conv"][m, j], conv))
            worst["ssd"] = max(worst["ssd"], relative(caches["mamba"]["ssd"][m, j], ssd))
    return worst


@pytest.mark.parametrize("ssd_impl", ["chunked", "pallas", "ref"])
def test_forward_matches_the_reference(ssd_impl):
    """Logits, the attention layer's K and V, and every Mamba2 layer's conv
    and SSD states; "pallas" takes the plain chunked form on CPU tensors."""
    model, cfg, w, toks = _tiny(7)
    got = tf.forward(w, cfg, toks, tf.ModelOptions(attn_impl="flash", moe_impl="ep",
                                                    ssd_impl=ssd_impl), collect_kv=True)
    assert got[0].shape == (2, S, cfg.padded_vocab)
    assert got[2]["kv"][0].shape == (1, 2, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert got[2]["mamba"]["ssd"].shape[0] == 3
    worst = _worst(model, got, _reference(model, w, toks))
    assert max(worst.values()) < TOL, worst


def test_last_only_gives_the_last_row():
    """The serving prefill's form; one row's unembedding takes another GEMM
    than all rows', so the two agree to fp32 rounding, not bit for bit."""
    model, cfg, w, toks = _tiny(8)
    full, _, _ = tf.forward(w, cfg, toks, collect_kv=True)
    last, _, caches = tf.forward(w, cfg, toks, collect_kv=True, last_only=True)
    assert last.shape == (2, 1, cfg.padded_vocab) and "mamba" in caches
    assert relative(last[:, 0], full[:, -1]) < TOL


def test_dropping_the_carried_state_fails_the_comparison(monkeypatch):
    """An SSD that starts every chunk of 32 from a zero state (the state not
    carried across chunks) moves the states and logits far past TOL: the
    comparison sees the state passing."""
    model, cfg, w, toks = _tiny(7)
    want = _reference(model, w, toks)
    plain = m2.ssd

    def chunks_alone(x, dt, A, Bm, C, D, state, impl="chunked", chunk=32):
        outs = [plain(x[:, a:a + chunk], dt[:, a:a + chunk], A, Bm[:, a:a + chunk],
                      C[:, a:a + chunk], D, torch.zeros_like(state), impl=impl, chunk=chunk)
                for a in range(0, x.shape[1], chunk)]
        return torch.cat([y for y, _ in outs], dim=1), outs[-1][1]

    monkeypatch.setattr(m2, "ssd", chunks_alone)
    worst = _worst(model, tf.forward(w, cfg, toks, collect_kv=True), want)
    assert worst["ssd"] > 1000 * TOL and worst["logits"] > 1000 * TOL, worst


def test_reference_row_blocks_leave_its_result_unchanged(monkeypatch):
    """The reference's Mamba2 mixer in blocks of 48 rows (two chunks of 24),
    handing on the conv's last inputs and the SSD state, against one block:
    the same rows through the same arithmetic, to float64's rounding."""
    model, _, w, toks = _tiny(10)
    whole = _reference(model, w, toks)
    monkeypatch.setattr(granite, "ROW_BLOCK", 48)
    blocked = _reference(model, w, toks)
    for j in range(2):
        assert relative(blocked[0][j], whole[0][j]) < 1e-12
    for key, (conv, ssd) in whole[2].items():
        assert relative(blocked[2][key][0], conv) < 1e-12
        assert relative(blocked[2][key][1], ssd) < 1e-12


@pytest.mark.parametrize("chunk", [8, 24, 256])
def test_reference_ssd_is_the_sequential_recurrence(chunk):
    """The reference's chunked SSD against the step-by-step recurrence
    H_t = exp(A dt_t) H_{t-1} + dt_t x_t (x) B_t, y_t = H_t C_t + D x_t, in
    float64 (agreement to float64's rounding, 1e-12)."""
    g = torch.Generator().manual_seed(chunk)
    T, H, P, N = 70, 3, 4, 5
    x = torch.randn((T, H, P), generator=g, dtype=torch.float64)
    dt = torch.rand((T, H), generator=g, dtype=torch.float64) * 0.5
    A = -(torch.rand((H,), generator=g, dtype=torch.float64) * 4 + 0.1)
    Bm, C = (torch.randn((T, N), generator=g, dtype=torch.float64) for _ in range(2))
    D = torch.randn((H,), generator=g, dtype=torch.float64)
    y, state = granite.ssd(x, dt, A, Bm, C, D, chunk)
    h = torch.zeros((H, P, N), dtype=torch.float64)
    for t in range(T):
        h = torch.exp(A * dt[t])[:, None, None] * h + (dt[t, :, None] * x[t])[..., None] * Bm[t]
        assert (y[t] - (h @ C[t] + D[:, None] * x[t])).abs().max() < 1e-12
    assert (state - h).abs().max() < 1e-12


def test_published_config_and_its_counts():
    """The registry entry holds the file's widths (the benchmark's own check),
    its tree is the benchmark's layout, and its parameter count, exact against
    the tree, is granite's 32.2B (9B active)."""
    cfg, model = get_config(NAME), _published_model()
    granite.port_check(model, cfg)
    with pytest.raises(SystemExit):
        granite.port_check(model, dataclasses.replace(cfg, attention_layers=(5, 15, 25)))
    with pytest.raises(SystemExit):
        granite.port_check(model, dataclasses.replace(cfg, residual_multiplier=1.0))
    tree = tf.init_params(None, cfg, device="meta")
    leaves = dict(weights.leaves(tree))
    assert {n: (tuple(t.shape), t.dtype) for n, t in leaves.items()} == granite.layout(model)
    assert cfg.param_count() == sum(t.numel() for t in leaves.values())
    assert abs(cfg.param_count() / 32.2e9 - 1) < 0.005
    assert 8.5e9 < cfg.active_param_count() < 9.5e9
    assert NAME not in ARCH_IDS
    # the SSD kernel takes its widths, and the flash kernel its head dim
    d = granite.dims(model)
    ssd_kernel.check_widths(d["P"], d["Ns"])
    reduced = cfg.reduced()
    assert reduced.attention_layers == (1,) and reduced.num_layers == 3


def test_decode_paths_refuse_the_family():
    from repro_torch.serving.paged_decode import paged_decode_step

    cfg = get_config(NAME).reduced()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    pool = torch.zeros((cfg.num_layers, 4, 8, K, hd))
    table = torch.zeros((1, 2), dtype=torch.int32)
    lengths = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attention archs"):
        paged_decode_step(params, cfg, pool, pool.clone(), table, lengths,
                          torch.zeros((1, 1), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="hybrid_moe"):
        tf.init_decode_state(params, cfg, 1, 16)
    with pytest.raises(NotImplementedError, match="hybrid_moe"):
        tf.decode_step(params, cfg, {"lengths": lengths}, torch.zeros((1, 1), dtype=torch.long))


def _published_depth():
    """The published 40 layers and attention layers, at the reduced widths,
    with 12 experts so that top-10 routes as published."""
    cfg = get_config(NAME)
    return dataclasses.replace(cfg.reduced(), num_layers=cfg.num_layers,
                               attention_layers=cfg.attention_layers, num_experts=12,
                               experts_per_token=cfg.experts_per_token)


def test_one_forward_records_its_spans_and_counts():
    cfg = _published_depth()
    params = tf.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    spans.clear()
    spans.enable()
    try:
        tf.forward(params, cfg, toks, tf.ModelOptions(moe_impl="ep"))
    finally:
        spans.disable()
    ((root, kids),) = spans.steps(spans.records(), "forward")
    names = [k["name"] for k in kids]
    assert [names.count(n) for n in ("forward.mamba", "forward.attention", "forward.moe")] \
        == [36, 4, 40]
    assert root["attrs"]["host_syncs"] == 40
    assert root["attrs"]["ssd_tokens"] == 36 * 2 * 20
    assert all(k["parent"] == root["id"] for k in kids)
    assert all(k["attrs"]["host_syncs"] == 1 for k in kids if k["name"] == "forward.moe")


def test_the_ep_path_keeps_every_assignment_and_is_the_published_router(monkeypatch):
    """With one shard the capacity keeps each of the tokens' 10 assignments in
    each of the 40 layers; and the renormalised top-k is the reference's
    softmax over the top-k logits (to the 1e-9 in its denominator)."""
    cfg = _published_depth()
    params = tf.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    B, T = 2, 37
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(2))
    kept = []
    grouped = moe_lib._grouped_ffn

    def counting(xe, w_gate, w_up, w_down, group_sizes, **kw):
        kept.append(int(group_sizes.sum()))
        return grouped(xe, w_gate, w_up, w_down, group_sizes, **kw)

    monkeypatch.setattr(moe_lib, "_grouped_ffn", counting)
    tf.forward(params, cfg, toks, tf.ModelOptions(moe_impl="ep"))
    assert sum(kept) == B * T * cfg.experts_per_token * cfg.num_layers
    layer = {k: v[0] for k, v in params["stack"]["moe"].items()}
    x = torch.randn((B, T, cfg.d_model), generator=torch.Generator().manual_seed(3))
    out, _ = moe_lib.moe_layer(layer, x, cfg, impl="ep")
    model = {"num_experts_per_tok": cfg.experts_per_token, "num_local_experts": cfg.num_experts}
    want = granite._moe(x.reshape(-1, cfg.d_model).double(),
                        {k: v.double() for k, v in layer.items()}, model,
                        granite.Precision("fp64"))
    assert relative(out.reshape(-1, cfg.d_model), want) < TOL


def _same_structure(tree, axes, path="") -> None:
    """Every leaf of `tree` has a logical-axis tuple of its rank in `axes`."""
    assert isinstance(axes, dict) == isinstance(tree, dict), path
    if isinstance(tree, dict):
        assert set(tree) == set(axes), (path, set(tree) ^ set(axes))
        for key in tree:
            _same_structure(tree[key], axes[key], f"{path}.{key}")
    else:
        assert len(axes) == tree.dim(), (path, axes, tuple(tree.shape))


def test_logical_axes_mirror_the_tree_and_the_caches():
    cfg = get_config(NAME)
    _same_structure(tf.init_params(None, cfg, device="meta"), tf.param_axes(cfg))
    model, tiny, w, toks = _tiny(9)
    _, _, caches = tf.forward(w, tiny, toks[:, :40], collect_kv=True)
    _same_structure(caches["mamba"], tf.prefill_cache_axes(cfg)["mamba"])
    assert len(tf.prefill_cache_axes(cfg)["kv"]) == len(caches["kv"]) == 2


@pytest.mark.cuda
def test_cuda_grouped_experts_match_the_loop():
    """The bf16 grouped product on the card (no host copy) against the loop
    over the experts, at granite's expert widths with empty groups and rows
    past the groups: the same bf16 products summed in another order, so to
    bf16's rounding (2e-2 of the largest output), and zeros past the groups;
    with every row in a group, the same numbers. The gradients of x and of
    the weights through the grouped product against the loop's, to the same
    rounding of their largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    E, D, F, C = 72, 4096, 768, 3000
    w = [torch.randn(shape, generator=g, device="cuda").mul_(0.02).bfloat16()
         for shape in ((E, D, F), (E, D, F), (E, F, D))]
    xe = torch.randn((C, D), generator=g, device="cuda").bfloat16()
    sizes = torch.randint(0, 70, (E,), generator=g, device="cuda")
    sizes[::7] = 0
    got = moe_lib._grouped_ffn(xe, *w, sizes)
    want = moe_lib._looped_ffn(xe, *w, sizes)
    n = int(sizes.sum())
    assert n < C and bool((got[n:] == 0).all()) and bool((want[n:] == 0).all())
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    whole = moe_lib._grouped_ffn(xe[:n], *w, sizes, every_row=True)
    assert torch.equal(whole, got[:n])

    def grads(ffn):
        leaves = [t.detach().clone().requires_grad_() for t in (xe[:n], *w)]
        ffn(*leaves, sizes).float().square().sum().backward()
        return [t.grad.float() for t in leaves]

    for a, b in zip(grads(moe_lib._grouped_ffn), grads(moe_lib._looped_ffn), strict=True):
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())
