"""The port's training stack against the reference's, on the CPU.

Each check replays a case of tests/test_training.py, or holds a ported
function against its reference counterpart on the same inputs:

| check | tolerance |
| --- | --- |
| ``loss_fn`` and every gradient leaf, seven reduced models | loss 1e-5; leaf 1e-4 of its max (zamba2: see below) |
| ``remat`` "full" and "offload" against "none" | 1e-6 |
| ``apply_update`` / ``clip_by_global_norm`` against the reference's | 1e-6 |
| ``grad_accum=4`` against the full batch | 5e-5 |
| loss decrease on reduced gemma3-1b, and its curve against the reference's | the reference's bar; 1e-3 |
| checkpoint restart, fault recovery, cross-package checkpoints | bitwise |
| compression, ``SyntheticTokens`` | ``==`` |

zamba2's SSD makes its gradients sensitive to summation order (ROADMAP C.4):
the reference's own chunked and sequential SSD paths differ by up to 1.9e-3
of a leaf's magnitude on this input, so each leaf is held to three times
that spread, the distance a third evaluation of the same fp32 arithmetic
may add.

In-place updates (ROADMAP C.6): the port's ``apply_update`` updates its
inputs, so a run that must start again from the same state starts from a
copy.
"""

import filecmp
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as r_configs
import repro.models.transformer as r_tf
from repro.checkpoint import ckpt as r_ckpt
from repro.data.synthetic import SyntheticTokens as RSyntheticTokens
from repro.distributed import compression as r_comp
from repro.launch.steps import make_train_step as r_make_train_step
from repro.optim import adamw as r_adamw
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import emucxl as t_ecxl
from repro_torch.core.offload import OffloadPolicy
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.distributed import compression
from repro_torch.interop import from_reference, opt_state_from_reference
from repro_torch.launch import train as t_train
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import SimulatedFault, TrainLoopConfig, run
from repro_torch.tree import leaves, leaves_with_path, tree_map

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_models(arch):
    cfg_r = r_configs.get_config(arch).reduced()
    params_r = r_tf.init_params(jax.random.PRNGKey(0), cfg_r)
    cfg_t = get_config(arch).reduced()
    params_t = from_reference(jax.tree.map(np.asarray, params_r), cfg_t, device=CPU)
    return cfg_r, params_r, cfg_t, params_t


def _port_grads(params, cfg, batch, opts):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = tf.loss_fn(live, cfg, batch, opts)
    grads = torch.autograd.grad(loss, leaves(live))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _ref_grads(params, cfg, batch, opts):
    f = jax.jit(jax.value_and_grad(lambda p, b: r_tf.loss_fn(p, cfg, b, opts), has_aux=True))
    (loss, metrics), grads = f(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, metrics, [np.asarray(g) for g in jax.tree.leaves(grads)]


def _rel_errors(ref_leaves, port_leaves):
    return [float(np.abs(a - b.numpy()).max() / max(np.abs(a).max(), 1e-30))
            for a, b in zip(ref_leaves, port_leaves, strict=True)]


# ------------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("arch,moe_impl", [
    ("gemma3-1b", "ep"), ("internvl2-1b", "ep"), ("olmoe-1b-7b", "dense"),
    ("olmoe-1b-7b", "ep"), ("zamba2-1.2b", "ep"), ("rwkv6-3b", "ep"),
    ("hubert-xlarge", "ep")])
def test_loss_and_grads_match_reference(arch, moe_impl):
    cfg_r, params_r, cfg_t, params_t = _ref_models(arch)
    batch = RSyntheticTokens(cfg_r, 2, 16, seed=1).batch_at(0)
    if arch == "hubert-xlarge":          # frame targets with weights
        batch["weights"] = (np.random.default_rng(0).random((2, 16)) < 0.7).astype(np.float32)
    opts_r = r_tf.ModelOptions(moe_impl=moe_impl)
    loss_r, metrics_r, grads_r = _ref_grads(params_r, cfg_r, batch, opts_r)
    loss_t, metrics_t, grads_t = _port_grads(params_t, cfg_t, _tensors(batch),
                                             tf.ModelOptions(moe_impl=moe_impl))
    assert abs(float(loss_t) - float(loss_r)) < 1e-5
    for k in ("ce", "aux", "z_loss"):
        assert abs(float(metrics_t[k]) - float(metrics_r[k])) < 1e-5, k
    if cfg_t.moe:
        assert float(metrics_t["aux"]) > 0
    errs = _rel_errors(grads_r, grads_t)
    if arch == "zamba2-1.2b":
        _, _, grads_seq = _ref_grads(params_r, cfg_r, batch,
                                     r_tf.ModelOptions(ssd_impl="ref"))
        spread = _rel_errors(grads_r, [torch.from_numpy(g) for g in grads_seq])
        bounds = [max(1e-4, 3 * s) for s in spread]
    else:
        bounds = [1e-4] * len(errs)
    paths = [p for p, _ in leaves_with_path(params_t)]
    bad = [(p, e, b) for p, e, b in zip(paths, errs, bounds, strict=True) if e > b]
    assert bad == []


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "zamba2-1.2b", "rwkv6-3b"])
@pytest.mark.parametrize("remat", ["full", "offload"])
def test_remat_matches_no_remat(arch, remat):
    cfg = get_config(arch).reduced()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    batch = _tensors(SyntheticTokens(cfg, 2, 16, seed=3).batch_at(0))
    loss0, _, g0 = _port_grads(params, cfg, batch, tf.ModelOptions())
    before = OffloadPolicy.total_bytes
    loss1, _, g1 = _port_grads(params, cfg, batch, tf.ModelOptions(remat=remat))
    assert abs(float(loss1) - float(loss0)) <= 1e-6 * abs(float(loss0))
    assert max(_rel_errors([g.numpy() for g in g0], g1)) <= 1e-6
    # offload keeps each checkpointed layer's input in the host tier; the
    # reference's hybrid body takes no offload policy, and neither does the port's
    offloads = remat == "offload" and cfg.family != "hybrid"
    assert (OffloadPolicy.total_bytes > before) == offloads


# ------------------------------------------------------------------ optimizer
def _opt_trees(seed=0):
    g = np.random.default_rng(seed)
    params = {"w": g.standard_normal((7, 5)).astype(np.float32),
              "b": {"x": g.standard_normal(3).astype(np.float32)},
              "h": g.standard_normal(16).astype(np.float32)}
    grads = [tree_map(lambda a: (g.standard_normal(a.shape) * 3).astype(np.float32), params)
             for _ in range(3)]
    return params, grads


def _to_torch(tree, bf16_keys=()):
    out = tree_map(torch.from_numpy, tree)
    for k in bf16_keys:
        out[k] = out[k].to(torch.bfloat16)
    return out


def _to_jax(tree, bf16_keys=()):
    out = tree_map(jnp.asarray, tree)
    for k in bf16_keys:
        out[k] = out[k].astype(jnp.bfloat16)
    return out


def _assert_close(ref_tree, port_tree, tol):
    for a, b in zip(jax.tree.leaves(ref_tree), leaves(port_tree), strict=True):
        np.testing.assert_allclose(np.asarray(a, np.float32), b.float().numpy(),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("offload_state", [False, True])
def test_apply_update_matches_reference(offload_state):
    """Three AdamW steps through warm-up and the cosine, clipping on, one
    bf16 leaf with an fp32 master; the port starts from the reference's
    state carried across by ``opt_state_from_reference``."""
    hp_kw = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=6, grad_clip_norm=5.0)
    hp_r = r_adamw.OptimizerConfig(**hp_kw)
    hp_t = adamw.OptimizerConfig(offload_state=offload_state, **hp_kw)
    params, grads = _opt_trees()
    p_r = _to_jax(params, ["h"])
    st_r = r_adamw.init_state(p_r, hp_r)
    p_t = _to_torch(params, ["h"])
    st_t = opt_state_from_reference(jax.tree.map(np.asarray, st_r), CPU, pinned=offload_state)
    fresh = adamw.init_state(_to_torch(params, ["h"]), hp_t)
    _assert_close(st_r, fresh, 0.0)
    for g in grads:
        p_r, st_r, m_r = r_adamw.apply_update(p_r, _to_jax(g, ["h"]), st_r, hp_r)
        p_t, st_t, m_t = adamw.apply_update(p_t, _to_torch(g, ["h"]), st_t, hp_t)
        _assert_close(p_r, p_t, 1e-6)
        _assert_close(st_r, st_t, 1e-6)
        assert int(st_t["step"]) == int(st_r["step"])
        assert abs(float(m_t["lr"]) - float(m_r["lr"])) <= 1e-6 * float(m_r["lr"])
        assert abs(float(m_t["grad_norm"]) - float(m_r["grad_norm"])) <= \
            1e-6 * float(m_r["grad_norm"])
    assert p_t["h"].dtype == torch.bfloat16 and st_t["master"]["h"].dtype == torch.float32


def test_clip_by_global_norm_matches_reference():
    _, grads = _opt_trees(1)
    c_r, n_r = r_adamw.clip_by_global_norm(_to_jax(grads[0]), 1.0)
    c_t, n_t = adamw.clip_by_global_norm(_to_torch(grads[0]), 1.0)
    assert abs(float(n_t) - float(n_r)) <= 1e-6 * float(n_r)
    _assert_close(c_r, c_t, 1e-6)
    assert abs(float(adamw.global_norm(c_t)) - 1.0) < 1e-6


def test_adamw_matches_hand_rolled_step():
    """tests/test_training.py:104's one-step numpy reference."""
    hp = adamw.OptimizerConfig(learning_rate=0.1, b1=0.9, b2=0.99, eps=1e-8,
                               weight_decay=0.01, grad_clip_norm=1e9,
                               warmup_steps=0, decay_steps=1, min_lr_ratio=1.0)
    w = np.asarray([1.0, -2.0, 3.0], np.float32)
    g = np.asarray([0.1, 0.2, -0.3], np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    new_p, _, _ = adamw.apply_update(p, {"w": torch.from_numpy(g)}, adamw.init_state(p, hp), hp)
    m, v = 0.1 * g, 0.01 * g ** 2
    ref = w - 0.1 * ((m / 0.1) / (np.sqrt(v / 0.01) + 1e-8) + 0.01 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-5)


def test_grad_clip_fused():
    """tests/test_training.py:122."""
    hp = adamw.OptimizerConfig(grad_clip_norm=1.0, warmup_steps=0)
    p = {"w": torch.ones(4)}
    _, new_st, metrics = adamw.apply_update(p, {"w": torch.full((4,), 100.0)},
                                            adamw.init_state(p, hp), hp)
    assert float(metrics["grad_norm"]) > 100
    assert float(new_st["m"]["w"].abs().max()) < 0.1


# ------------------------------------------------------------------ train steps
def _setup(arch="internvl2-1b", lr=3e-3):
    cfg = get_config(arch).reduced()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    hp = adamw.OptimizerConfig(learning_rate=lr, warmup_steps=5, decay_steps=200)
    opt = adamw.init_state(params, hp)
    step = make_train_step(cfg, tf.ModelOptions(moe_impl="dense"), hp)
    return cfg, params, opt, step


def test_loss_decreases_and_follows_the_reference():
    """tests/test_training.py:28's bar on the port, and the port's loss curve
    against the reference's from the same parameters and batches."""
    cfg_r, params_r, cfg, params = _ref_models("gemma3-1b")
    hp_kw = dict(learning_rate=3e-3, warmup_steps=5, decay_steps=200)
    hp_r, hp = r_adamw.OptimizerConfig(**hp_kw), adamw.OptimizerConfig(**hp_kw)
    step_r = jax.jit(r_make_train_step(cfg_r, r_tf.ModelOptions(moe_impl="dense"), hp_r))
    step = make_train_step(cfg, tf.ModelOptions(moe_impl="dense"), hp)
    opt_r, opt = r_adamw.init_state(params_r, hp_r), adamw.init_state(params, hp)
    src = SyntheticTokens(cfg, batch=8, seq_len=32, seed=0)
    losses, losses_r = [], []
    for i in range(30):
        batch = src.batch_at(i)
        params, opt, metrics = step(params, opt, _tensors(batch))
        params_r, opt_r, metrics_r = step_r(params_r, opt_r,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
        losses_r.append(float(metrics_r["loss"]))
    assert losses[-1] < losses[0] - 0.5, f"no learning: {losses[0]:.3f}->{losses[-1]:.3f}"
    assert max(abs(a - b) for a, b in zip(losses, losses_r, strict=True)) < 1e-3


def test_grad_accum_matches_full_batch():
    """tests/test_training.py:40: grad_accum=4 against one big batch."""
    cfg = get_config("internvl2-1b").reduced()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    hp = adamw.OptimizerConfig(learning_rate=1e-3, warmup_steps=1)
    batch = _tensors(SyntheticTokens(cfg, batch=8, seq_len=16, seed=1).batch_at(0))
    opts = tf.ModelOptions(moe_impl="dense")
    outs = []
    for accum in (1, 4):
        p = _clone(params)
        outs.append(make_train_step(cfg, opts, hp, grad_accum=accum)(
            p, adamw.init_state(p, hp), batch))
    (p1, _, m1), (p4, _, m4) = outs
    assert max(float((a - b).abs().max()) for a, b in zip(leaves(p1), leaves(p4))) < 5e-5
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3


def test_checkpoint_restart_bitwise(tmp_path):
    """tests/test_training.py:57."""
    cfg, params, opt, step = _setup("internvl2-1b")
    src = SyntheticTokens(cfg, batch=4, seq_len=16, seed=2)
    p_ref, o_ref = _clone(params), _clone(opt)
    for i in range(6):
        p_ref, o_ref, _ = step(p_ref, o_ref, _tensors(src.batch_at(i)))
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    p, o = _clone(params), _clone(opt)
    for i in range(3):
        p, o, _ = step(p, o, _tensors(src.batch_at(i)))
    mgr.save(3, {"params": p, "opt": o}, block=True)
    restored = mgr.restore(3, {"params": p, "opt": o})
    p2, o2 = restored["params"], restored["opt"]
    for i in range(3, 6):
        p2, o2, _ = step(p2, o2, _tensors(src.batch_at(i)))
    for a, b in zip(leaves(p_ref), leaves(p2), strict=True):
        assert torch.equal(a, b)
    assert int(o2["step"]) == 6


def test_fault_recovery_restarts_from_checkpoint(tmp_path):
    """tests/test_training.py:85."""
    cfg, params, opt, step = _setup("internvl2-1b")
    loader = PrefetchLoader(SyntheticTokens(cfg, batch=4, seq_len=16, seed=3), device=CPU)
    faults = {12: True}

    def fault_hook(step_idx):
        if faults.pop(step_idx, False):
            raise SimulatedFault(f"injected at {step_idx}")

    try:
        result = run(step, params, opt, loader,
                     TrainLoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=str(tmp_path),
                                     log_every=100),
                     fault_hook=fault_hook)
    finally:
        loader.close()
    assert result["restarts"] == 1
    steps_seen = [e.step for e in result["history"]]
    assert 12 in steps_seen
    assert max(steps_seen) == 19


# ------------------------------------------------------------------ checkpoints across packages
def _mixed_tree():
    g = np.random.default_rng(4)
    return {"params": {"w": g.standard_normal((3, 4)).astype(np.float32),
                       "e": g.standard_normal((2, 5)).astype(np.float32)},
            "opt": {"step": np.asarray(7, np.int32),
                    "m": [g.standard_normal(6).astype(np.float32)]}}


def test_checkpoints_restore_across_packages(tmp_path):
    """A checkpoint the reference wrote restores bit for bit in the port, bf16
    leaves included, and the port writes the same files byte for byte. The
    reference's own restore casts a bf16 file with ``astype``, which numpy
    cannot do from raw two-byte records: it raises on either package's bf16
    files alike (ROADMAP C.8), and restores every other leaf of the port's."""
    tree = _mixed_tree()
    j_tree = jax.tree.map(jnp.asarray, tree)
    j_tree["params"]["e"] = j_tree["params"]["e"].astype(jnp.bfloat16)
    t_tree = tree_map(torch.from_numpy, tree)
    t_tree["params"]["e"] = t_tree["params"]["e"].to(torch.bfloat16)

    r_mgr = r_ckpt.CheckpointManager(str(tmp_path / "ref"), async_save=False)
    t_mgr = CheckpointManager(str(tmp_path / "port"), async_save=False)
    r_mgr.save(5, j_tree, extra={"data_step": 5}, block=True)
    t_mgr.save(5, t_tree, extra={"data_step": 5}, block=True)

    ref_dir, port_dir = tmp_path / "ref" / "step_000000005", tmp_path / "port" / "step_000000005"
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    npys = [n for n in names if n.endswith(".npy")]
    assert npys == ["opt__m__0.npy", "opt__step.npy", "params__e.npy", "params__w.npy"]
    match, mismatch, errors = filecmp.cmpfiles(ref_dir, port_dir, npys, shallow=False)
    assert (mismatch, errors) == ([], [])

    # the reference's checkpoint in the port: bitwise, bf16 read from its raw records
    template = tree_map(torch.zeros_like, t_tree)
    cross = CheckpointManager(str(tmp_path / "ref"), async_save=False)
    assert cross.latest_step() == 5 and cross.extra(5) == {"data_step": 5}
    restored = cross.restore(5, template)
    for a, b in zip(leaves(restored), leaves(t_tree), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)

    # the port's checkpoint in the reference
    r_cross = r_ckpt.CheckpointManager(str(tmp_path / "port"), async_save=False)
    fp32_only = {"params": {"w": j_tree["params"]["w"]}, "opt": j_tree["opt"]}
    back = r_cross.restore(5, fp32_only)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(fp32_only), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for mgr in (r_cross, r_mgr):
        with pytest.raises(ValueError, match="No cast function"):
            mgr.restore(5, j_tree)


def test_restore_places_leaves_like_the_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2, dtype=torch.bfloat16)}
    mgr.save(1, tree)
    tree["a"].add_(1.0)                # after the snapshot: not in the checkpoint
    mgr.save(2, tree)
    mgr.wait()
    assert mgr.steps() == [2]          # keep=1
    back = mgr.restore(2, {"a": torch.zeros(2, 3, dtype=torch.float64),
                           "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert back["a"].dtype == torch.float64 and torch.equal(back["a"].float(), tree["a"])
    # shardings naming no leaf place every leaf like the template
    again = mgr.restore(2, tree, shardings={})
    assert torch.equal(again["a"], tree["a"]) and torch.equal(again["b"], tree["b"])


# ------------------------------------------------------------------ compression
def test_compression_matches_reference_with_error_feedback():
    """int8 values, scales and the error feedback `==` the reference's over
    tests/test_training.py:131's 50 steps, and the same drift bar."""
    g_np = (np.random.default_rng(0).standard_normal(1000) * 0.01).astype(np.float32)
    g_r, g_t = {"w": jnp.asarray(g_np)}, {"w": torch.from_numpy(g_np)}
    err_r = err_t = None
    total_true, total_sent = np.zeros(1000), np.zeros(1000)
    for _ in range(50):
        qs_r, err_r = r_comp.compress_tree(g_r, err_r)
        qs_t, err_t = compression.compress_tree(g_t, err_t)
        assert np.array_equal(np.asarray(qs_r["w"][0]), qs_t["w"][0].numpy())
        assert np.asarray(qs_r["w"][1]) == qs_t["w"][1].numpy()
        assert np.array_equal(np.asarray(err_r["w"]), err_t["w"].numpy())
        deq = compression.decompress_tree(qs_t)
        assert np.array_equal(np.asarray(r_comp.decompress_tree(qs_r)["w"]), deq["w"].numpy())
        total_true += g_np
        total_sent += deq["w"].numpy()
    assert np.abs(total_true - total_sent).max() < 0.01 * 50 * 0.01
    cos = np.dot(total_true, total_sent) / (
        np.linalg.norm(total_true) * np.linalg.norm(total_sent))
    assert cos > 0.999
    assert qs_t["w"][0].dtype == torch.int8
    # the all-reduce runs over a mesh axis (tests/test_torch_distributed.py)
    with pytest.raises(ValueError, match="needs a mesh"):
        compression.psum_compressed(g_t, "data")


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["gemma3-1b", "internvl2-1b", "hubert-xlarge"])
def test_synthetic_batches_equal_the_reference(arch):
    cfg_r = r_configs.get_config(arch).reduced()
    cfg_t = get_config(arch).reduced()
    for seed, step in ((0, 0), (9, 5), (3, 17)):
        ref = RSyntheticTokens(cfg_r, 4, 16, seed=seed).batch_at(step)
        port = SyntheticTokens(cfg_t, 4, 16, seed=seed).batch_at(step)
        assert sorted(ref) == sorted(port)
        for k in ref:
            assert ref[k].dtype == port[k].dtype and np.array_equal(ref[k], port[k])


def test_prefetch_loader_stages_through_the_remote_tier():
    """tests/test_training.py:155 on the port's EmuCXL."""
    cfg = get_config("gemma3-1b").reduced()
    src = SyntheticTokens(cfg, 4, 16, seed=9)
    lib = t_ecxl.EmuCXL()
    lib.init(local_capacity=1 << 24, remote_capacity=1 << 26, device=CPU)
    loader = PrefetchLoader(src, lib=lib, device=CPU)
    try:
        batches = [loader.get() for _ in range(3)]
        assert loader.state()["step"] == 3
    finally:
        loader.close()
    assert batches[0]["inputs"].shape == (4, 16)
    for i, b in enumerate(batches):
        for k, v in src.batch_at(i).items():
            assert torch.equal(b[k], torch.from_numpy(v))
    assert lib.stats(1) > 0        # staging buffers live on the remote tier
    lib.exit()


# ------------------------------------------------------------------ steps and launcher
def test_prefill_and_serve_steps_wrap_forward_and_decode():
    cfg = get_config("gemma3-1b").reduced()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    opts = tf.ModelOptions()
    last, caches = make_prefill_step(cfg, opts)(params, tokens)
    with torch.no_grad():
        logits, _, _ = tf.forward(params, cfg, tokens, opts)
        state = tf.init_decode_state(params, cfg, 2, 8)
        want, _ = tf.decode_step(params, cfg, state, tokens[:, :1], opts)
    assert torch.allclose(last, logits[:, -1], atol=1e-5) and "kv" in caches
    nxt, new_state = make_serve_step(cfg, opts)(params, tf.init_decode_state(params, cfg, 2, 8),
                                                tokens[:, :1])
    assert nxt.dtype == torch.int32 and torch.equal(nxt, torch.argmax(want, -1).int())
    assert torch.equal(new_state["lengths"], torch.ones(2, dtype=torch.int32))


def test_train_launcher_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma3-1b",
         "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done: 3 steps, restarts=0" in proc.stdout
    assert (tmp_path / "step_000000003" / "manifest.json").exists()


def test_train_launcher_names_the_mesh_item(monkeypatch):
    """A mesh needs a process group of its size: 2x4 with no WORLD_SIZE, or
    another world size, raises before any group is made."""
    for world in (None, "4"):
        if world is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", world)
        with pytest.raises(ValueError, match="needs 8 ranks"):
            t_train.main(["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
                          "--mesh", "2x4"])
