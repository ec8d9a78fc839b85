"""Multi-process runs of the port's multi-device layer, for the mesh tests.

    python tests/_torch_mesh_runs.py <scenario> <out_dir>

Each scenario spawns its ranks with ``torch.multiprocessing`` (gloo, a
``file://`` rendezvous in `out_dir`, one thread a rank) or, for ``bytes``,
runs one process on a fake group of the production size; rank 0 writes
``<out_dir>/<scenario>.json`` (and ``.npz`` where tensors come back). The
tests (``tests/test_torch_{sharding,distributed,elastic}.py``) run these in a
subprocess with a timeout and assert on what they wrote. Nothing here
imports JAX: the reference's side is computed by the tests.
"""

from __future__ import annotations

import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

ARCH = "olmoe-1b-7b"
WORLD = 8


def _init(rank: int, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'rdv'}",
                            rank=rank, world_size=WORLD)


def _place(tree, shardings):
    from repro_torch.distributed.sharding import device_put
    from repro_torch.tree import tree_map

    return tree_map(device_put, tree, shardings)


def _full(x):
    from repro_torch.distributed.sharding import full_tensor

    return full_tensor(x) if hasattr(x, "placements") else x


def _clone(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


# ------------------------------------------------------------------ train
def _train(rank: int, out: Path) -> None:
    """The 8-rank (2, 4) train step against the 1-process step."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.distributed import axis_rules, named_sharding
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import _value_and_grad, make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    cfg = get_config(ARCH).reduced()
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    src = SyntheticTokens(cfg, batch=8, seq_len=32, seed=0)
    batch = lambda i: {k: torch.from_numpy(v) for k, v in src.batch_at(i).items()}  # noqa: E731
    res = {}

    def on_mesh(rules, hp, impl):
        p = _place(_clone(params), sp.param_shardings(cfg, mesh, rules))
        o = _place(adamw.init_state(p, hp), sp.opt_state_shardings(cfg, hp, mesh, rules))
        b_sh = named_sharding(("batch", "seq"), mesh, rules, shape=(8, 32))
        step = make_train_step(cfg, tf.ModelOptions(moe_impl=impl), hp)

        def run(p, o, i):
            b = {k: _place(v, b_sh) for k, v in batch(i).items()}
            with axis_rules(mesh, rules):
                return step(p, o, b)
        return p, o, run, b_sh

    def plain_step(hp, impl):
        p = _clone(params)
        step = make_train_step(cfg, tf.ModelOptions(moe_impl=impl), hp)
        return step(p, adamw.init_state(p, hp), batch(0))

    # dense, train_fsdp: loss, every gradient leaf, the parameters after a step
    hp = adamw.OptimizerConfig(learning_rate=5e-3, warmup_steps=2)
    opts = tf.ModelOptions(moe_impl="dense")
    loss_of = lambda pp, bb: tf.loss_fn(pp, cfg, bb, opts)  # noqa: E731
    (l1, _), g1 = _value_and_grad(loss_of, params, batch(0))
    p, o, run, b_sh = on_mesh("train_fsdp", hp, "dense")
    with axis_rules(mesh, "train_fsdp"):
        b0 = {k: _place(v, b_sh) for k, v in batch(0).items()}
        (lm, _), gm = _value_and_grad(loss_of, p, b0)
    placed = all(tuple(g.placements) == tuple(q.placements)
                 for g, q in zip(leaves(gm), leaves(p), strict=True))
    gm = [_full(g) for g in leaves(gm)]
    p_ref, _, m_ref = plain_step(hp, "dense")
    p, o, m = run(p, o, 0)
    excess = 0.0
    for a, b, ga, gb in zip(leaves(p), leaves(p_ref), gm, leaves(g1), strict=True):
        bound = torch.clamp(hp.learning_rate * (ga - gb).abs() / hp.eps, min=5e-5)
        excess = max(excess, float(((_full(a) - b).abs() - bound).max()))
    res["dense"] = {
        "loss_mesh": float(_full(lm)), "loss_one": float(l1),
        "step_loss_mesh": float(_full(m["loss"])), "step_loss_one": float(m_ref["loss"]),
        "grad_err": max(float((a - b).abs().max()) for a, b in zip(gm, leaves(g1))),
        "grads_placed_like_params": placed,
        "param_excess_over_bound": excess,
        "placements": [str(tuple(q.placements)) for q in leaves(p)][:4],
    }

    # grad accumulation and remat on the mesh against the same on one process
    for label, accum, remat in (("grad_accum", 2, "none"), ("remat", 1, "full")):
        hp = adamw.OptimizerConfig(learning_rate=5e-3, warmup_steps=2)
        opts_k = tf.ModelOptions(moe_impl="dense", remat=remat)
        p = _place(_clone(params), sp.param_shardings(cfg, mesh, "train_fsdp"))
        o = _place(adamw.init_state(p, hp), sp.opt_state_shardings(cfg, hp, mesh, "train_fsdp"))
        with axis_rules(mesh, "train_fsdp"):
            b0 = {k: _place(v, b_sh) for k, v in batch(0).items()}
            p, o, m = make_train_step(cfg, opts_k, hp, grad_accum=accum)(p, o, b0)
        q = _clone(params)
        q, _, m1 = make_train_step(cfg, opts_k, hp, grad_accum=accum)(
            q, adamw.init_state(q, hp), batch(0))
        res[label] = {"loss_mesh": float(_full(m["loss"])), "loss_one": float(m1["loss"]),
                      "param_err": max(float((_full(a) - b).abs().max())
                                       for a, b in zip(leaves(p), leaves(q), strict=True))}

    # ep against dense on the mesh, then 30 ep steps
    hp = adamw.OptimizerConfig(learning_rate=5e-3, warmup_steps=2)
    p, o, run, _ = on_mesh("train_fsdp", hp, "dense")
    l_dense = float(_full(run(p, o, 0)[2]["loss"]))
    p, o, run, _ = on_mesh("train_fsdp", hp, "ep")
    losses = []
    for i in range(30):
        p, o, m = run(p, o, i)
        losses.append(float(_full(m["loss"])))
    res["ep"] = {"l_dense": l_dense, "losses": losses}

    # train_dp_all with ZeRO-1 state in the host tier
    hp = adamw.OptimizerConfig(learning_rate=5e-3, warmup_steps=2, offload_state=True)
    p, o, run, _ = on_mesh("train_dp_all", hp, "dense")
    state_spec = str(tuple(o["m"]["stack"]["attn"]["wq"].placements))
    p, o, m = run(p, o, 0)
    p_ref, _, m_ref = plain_step(hp, "dense")
    res["zero1"] = {
        "loss_mesh": float(_full(m["loss"])), "loss_one": float(m_ref["loss"]),
        "param_err": max(float((_full(a) - b).abs().max())
                         for a, b in zip(leaves(p), leaves(p_ref), strict=True)),
        "state_placements": state_spec,
        "param_placements": str(tuple(p["stack"]["attn"]["wq"].placements)),
    }
    if rank == 0:
        (out / "train.json").write_text(json.dumps(res))


# ------------------------------------------------------------------ moe
def _moe(rank: int, out: Path) -> None:
    """moe_layer's mesh variants on (2, 4) over the reference's inputs."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import axis_rules, named_sharding
    from repro_torch.models import moe as t_moe
    from repro_torch.models import transformer as tf

    cfg = get_config(ARCH).reduced()
    mesh = make_mesh_cpu((2, 4))
    data = np.load(out / "moe_in.npz")
    axes = tf.param_axes(cfg)["stack"]["moe"]
    rules = "train_fsdp"
    p = {k: _place(torch.from_numpy(data[k]),
                   named_sharding(axes[k][1:], mesh, rules, shape=data[k].shape))
         for k in axes}
    x = torch.from_numpy(data["x"])
    x = _place(x, named_sharding(("batch", "seq", "embed"), mesh, rules, shape=x.shape))
    got = {}
    with axis_rules(mesh, rules):
        for impl in ("ep", "ep_ff", "ep_exact", "ep_ff_exact"):
            y, aux = t_moe.moe_layer(p, x, cfg, impl=impl)
            got[f"{impl}_out"] = _full(y).numpy()
            got[f"{impl}_aux"] = _full(aux).numpy()
    if rank == 0:
        np.savez(out / "moe.npz", **got)


def make_mesh_cpu(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, device_type="cpu")


# ------------------------------------------------------------------ restore + psum
def write_checkpoint(directory: Path) -> None:
    """Step 1 of a 1-process checkpoint of reduced olmoe's parameters and
    AdamW state after one step, as ``_restore`` reads it back."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    cfg = get_config(ARCH).reduced()
    hp = adamw.OptimizerConfig()
    params = tf.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticTokens(cfg, batch=4, seq_len=16, seed=3).batch_at(0).items()}
    step = make_train_step(cfg, tf.ModelOptions(moe_impl="dense"), hp)
    params, opt, _ = step(params, adamw.init_state(params, hp), batch)
    CheckpointManager(str(directory), async_save=False).save(
        1, {"params": params, "opt": opt}, block=True)


def _restore(rank: int, out: Path) -> None:
    """restore(shardings=) onto (2, 4); a save from the mesh writes the same
    files."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as sp
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves_with_path, tree_map

    cfg = get_config(ARCH).reduced()
    mesh = make_mesh_cpu((2, 4))
    hp = adamw.OptimizerConfig()
    template = {"params": tf.init_params(None, cfg, device="meta")}
    template["opt"] = sp.opt_state_specs(cfg, hp)
    template = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), template)
    shardings = {"params": sp.param_shardings(cfg, mesh, "train_fsdp"),
                 "opt": sp.opt_state_shardings(cfg, hp, mesh, "train_fsdp")}
    mgr = CheckpointManager(str(out / "ckpt"))
    back = mgr.restore(1, template, shardings=shardings)
    plain = mgr.restore(1, template)
    res = {"restored_equal": all(
        torch.equal(_full(a), b) for (_, a), (_, b)
        in zip(leaves_with_path(back), leaves_with_path(plain), strict=True)),
        "sharded_leaves": sum(1 for _, a in leaves_with_path(back)
                              if any(pl.is_shard() for pl in a.placements))}
    again = CheckpointManager(str(out / "ckpt_mesh"), async_save=False)
    again.save(1, back, block=True)
    dist.barrier()
    if rank == 0:
        (out / "restore.json").write_text(json.dumps(res))


def _psum(rank: int, out: Path) -> None:
    """psum_compressed over all 8 ranks and over the model axis of (2, 4)."""
    from repro_torch.distributed import axis_rules, compression

    mesh = make_mesh_cpu((2, 4))
    rng = np.random.default_rng(100 + rank)
    g = {"w": torch.from_numpy((rng.standard_normal(300) * 0.01).astype(np.float32)),
         "b": torch.from_numpy((rng.standard_normal((4, 5)) * 0.1).astype(np.float32))}
    np.savez(out / f"grad_{rank}.npz", **{k: v.numpy() for k, v in g.items()})
    flat = make_mesh_cpu((8,), ("data",))
    for name, m, axis in (("all8", flat, "data"), ("model4", mesh, "model")):
        with axis_rules(m, "train_fsdp"):
            red, err = compression.psum_compressed(g, axis)
        np.savez(out / f"psum_{name}_{rank}.npz", **{k: v.numpy() for k, v in red.items()},
                 **{f"err_{k}": v.numpy() for k, v in err.items()})


# ------------------------------------------------------------------ bytes
def _bytes(out: Path) -> None:
    """Per-device bytes of params and optimizer state on the 16x16 mesh of a
    fake 256-rank group, placed by the specs."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import device_put
    from repro_torch.launch import dryrun, specs as sp
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.tree import tree_map

    dryrun.fake_group(256)
    mesh = make_production_mesh(device_type="cpu")
    res = {}
    for arch in json.loads((out / "bytes_in.json").read_text()):
        cfg = get_config(arch)
        rules = sp.rules_for(cfg, SHAPES["train_4k"])
        hp = dryrun.default_hp(cfg)
        p = tree_map(device_put, sp.params_specs(cfg), sp.param_shardings(cfg, mesh, rules))
        o = tree_map(device_put, sp.opt_state_specs(cfg, hp),
                     sp.opt_state_shardings(cfg, hp, mesh, rules))
        res[arch] = {"rules": rules, "params": dryrun._local_bytes(p),
                     "opt": dryrun._local_bytes(o)}
    dist.destroy_process_group()
    (out / "bytes.json").write_text(json.dumps(res))


SCENARIOS = {"train": _train, "moe": _moe, "restore": _restore, "psum": _psum}


def _rank(rank: int, scenario: str, out: str) -> None:
    out = Path(out)
    _init(rank, out)
    try:
        SCENARIOS[scenario](rank, out)
    except Exception:
        (out / f"error_{scenario}_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    scenario, out_dir = sys.argv[1], sys.argv[2]
    if scenario == "bytes":
        _bytes(Path(out_dir))
    else:
        os.environ.setdefault("OMP_NUM_THREADS", "1")
        mp.spawn(_rank, args=(scenario, out_dir), nprocs=WORLD)
