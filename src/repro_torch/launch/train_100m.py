"""End-to-end run: train a ~100M-param gemma3-family model on synthetic
data, with checkpointing, restart and ZeRO-1 sharded optimizer state.

The port of ``examples/train_100m.py``: the same narrowed gemma3, data,
hyperparameters and loop. The ranks of the process group form a (ranks, 1)
``("data", "model")`` mesh: the parameters replicate (``train_dp_all``) and
the AdamW state shards over every rank (``train_zero1``). With no
``WORLD_SIZE`` in the environment the script makes a one-rank group of its
own (a file rendezvous, no network), so the sharded path always runs. A
checkpoint left in ``--ckpt-dir`` is resumed (the restart).

    python -m repro_torch.launch.train_100m --steps 300            # the card
    python -m repro_torch.launch.train_100m --steps 3 --device cpu
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train_100m --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.distributed import axis_rules, named_sharding
from repro_torch.distributed.sharding import device_put
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import init_group, make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainLoopConfig, run
from repro_torch.tree import leaves, tree_map

RULES = "train_dp_all"            # params replicated; state under train_zero1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train100m"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-init", default=None,
                    help="rendezvous for a torchrun-style group (default env://)")
    args = ap.parse_args(argv)

    init = args.dist_init or ("env://" if "WORLD_SIZE" in os.environ else
                              f"file://{tempfile.mkdtemp()}/rdv")
    dev = init_group(resolve_device(args.device), init)
    mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"), device_type=dev.type)
    lead = dist.get_rank() == 0

    # ~100M params: gemma3-1b family, narrowed
    cfg = dataclasses.replace(
        get_config("gemma3-1b"),
        num_layers=6, d_model=512, num_heads=4, num_kv_heads=1, head_dim=64,
        d_ff=2048, vocab_size=32768, sliding_window=128, global_every=3,
        dtype="float32", param_dtype="float32",
    )
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    n = sum(int(x.numel()) for x in leaves(params))
    if lead:
        print(f"model: {n/1e6:.1f}M params ({cfg.num_layers}L d={cfg.d_model})")

    hp = adamw.OptimizerConfig(learning_rate=3e-3, warmup_steps=20,
                               decay_steps=args.steps)
    params = tree_map(device_put, params, sp.param_shardings(cfg, mesh, RULES))
    opt = tree_map(device_put, adamw.init_state(params, hp),
                   sp.opt_state_shardings(cfg, hp, mesh, RULES))
    step = make_train_step(cfg, tf.ModelOptions(), hp)

    def train_step(p, o, b):
        with axis_rules(mesh, RULES):
            return step(p, o, b)

    src = SyntheticTokens(cfg, batch=8, seq_len=128, seed=0)
    loader = PrefetchLoader(src, device=dev, sharding=named_sharding(
        ("batch", "seq"), mesh, RULES, shape=(8, 128)))

    def log(step_idx, metrics):
        if lead:
            print(f"step {step_idx:4d}  loss={metrics['loss']:.4f}  "
                  f"ce={metrics['ce']:.4f}  gnorm={metrics['grad_norm']:.2f}")

    try:
        result = run(
            train_step, params, opt, loader,
            TrainLoopConfig(total_steps=args.steps, ckpt_every=100,
                            ckpt_dir=args.ckpt_dir, log_every=20),
            metrics_cb=log,
        )
    finally:
        loader.close()
        dist.destroy_process_group()
    first = result["history"][0].loss
    last = result["history"][-1].loss
    if lead:
        print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps "
              f"({result['restarts']} restarts)")
    assert last < first, "training failed to reduce loss"
    return result


if __name__ == "__main__":
    main()
