"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [options]``.

The port of ``repro/launch/train.py``: configs, mesh + rules, synthetic data
through the prefetching loader, the AdamW step (offloaded state where
configured), the fault-tolerant loop and checkpointing. It runs on the card;
``--device cpu`` runs on the CPU, with ``--reduced`` for a small config.

``--mesh dxm`` lays the ranks out as (data=d, model=m). The launcher reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as ``torchrun`` or a spawned
group sets them, and makes the process group itself (NCCL on ``cuda``, gloo
on ``cpu``) from ``--dist-init`` (``env://`` by default, as ``torchrun``
provides; a ``file://`` path needs no network). ``d * m`` must equal the
world size. ``--mesh 1x1`` with no ``WORLD_SIZE`` runs on one device
without a process group, where the rules have nothing to shard.

    torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch olmoe-1b-7b --reduced --device cpu --mesh 2x4 --steps 3
"""

from __future__ import annotations

import argparse
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
from repro_torch.tree import tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="e.g. 2x4 => (data=2, model=4)")
    ap.add_argument("--rules", default="train_fsdp")
    ap.add_argument("--moe-impl", default="ep")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-init", default="env://",
                    help="process-group rendezvous: env:// (torchrun) or file://<path>")
    return ap.parse_args(argv)


def _mesh(args, dev: torch.device):
    """The (data, model) mesh over a process group this launcher makes, or
    None for a 1x1 mesh with no ``WORLD_SIZE`` (one device, no group)."""
    d, m = (int(x) for x in args.mesh.split("x"))
    world = os.environ.get("WORLD_SIZE")
    if (d, m) == (1, 1) and world is None:
        return None, dev
    world = int(world or 1)
    if d * m != world:
        raise ValueError(f"--mesh {args.mesh} needs {d * m} ranks; WORLD_SIZE is {world}")
    dev = init_group(dev, args.dist_init)
    return make_mesh((d, m), ("data", "model"), device_type=dev.type), dev


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mesh, dev = _mesh(args, dev)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    hp = adamw.OptimizerConfig(learning_rate=args.lr, warmup_steps=10,
                               decay_steps=args.steps)
    # every rank draws the same parameters from one seed
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    opts = tf.ModelOptions(moe_impl=args.moe_impl)
    step = make_train_step(cfg, opts, hp, grad_accum=args.grad_accum)
    sharding = None
    if mesh is None:
        opt = adamw.init_state(params, hp)
        train_step = step
    else:
        params = tree_map(device_put, params, sp.param_shardings(cfg, mesh, args.rules))
        opt = tree_map(device_put, adamw.init_state(params, hp),
                       sp.opt_state_shardings(cfg, hp, mesh, args.rules))
        sharding = named_sharding(("batch", "seq"), mesh, args.rules,
                                  shape=(args.batch, args.seq))

        def train_step(p, o, b):
            with axis_rules(mesh, args.rules):
                return step(p, o, b)

    src = SyntheticTokens(cfg, args.batch, args.seq, seed=0)
    loader = PrefetchLoader(src, device=dev, sharding=sharding)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    def log(step_idx, metrics):
        if lead:
            print(f"step {step_idx:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} lr={metrics['lr']:.2e}")

    try:
        result = run(
            train_step, params, opt, loader,
            TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                            ckpt_dir=args.ckpt_dir, log_every=10),
            metrics_cb=log,
        )
    finally:
        loader.close()
    hist = result["history"]
    if lead:
        print(f"done: {len(hist)} steps, restarts={result['restarts']}, "
              f"stragglers={result['straggler_events']}, "
              f"final loss={hist[-1].loss:.4f}")
    if mesh is not None:
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
