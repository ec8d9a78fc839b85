"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [options]``.

The port of ``repro/launch/train.py``: configs, synthetic data through the
prefetching loader, the AdamW step, the fault-tolerant loop and
checkpointing. It runs on the card; ``--device cpu`` runs on the
CPU, with ``--reduced`` for a small config. It keeps the reference's flags;
a mesh other than ``1x1`` or other sharding rules need the multi-device
layer (ROADMAP A.10).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainLoopConfig, run

DEFAULT_RULES = "train_fsdp"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="e.g. 2x4 => (data=2, model=4)")
    ap.add_argument("--rules", default=DEFAULT_RULES)
    ap.add_argument("--moe-impl", default="ep")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh != "1x1" or args.rules != DEFAULT_RULES:
        raise NotImplementedError(
            f"--mesh {args.mesh} --rules {args.rules}: a device mesh and sharding rules "
            f"are not ported yet (ROADMAP A.10); the port trains on one device")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    hp = adamw.OptimizerConfig(learning_rate=args.lr, warmup_steps=10,
                               decay_steps=args.steps)

    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    opt = adamw.init_state(params, hp)
    opts = tf.ModelOptions(moe_impl=args.moe_impl)
    step = make_train_step(cfg, opts, hp, grad_accum=args.grad_accum)
    src = SyntheticTokens(cfg, args.batch, args.seq, seed=0)
    loader = PrefetchLoader(src, device=dev)

    def log(step_idx, metrics):
        print(f"step {step_idx:5d} loss={metrics['loss']:.4f} "
              f"gnorm={metrics['grad_norm']:.3f} lr={metrics['lr']:.2e}")

    try:
        result = run(
            step, params, opt, loader,
            TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                            ckpt_dir=args.ckpt_dir, log_every=10),
            metrics_cb=log,
        )
    finally:
        loader.close()
    hist = result["history"]
    print(f"done: {len(hist)} steps, restarts={result['restarts']}, "
          f"stragglers={result['straggler_events']}, "
          f"final loss={hist[-1].loss:.4f}")
    return result


if __name__ == "__main__":
    main()
