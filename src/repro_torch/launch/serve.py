"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [options]``.

Runs the continuous-batching engine over the two-tier paged KV cache with the
selected promotion policy (paper Policy1/Policy2) and prints per-request outputs +
tier statistics. Runs on the card unless ``--device cpu`` is given; the REMOTE
tier is then pinned host memory, so preempted pages really cross PCIe.
``--no-reduced`` serves the config at its full published width.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import emucxl as ecxl
from repro_torch.core.policy import make_policy
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServingEngine


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--policy", default="policy1")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> ServingEngine:
    """The engine `args` describe, with its requests submitted and not yet run."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("ssm", "hybrid") or not cfg.causal:
        raise SystemExit(f"{args.arch}: paged serving demo targets attention archs")
    device = resolve_device(args.device)

    lib = ecxl.default_instance()
    if not lib._initialized:
        lib.init(device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(gen, cfg, device=device)
    eng = ServingEngine(
        params, cfg, num_slots=args.slots, page_size=args.page_size,
        max_batch=args.max_batch,
        max_pages_per_seq=-(-(args.prompt_len + args.max_new) // args.page_size),
        policy=make_policy(args.policy), device=device,
    )
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        rid = eng.submit(list(rng.integers(0, cfg.vocab_size, args.prompt_len)),
                         max_new_tokens=args.max_new)
        print(f"submitted request {rid}")
    return eng


def main(argv: Optional[List[str]] = None) -> ServingEngine:
    args = parse_args(argv)
    eng = build(args)
    results = eng.run(max_steps=args.max_steps)
    for rid, toks in sorted(results.items()):
        print(f"request {rid}: generated {toks}")
    print("tier stats:", eng.tier_stats())
    return eng


if __name__ == "__main__":
    main()
