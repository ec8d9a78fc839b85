"""The granite cell with the Mamba2 decay leaves at their published init, on
the card, several seeds in one process:

    python3 perfbench/checks/decay_init.py --workload granite-prefill-long \\
        --seconds <s> --seeds <a,b,...> [--state-tokens 4096]

The cell's draw (``lib/weights.py``) gives ``A_log``, ``dt_bias`` and ``D``
N(0, 0.02^2) like every other leaf: A ~ -1 and dt ~ softplus(N(0, 1.3^2)), a
decay of about 0.5 a token, so little state crosses a chunk of 32 and a
kernel that dropped the carried state would still compare well. Here the
three are overwritten after the draw, on both sides (the program and the
reference read the same tree), by the published Mamba2 init: A uniform in
[1, 16], dt log-uniform in [0.001, 0.1] through the inverse softplus, D = 1.

For each seed it runs the cell as the benchmark does (the window shortened to
``--seconds``) and prints the comparison's numbers (``logits_rel``,
``kv_rel``, ``top_gap``), then runs one prompt of ``--state-tokens`` tokens
through the program and the fp32 reference and prints the worst relative
error of the Mamba2 conv and SSD states over the layers, and of that call's
last logits. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def published_decay(mamba: dict, seed: int) -> None:
    """Overwrite the Mamba2 decay leaves of a drawn tree in place."""
    import torch

    A_log, dt_bias, D = mamba["A_log"], mamba["dt_bias"], mamba["D"]
    gen = torch.Generator(device=A_log.device).manual_seed(int(seed) ^ 0xDECA)
    A = torch.rand(A_log.shape, generator=gen, device=A_log.device) * 15 + 1
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand(dt_bias.shape, generator=gen, device=A_log.device) * (hi - lo) + lo)
    A_log.copy_(torch.log(A))
    dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))      # softplus^-1(dt)
    D.fill_(1.0)


def state_errors(cell, params, tokens: int) -> dict:
    """One prompt of `tokens` through the program (the cell's options) and the
    fp32 reference: the worst relative error of the conv and SSD states and
    of the last logits."""
    import torch

    from perfbench.lib import files
    from perfbench.reference.common import relative
    from repro_torch.models import transformer as tf

    arch = files.architecture(cell.model)
    cfg = cell.arch or cell.port_config()
    V = cell.model["vocab_size"]
    gen = torch.Generator(device=cell.device).manual_seed(int(cell.seed) + 1)
    toks = torch.randint(0, V, (tokens,), generator=gen, device=cell.device)
    opts = tf.ModelOptions(**cell.workload.get("model_options", {}))
    with torch.no_grad():
        logits, _, caches = tf.forward(params, cfg, toks[None], opts, collect_kv=True,
                                       last_only=True)
    slot = {layer: m for m, layer in enumerate(arch.mamba_layers(cell.model))}
    worst = {"conv_rel": 0.0, "ssd_rel": 0.0}

    def on_state(layer, _j, conv, ssd):
        m = slot[layer]
        worst["conv_rel"] = max(worst["conv_rel"],
                                relative(caches["mamba"]["conv"][m, 0].to(conv.device), conv))
        worst["ssd_rel"] = max(worst["ssd_rel"],
                               relative(caches["mamba"]["ssd"][m, 0].to(ssd.device), ssd))

    (ref,) = arch.forward(params, cell.model, [toks], mode="fp32",
                          logits_at=[torch.tensor([tokens - 1], device=toks.device)],
                          on_state=on_state)
    worst["state_logits_rel"] = relative(logits[0, -1, :V], ref[0])
    return worst


def run(cell, state_tokens: int) -> dict:
    """The cell with the published decay init; the line's numbers."""
    from perfbench.lib import files, weights

    drawn = weights.draw

    def draw(model, seed, device):
        tree = drawn(model, seed, device)
        published_decay(tree["mamba"], seed)
        return tree

    weights.draw = draw
    try:
        driver = files.load_module("drivers", cell.traffic["kind"])
        rec = driver.run(cell)
    finally:
        weights.draw = drawn
    line = {"seed": cell.seed, "program": {c.name: c.value for c in rec.checks},
            "correct": rec.correct, "attempted": rec.attempted, "window_s": rec.window_s}
    line.update(state_errors(cell, rec.inputs["params"], state_tokens))
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--state-tokens", type=int, default=4096)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench.lib.cell import Cell

    if not torch.cuda.is_available():
        raise SystemExit("these readings are taken on the card")
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = Cell.load(args.workload, seed, args.seconds, False, "cuda", time.perf_counter())
        print(json.dumps(run(cell, args.state_tokens)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
