"""The Mamba2 SSD kernel's times from several trees of this repository, on one card, in turns.

    python3 tools/ssd_compare.py TREE [TREE ...]

For each TREE in the order given (e.g. ``parent . . parent``, the parent
unpacked with ``git archive`` into a git-ignored directory), a process of its
own imports that tree's ``chip_smoke.py``, builds the kernels from that
tree's sources (phase ``card``, ptxas's report) and times the SSD kernel with
that tree's ``time_ms`` (the median of 30 calls' CUDA-event times, L2
flushed before each) at zamba2-1.2b's shape (B2 T2048 H64 P64 N64) and, where
the tree's kernel takes a state of 128, at granite-4.0-h-small's heads (B1
H128 P64 N128) over 4096 and 32768 tokens, all bf16 at chunk 32, beside the
bound ``ssd_bounds_ms`` gives. The last line is a JSON object: each turn's
tree and its rows. Needs one CUDA card; every process is waited for.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import importlib.util, json, sys, torch
tree = sys.argv[1]
sys.path.insert(0, tree + "/src")
spec = importlib.util.spec_from_file_location("chip_smoke", tree + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from repro_torch.kernels.mamba2_ssd import mamba2_ssd as kernel
from repro_torch.kernels.mamba2_ssd.ops import ssd
smoke.card()
flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
shapes = {"zamba2": (2, 2048, 64, 64, 64)}
if getattr(kernel, "MAX_STATE", 64) >= 128:
    shapes.update(granite_4k=(1, 4096, 128, 64, 128), granite_32k=(1, 32768, 128, 64, 128))
rows = {}
for label, shape in shapes.items():
    args = smoke.ssd_inputs(*shape, torch.bfloat16, seed=201)
    ms = smoke.time_ms(lambda: ssd(*args, impl="pallas"), flush)
    bound, by = smoke.larger(*smoke.ssd_bounds_ms(*shape, 32, 2))
    rows[label] = {"shape": shape, "ms": ms, "bound_ms": bound, "bound_by": by}
    print(f"  ssd {label} B{shape[0]} T{shape[1]} H{shape[2]} P{shape[3]} N{shape[4]}: "
          f"{ms:.4f} ms, {by} bound {bound:.4f} ms", flush=True)
    del args
print("TURN " + json.dumps(rows))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="repository roots, one turn each, in this order")
    args = ap.parse_args(argv)
    turns = []
    for i, tree in enumerate(args.trees, 1):
        root = str(Path(tree).resolve())
        print(f"== turn {i}: {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", TURN, root], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        rows = None
        for line in proc.stdout.splitlines():
            if line.startswith("TURN "):
                rows = json.loads(line[5:])
            else:
                print(line)
        if proc.returncode != 0 or rows is None:
            print(f"ssd_compare: turn {i} ({root}) failed with exit code {proc.returncode}")
            return 1
        turns.append({"tree": root, "rows": rows})
    for label in turns[0]["rows"]:
        times = " ".join(f"{t['rows'][label]['ms']:.4f}" if label in t["rows"] else "-"
                         for t in turns)
        print(f"{label} {times} bound {turns[0]['rows'][label]['bound_ms']:.4f}")
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
