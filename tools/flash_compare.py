"""Flash attention's kernel times from two trees of this repository, on one card, in turns.

    python3 tools/flash_compare.py TREE [TREE ...] [--prefill ARCH:FLASH_PER_FORWARD ...]

For each TREE in the order given (e.g. ``parent . . parent``, the parent
unpacked with ``git archive`` into a git-ignored directory), a process of its
own imports that tree's ``chip_smoke.py`` and runs its phases ``card`` (the
kernels built from that tree's sources, ptxas's report) and
``prefill_timings`` (the flash kernel, its plain version and SDPA at the
path shapes, L2 flushed before each call), then each ``--prefill`` model
through ``prefill_path`` (its full-width prefill, with a profile of one
forward). The last line is a JSON object: each turn's tree and its flash
rows. Needs one CUDA card; every process is waited for.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import importlib.util, json, sys, torch
tree, prefill = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, tree + "/src")
spec = importlib.util.spec_from_file_location("chip_smoke", tree + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smoke.card()
flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
rows = smoke.prefill_timings(flush)
del flush
for arch, per_forward in prefill:
    smoke.prefill_path(arch, {"flash_attention": per_forward})
print("TURN " + json.dumps({k: v for k, v in rows.items() if not k.startswith(("ssd", "wkv"))}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="repository roots, one turn each, in this order")
    ap.add_argument("--prefill", nargs="*", default=[],
                    help="ARCH:FLASH_PER_FORWARD, e.g. deepseek-coder-33b:62")
    args = ap.parse_args(argv)
    prefill = [(a.split(":")[0], int(a.split(":")[1])) for a in args.prefill]
    turns = []
    for i, tree in enumerate(args.trees, 1):
        root = str(Path(tree).resolve())
        print(f"== turn {i}: {root}", flush=True)
        proc = subprocess.run([sys.executable, "-c", TURN, root, json.dumps(prefill)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        rows = None
        for line in proc.stdout.splitlines():
            if line.startswith("TURN "):
                rows = json.loads(line[5:])
            else:
                print(line)
        if proc.returncode != 0 or rows is None:
            print(f"flash_compare: turn {i} ({root}) failed with exit code {proc.returncode}")
            return 1
        turns.append({"tree": root, "rows": rows})
    labels = list(turns[0]["rows"])
    print("shape " + " ".join(f"turn{i}_ms" for i in range(1, len(turns) + 1)) + " sdpa_ms")
    for label in labels:
        times = " ".join(f"{t['rows'][label]['ms']:.4f}" for t in turns)
        print(f"{label} {times} {turns[0]['rows'][label]['library_ms']:.4f}")
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
