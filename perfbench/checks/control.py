"""Readings for the limits of ``correct``, on the card, several seeds in one
process: ``python3 perfbench/checks/control.py --workload <cell> --seconds <s>
--seeds <a,b,...> [--control <n>]``.

For each seed it runs the cell as the benchmark does (the window shortened to
``--seconds``) and prints the numbers the comparison decided by; for the first
``--control`` seeds it also prints the control's: the fp8 reference put in
the program's place, through the same comparison, and whether that comes out
correct (it must not). One JSON line a seed,
``{"seed", "program": {...}, "control": {...}, "control_correct"}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench.lib import files
    from perfbench.lib.cell import Cell, Record

    if not torch.cuda.is_available():
        raise SystemExit("control readings are taken on the card")
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        cell = Cell.load(args.workload, seed, args.seconds, False, "cuda", time.perf_counter())
        driver = files.load_module("drivers", cell.traffic["kind"])
        rec = driver.run(cell)
        line = {"seed": seed, "program": {c.name: c.value for c in rec.checks},
                "attempted": rec.attempted, "failed": rec.failed, "window_s": rec.window_s}
        if n < args.control:
            t0 = time.perf_counter()
            checks = driver.control(cell, rec)
            line["control"] = {c.name: c.value for c in checks}
            line["control_correct"] = Record(checks=checks).correct
            line["control_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
