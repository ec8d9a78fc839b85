"""The port's benchmark: one run of one cell on the card it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``perfbench/workloads/<cell>.json`` and its
configuration, traffic mix and driver kind from the files that names, builds
the program (``src/repro_torch``) from the seed, warms it up, measures for
``--seconds`` and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics untraced, its per-layer metrics with ``--trace 1``),
``device``, ``breakdown`` when traced, and last ``checks``: every number the
comparison with the reference decided by, beside its limit, which are also
the last lines of standard error.

It exits non-zero and prints no result where there is no card or fewer
cards than the cell asks for, where the program is absent, and where JAX or
the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; no
    library loads JAX on its own."""
    cache = ROOT / "build" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"perfbench +{time.perf_counter() - T_START:.2f}s: {msg}", file=sys.stderr, flush=True)


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(chips: int, rec, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": rec.memory_peak_bytes}
    if trace and rec.profile is not None:
        info["busy_s"] = rec.profile["busy_s"]
        info["window_s"] = rec.profile["window_s"]
    return info


def measure(cell, trace: bool):
    """Drive the cell; returns (record, metrics)."""
    from perfbench.lib import files

    driver = files.load_module("drivers", cell.traffic["kind"])
    rec = driver.run(cell)
    metrics = {}
    for m in files.cell_metrics(files.benchmark(), cell.name, trace):
        value = files.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return rec, metrics


def main(argv=None) -> int:
    args = parse_args(argv)
    _environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout")
    import torch

    log(f"torch {torch.__version__} imported")
    from perfbench.lib import files
    from perfbench.lib.cell import Cell
    from perfbench.lib.profile import breakdown

    work = files.load_json("workloads", args.workload)
    chips = int(work["chips"])
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and does not fall back")
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} found")
    torch.cuda.reset_peak_memory_stats()
    log(f"card ready: {torch.cuda.get_device_name(0)}")
    cell = Cell.load(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                     T_START)
    rec, metrics = measure(cell, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        fail(f"modules of JAX or the JAX package were loaded: {bad}", 3)
    result = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": device_info(chips, rec, bool(args.trace))}
    if args.trace and rec.profile is not None:
        result["breakdown"] = breakdown(rec.profile)
    # last: each number compared, beside its limit (None where there was no number)
    result["checks"] = {c.name: {"value": c.value if c.value == c.value else None,
                                 "limit": c.limit} for c in rec.checks}
    for c in rec.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
