"""Where the benchmark's parts live, and how they are found by name.

Every configuration, traffic mix, driver kind, cell and metric sits in a file
of its own, named after the name ``BENCHMARK.json`` gives it:

    perfbench/configs/<config>.json     perfbench/workloads/<cell>.json
    perfbench/traffic/<mix>.json        perfbench/metrics/<metric>.py
    perfbench/drivers/<kind>.py         perfbench/reference/<architecture>.py

so a later cell, configuration, mix, metric or architecture is a new file and
a new entry, and no edit to the harness.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")
DECODER = "model"


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path.relative_to(ROOT)}")
    return path


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    return json.loads(_path(kind, name, ".json").read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py``, imported under a private module name (a
    metric's name may hold dots, which a module name may not)."""
    path = _path(kind, name, ".py")
    mod_name = f"perfbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    """The root ``BENCHMARK.json``."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics `cell` reports: its end-to-end metrics untraced, its
    per-layer metrics traced. A metric without ``workloads`` is every cell's."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def architecture(model: dict) -> ModuleType:
    """The module that answers every architecture question about `model` (a
    configuration file's contents): ``perfbench/reference/<name>.py`` for the
    file's ``"architecture"`` key, the decoder (``reference/model.py``) where
    it has none. ``perfbench/README.md`` lists what such a module provides."""
    name = model.get("architecture", DECODER)
    if not isinstance(name, str) or not MODULE.match(name):
        raise ValueError(f"architecture {name!r} is not a module name")
    return importlib.import_module(f"perfbench.reference.{name}")
