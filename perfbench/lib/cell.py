"""One run of one cell: what a driver is given, and what it hands back.

A driver (``perfbench/drivers/<kind>.py``) exposes ``run(cell) -> Record``.
It builds the program from the cell's files and the seed, warms it up, marks
the window's start (``cell.window_started()``), drives the program for
``cell.seconds``, reads the device's peak memory, frees the program's state
and then decides ``correct`` against the reference. Metric readers
(``perfbench/metrics/<name>.py``) take the record and return a number or
None.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from perfbench.lib import files
from perfbench.lib.host import Beside


@dataclasses.dataclass
class Check:
    """One number the comparison decides by, beside its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Record:
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    memory_peak_bytes: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    # what the metric readers read: units of work in the window, spans,
    # counters and the profiler's summary of the traced slice
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    profile: Optional[dict] = None
    # the weights and the sampled outputs the comparison read, for the control
    inputs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    model: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    arch: Any = None            # a check's stand-in for the registry config
    window_t0: float = 0.0
    beside: Optional[Beside] = None

    @classmethod
    def load(cls, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> "Cell":
        work = files.load_json("workloads", name)
        return cls(name, work, files.load_json("configs", work["config"]),
                   files.load_json("traffic", work["traffic"]), seed, seconds, trace,
                   torch.device(device), t_start)

    def log(self, msg: str) -> None:
        """A progress line on standard error, with the seconds since start."""
        print(f"perfbench {self.name} +{time.perf_counter() - self.t_start:.2f}s: {msg}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window_started(self, rec: Record) -> float:
        """Set-up ends here: everything before this is ``setup_s``. What the
        host and the card do is read just before."""
        self.beside = Beside(gpu=self.device.type == "cuda")
        self.beside.opened()
        self.sync()
        self.window_t0 = time.perf_counter()
        rec.setup_s = self.window_t0 - self.t_start
        return self.window_t0

    def window_closed(self, rec: Record) -> None:
        self.sync()
        rec.window_s = time.perf_counter() - self.window_t0
        if self.device.type == "cuda":
            rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        self.beside.closed()
        self.log(self.beside.line())

    def port_config(self):
        """The port's registry config, held to the file's published widths
        by the architecture's ``port_check``: a run refuses a registry entry
        that differs from what the file states."""
        from repro_torch.configs import get_config

        cfg = get_config(self.model["registry"])
        files.architecture(self.model).port_check(self.model, cfg)
        return cfg
