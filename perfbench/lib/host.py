"""What the machine was doing beside a window: read before it opens and after
it closes, printed on standard error, never inside the window.

* ``steal``: the share of the machine's CPU time the hypervisor gave to
  others over the window (``/proc/stat``), and ``load``, the one-minute load
  average: a host-bound cell slows when either rises;
* ``py_ms``: the time of a fixed piece of pure-Python work (dict walks, as
  the serving engine's bookkeeping does), the host's own speed;
* the card's SM clock, power draw and temperature (``nvidia-smi``).
"""

from __future__ import annotations

import subprocess
import time
from typing import Optional

GPU_FIELDS = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def _cpu_jiffies() -> Optional[tuple]:
    try:
        with open("/proc/stat") as f:
            vals = [int(v) for v in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    steal = vals[7] if len(vals) > 7 else 0
    return steal, sum(vals[:8])


def _py_ms() -> float:
    table = {(i, i % 7): i for i in range(20000)}
    t0 = time.perf_counter()
    for _ in range(20):
        sum(v for (a, b), v in table.items() if b == 3)
    return (time.perf_counter() - t0) * 1e3


def _gpu() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={GPU_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _load() -> Optional[float]:
    try:
        with open("/proc/loadavg") as f:
            return float(f.read().split()[0])
    except (OSError, ValueError):
        return None


class Beside:
    """``opened()`` before the window, ``closed()`` after; ``line()`` says what
    the host and the card did across it."""

    def __init__(self, gpu: bool):
        self.gpu = gpu
        self.before: dict = {}
        self.after: dict = {}

    def _sample(self) -> dict:
        return {"jiffies": _cpu_jiffies(), "py_ms": _py_ms(), "load": _load(),
                "gpu": _gpu() if self.gpu else None}

    def opened(self) -> None:
        self.before = self._sample()

    def closed(self) -> None:
        self.after = self._sample()

    def line(self) -> str:
        a, b = self.before, self.after
        steal = None
        if a.get("jiffies") and b.get("jiffies"):
            d_total = b["jiffies"][1] - a["jiffies"][1]
            steal = (b["jiffies"][0] - a["jiffies"][0]) / d_total if d_total else 0.0
        return (f"host beside the window: steal {steal!r}, load {a.get('load')!r} -> "
                f"{b.get('load')!r}, py_ms {a.get('py_ms')!r} -> {b.get('py_ms')!r}; "
                f"card ({GPU_FIELDS}) {a.get('gpu')!r} -> {b.get('gpu')!r}")
