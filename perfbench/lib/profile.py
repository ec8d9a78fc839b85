"""Reading a ``torch.profiler`` trace of the card: device time by kernel name,
device busy time, and the idle gaps named by the host span they fell in.

The arithmetic is a frozen copy of ``chip_smoke.py``'s ``print_profile``
(device time summed by event name over the CUDA events), with busy time taken
as the union of the device intervals, so that copies overlapping kernels are
not counted twice, and with the gaps between them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

SPAN_PREFIX = "pb."


def _is_device(event) -> bool:
    from torch.autograd import DeviceType

    return event.device_type == DeviceType.CUDA


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _name_gaps(gaps, spans) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host span open at each
    gap's midpoint ("outside" where none was)."""
    marks = []
    for i, (a, b, _) in enumerate(spans):
        marks.append((a, 1, i))
        marks.append((b, 0, i))
    for j, (a, b) in enumerate(gaps):
        marks.append(((a + b) / 2, 2, j))
    marks.sort()
    active: Dict[int, float] = {}
    by_name: Dict[str, float] = {}
    for _, kind, i in marks:
        if kind == 1:
            active[i] = spans[i][0]
        elif kind == 0:
            active.pop(i, None)
        else:
            a, b = gaps[i]
            name = spans[max(active, key=active.get)][2] if active else "outside"
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return by_name


def summarize(prof, wall_s: float) -> dict:
    """Device busy seconds, the wall of the profiled window, device seconds by
    kernel name ({name: [seconds, calls]}) and idle seconds by host span.
    ``Profiler.stop`` adds the window's host-clock ends, ``t0`` and ``t1``.
    The host spans' own copies on the device's timeline (user annotations)
    are not device work and are left out."""
    device, spans = [], []
    by_name: Dict[str, list] = {}
    for e in prof.events():
        if _is_device(e) and not e.name.startswith(SPAN_PREFIX):
            a, b = e.time_range.start, e.time_range.end
            device.append((a, b))
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.device_time_total / 1e6
            entry[1] += 1
        elif not _is_device(e) and e.name.startswith(SPAN_PREFIX):
            spans.append((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):]))
    merged = _merge(device)
    busy_s = sum(b - a for a, b in merged) / 1e6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    return {"busy_s": busy_s, "window_s": wall_s, "by_name": by_name,
            "idle_by_span": _name_gaps(gaps, spans)}


def kernel_seconds(summary: dict, fragment: str) -> Tuple[float, int]:
    """Device seconds and calls of every kernel whose name holds `fragment`."""
    secs, calls = 0.0, 0
    for name, (s, n) in summary["by_name"].items():
        if fragment in name:
            secs += s
            calls += n
    return secs, calls


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the idle gaps by what the host was doing, largest first."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
            "idle_gaps": [[name, s] for name, s in gaps]}


class Profiler:
    """``torch.profiler`` over the traced slice, CPU and CUDA activity. The
    trace is read after ``stop``, outside every timed span."""

    def __init__(self):
        self.summary = None
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.summary = summarize(self._prof, wall_s)
        self.summary["t0"], self.summary["t1"] = self._t0, self._t0 + wall_s
        self._prof = None


def traced_slice(units: int, step) -> dict:
    """Run `step` `units` times under the profiler; the slice's summary."""
    prof = Profiler()
    prof.start()
    for _ in range(units):
        step()
    prof.stop()
    return prof.summary


def span(name: str, traced: bool):
    """A host span the trace can name idle gaps by (a no-op untraced)."""
    if not traced:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)
