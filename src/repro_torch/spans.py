"""The port's timing system: spans and counts inside the program, on the
profiler's clock.

    with spans.span("engine.step") as s:      # a root: one step
        s.set(batch=len(batch))
        with spans.span("engine.tables"):     # its child
            spans.count("entries", n)         # on every open span

A span records its name, its own id, its parent's id (the span that was open
when it opened, the one that caused it), the step number of its root (so one
step's spans share an identifier), its start and end in nanoseconds on the
profiler's clock, and its attributes. ``count(key, n)`` adds `n` to `key` on
every open span, the innermost up to its root, so a span's counts include
those of the spans it opened.

**When it records.** While a ``torch.profiler`` runs, or after ``enable()``
(``disable()`` undoes it). The state is read once, at a root span; spans
opened under a recording span record too. Otherwise a span costs that one
check and returns a shared null context, and a count costs one read of the
number of open spans.

**The clock.** ``perf_counter_ns()`` plus one offset, ``time_ns() -
perf_counter_ns()``, taken at import and again at ``enable()``: the clock of
``prof.profiler.kineto_results.trace_start_ns()``, so a profiler event's
``time_range`` (microseconds after the trace's start) converts to it, and an
idle gap on the device can be put down to the program span that was open.

**Why not ``torch.profiler.record_function``.** Kineto copies every user
annotation onto the device's timeline, where a trace reader would count it
as device work. The spans stay in this process's memory: no annotation, no
NVTX range, no file and no exporter. Records are kept in a bounded ring; a
record that pushes the oldest out is counted in ``RECORDER.dropped``, so
``records()`` holds everything since ``clear()`` while that reads 0.

**Why not ``core/trace.py``.** ``TraceRecorder`` is a clock-less
linearization of coherence events that the model checker, the verifier and
the tests compare and replay by sequence number; timestamps would make equal
runs unequal, so it carries no timing.

One recorder, ``RECORDER``, serves the process (``span``, ``count``,
``records``, ... below); ``Recorder``'s capacity lets a test fill a small
ring. Each thread has its own stack of open spans.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, Tuple

import torch

RING = 65_536


def _profiling() -> bool:
    """Whether a torch profiler is running in this process."""
    return torch._C._autograd._profiler_enabled()


class _Null:
    """The context a span gets where nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("_rec", "_stack", "name", "attrs", "id", "parent", "step", "start_ns")

    def __init__(self, rec: "Recorder", stack: list, name: str, attrs: dict):
        self._rec, self._stack, self.name, self.attrs = rec, stack, name, attrs

    def __enter__(self):
        up = self._stack[-1] if self._stack else None
        self.id = next(self._rec._ids)
        self.parent = up.id if up is not None else None
        self.step = up.step if up is not None else next(self._rec._steps)
        self._stack.append(self)
        with self._rec._lock:
            self._rec._open += 1
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        self._stack.pop()
        self._rec._keep(self, end)
        return False

    def set(self, **attrs) -> None:
        """Set attributes of this span."""
        self.attrs.update(attrs)


class Recorder:
    """Spans and counts, kept in a ring of `capacity` records."""

    def __init__(self, capacity: int = RING):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._steps = itertools.count(1)
        self._open = 0          # spans open in any thread
        self._on = False
        self.dropped = 0
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs):
        """A context manager timing its body; see the module's docstring."""
        if self._open:
            stack = self._stack()
            if stack:
                return _Span(self, stack, name, attrs)
        if self._on or _profiling():
            return _Span(self, self._stack(), name, attrs)
        return _NULL

    def count(self, key: str, n: float = 1) -> None:
        """Add `n` to `key` on every span open in this thread."""
        if not self._open:
            return
        for s in self._stack():
            s.attrs[key] = s.attrs.get(key, 0) + n

    def _keep(self, s: _Span, end_ns: int) -> None:
        rec = {"name": s.name, "id": s.id, "parent": s.parent, "step": s.step,
               "start_ns": s.start_ns + self.offset_ns, "end_ns": end_ns + self.offset_ns,
               "attrs": s.attrs}
        with self._lock:
            self._open -= 1
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def records(self) -> List[dict]:
        """A snapshot of the kept records, oldest first (each closed span is
        recorded when it closes, so a child comes before its parent)."""
        with self._lock:
            return [dict(r, attrs=dict(r["attrs"])) for r in self._ring]

    def clear(self) -> None:
        """Forget the records and the dropped count."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def enable(self) -> None:
        """Record without a profiler, on a clock anchored afresh."""
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._on = True

    def disable(self) -> None:
        """Record only while a profiler runs (the default)."""
        self._on = False


def steps(recs: List[dict], root: str) -> List[Tuple[dict, List[dict]]]:
    """Each root span named `root` in `recs`, with the records of its step
    that lie under it, in the roots' order."""
    roots = {r["step"]: (r, []) for r in recs if r["name"] == root and r["parent"] is None}
    for r in recs:
        group = roots.get(r["step"])
        if group is not None and r is not group[0]:
            group[1].append(r)
    return list(roots.values())


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
records = RECORDER.records
clear = RECORDER.clear
enable = RECORDER.enable
disable = RECORDER.disable

