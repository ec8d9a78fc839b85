"""Linearized event traces for coherence-plan execution.

The model checker (``repro_torch.core.mc``) and the trace tests replay programs
through the coherence planners and need a total order over what actually
happened: which pages a read observed (and in which write-epoch), which
upgrades fired, where fences/acquires/detaches landed, and where each flush
placed its journal mark. This module is that recording layer — a passive
append-only log the planners write into when a :class:`TraceRecorder` is
attached (``SharedSegment.tracer`` / ``EmuCXL.attach_tracer``). With no
recorder attached, every hook is a no-op attribute check; the hot paths pay
one ``is None`` test.

Events are frozen and carry a monotone ``seq`` assigned at emit time, so the
trace *is* the linearization: two events' relative order in ``events`` is the
order the planners committed them. Stdlib-only by design — the model
checker's CI job must run without jax/numpy.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

#: Event kinds the planners emit. Kept here as documentation; the recorder
#: accepts any kind string so layered tooling can add its own marks.
KINDS = (
    "read",          # detail: outcome=hit|store-forward|miss, epoch=(w, c)|None
    "write",         # detail: outcome=hit|e-upgrade|wc-touch|wc-buffered|eager
    "upgrade",       # detail: from_state=M|E|S|I|None
    "forced-drain",  # WC capacity eviction; page is the LRU victim
    "fence",         # detail: pending=(pages drained, in LRU order)
    "acquire",
    "detach",
    "op",            # queue flush submitted an op; detail: op, streams, mark
    "preflight",     # flush ran the batch verifier; detail: ops, must, may
    "rollback",      # a flush failed and the journal rolled back to `mark`
    "job-begin",     # engine started a timeline job; detail: label, at,
    #                  routes=(ordered link-name tuples resolved at plan time)
    "job-complete",  # detail: label, at, queue_wait (summed port-queue wait
    #                  across the job's transfers)
    "transfer-begin",     # fabric registered a DMA; detail: tid, route, nbytes, at
    "transfer-complete",  # detail: tid, route, queue_wait, at
    "transfer-drop",      # arrival beyond a port's bounded FIFO depth;
    #                       detail: tid, link, depth, at (lossless: it still queues)
)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One linearized step. ``detail`` is a sorted tuple of (key, value)
    pairs so events stay hashable and comparisons are order-insensitive."""

    seq: int
    kind: str
    sid: Optional[int] = None
    host: Optional[int] = None
    page: Optional[int] = None
    detail: Tuple[Tuple[str, object], ...] = ()

    def get(self, key: str, default: object = None) -> object:
        for k, v in self.detail:
            if k == key:
                return v
        return default

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "seq": self.seq, "kind": self.kind, "sid": self.sid,
            "host": self.host, "page": self.page,
        }
        d.update(self.detail)
        return d

    def __str__(self) -> str:
        bits = [f"#{self.seq}", self.kind]
        if self.sid is not None:
            bits.append(f"sid={self.sid}")
        if self.host is not None:
            bits.append(f"host={self.host}")
        if self.page is not None:
            bits.append(f"page={self.page}")
        bits.extend(f"{k}={v!r}" for k, v in self.detail)
        return " ".join(bits)


class TraceRecorder:
    """Append-only linearized trace, shared across segments and the engine.

    Also keeps a per-(segment, page) map of the last ``write`` event's
    sequence number: when a segment has no race detector (mode ``"off"``),
    reads still get a meaningful observed epoch — "the write at seq N" —
    so the trace alone suffices to reconstruct visibility.
    """

    __slots__ = ("events", "_seq", "_last_write")

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        self._seq = 0
        self._last_write: Dict[Tuple[int, int], int] = {}

    def emit(self, kind: str, *, sid: Optional[int] = None,
             host: Optional[int] = None, page: Optional[int] = None,
             **detail: object) -> TraceEvent:
        ev = TraceEvent(seq=self._seq, kind=kind, sid=sid, host=host,
                        page=page, detail=tuple(sorted(detail.items())))
        self._seq += 1
        self.events.append(ev)
        if kind == "write" and sid is not None and page is not None:
            self._last_write[(sid, page)] = ev.seq
        return ev

    def observed_epoch(self, sid: int, page: int) -> Optional[Tuple[str, int]]:
        """Detector-free epoch for a read: the last traced write, by seq."""
        seq = self._last_write.get((sid, page))
        return None if seq is None else ("seq", seq)

    def events_of(self, *kinds: str) -> List[TraceEvent]:
        return [ev for ev in self.events if ev.kind in kinds]

    # ------------------------------------------------------------- persistence
    def to_jsonl(self) -> str:
        """Serialize the trace as JSON Lines (one event per line, stdlib
        json) — the capture format ``tools/emucxl_verify.py --trace`` replays
        offline. Tuples become JSON arrays; ``from_jsonl`` restores them, so
        a round trip reproduces the events exactly (values that json cannot
        encode are stringified and round-trip as their string form)."""
        lines = [
            json.dumps(
                {"seq": ev.seq, "kind": ev.kind, "sid": ev.sid,
                 "host": ev.host, "page": ev.page,
                 "detail": {k: v for k, v in ev.detail}},
                default=str, separators=(",", ":"))
            for ev in self.events
        ]
        return "".join(line + "\n" for line in lines)

    @staticmethod
    def _untuple(value: object) -> object:
        if isinstance(value, list):
            return tuple(TraceRecorder._untuple(v) for v in value)
        return value

    @classmethod
    def from_jsonl(cls, source: Union[str, Iterable[str]]) -> "TraceRecorder":
        """Rebuild a recorder from ``to_jsonl`` output (a string or an
        iterable of lines, e.g. an open file). Blank lines are skipped;
        ``_seq`` resumes past the highest loaded sequence number so new
        events appended to a loaded trace never reuse one."""
        rec = cls()
        lines = source.splitlines() if isinstance(source, str) else source
        for line in lines:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            detail = tuple(sorted(
                (k, cls._untuple(v))
                for k, v in (d.get("detail") or {}).items()))
            ev = TraceEvent(seq=int(d["seq"]), kind=d["kind"],
                            sid=d.get("sid"), host=d.get("host"),
                            page=d.get("page"), detail=detail)
            rec.events.append(ev)
            if (ev.kind == "write" and ev.sid is not None
                    and ev.page is not None):
                rec._last_write[(ev.sid, ev.page)] = ev.seq
        rec._seq = (max(ev.seq for ev in rec.events) + 1
                    if rec.events else 0)
        return rec

    def clear(self) -> None:
        self.events.clear()
        self._last_write.clear()
        # `_seq` keeps counting: cleared traces never reuse sequence numbers,
        # so marks recorded before a clear stay unambiguous.

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events)
