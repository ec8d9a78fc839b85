"""Happens-before race detection for release-consistency shared segments.

Release consistency (docs/consistency-model.md) makes unsynchronized sharing
*legal but stale*: a write without a ``fence()`` is invisible to peers, and a
read without an ``acquire()`` has no right to observe a peer's fenced write.
Nothing in the protocol layer fails when a program breaks that discipline — it
just silently reads old bytes, exactly the bug class the paper's standardized
abstraction is meant to surface (and that Assa et al.'s CXL programming model
argues must be an error of the *model*, not of the user's luck).

This module is the checking layer: a FastTrack-style vector-clock detector
(Flanagan & Freund, PLDI 2009) driven by the events the coherence planners
already produce, at the same page granularity as the directory.

Model
-----
Per release segment, each host ``h`` carries a vector clock ``vc[h]`` (its
view of every host's release count, own clock implicitly starting at 1) and a
published snapshot ``rel[h]`` (its clock vector at its last release fence).
Every page remembers its **last-writer epoch** ``(host, clock, site)``.

  * ``write`` by ``h`` stamps each touched page with ``(h, vc[h][h], site)``.
  * ``fence`` (release) by ``h`` publishes ``rel[h] = vc[h]`` and then bumps
    ``vc[h][h]`` — later writes belong to a new epoch.
  * ``acquire`` by ``h`` joins every *peer's* published snapshot into
    ``vc[h]`` — the read-side half of the happens-before edge.

An access by host ``r`` to a page last written in epoch ``(w, c)`` is
**ordered** iff ``r == w`` (a host always sees its own writes) or
``vc[r][w] >= c`` (the writer fenced at or after clock ``c`` and the reader
acquired since). Anything else is a race:

  * a *read-write* race — the reader may observe stale bytes (no acquire, or
    the writer never fenced), and
  * a *write-write* race — two hosts' unordered writes to one page, where the
    directory's last-upgrade-wins outcome is timing, not semantics (this is
    also what same-page **false sharing** looks like at page granularity).

Writes after unordered peer *reads* are deliberately not flagged: the reader
observed a then-consistent snapshot; the writer owes it nothing under release
consistency. This asymmetry keeps publish→import→republish flows (e.g.
``SharedPrefixKV``) race-free without read-epoch bookkeeping.

Enablement
----------
``share(..., race_detect=)`` accepts ``"off"``, ``"warn"`` (record into the
segment's ``stats.races`` counter and ``coherence_stats()["races"]``), or
``"raise"`` (strict: ``RaceError`` naming both access sites and the missing
edge). The default ``None`` resolves from the environment: ``EMUCXL_CHECK``
containing the token ``race`` (CI's test job sets ``EMUCXL_CHECK=race``)
means ``"raise"`` for every release segment, otherwise ``"off"``. Eager
segments are sequentially visible per page and never carry a detector.

Transactionality: detector state is planner state, so every mutation is
journaled through ``DirectoryJournal`` (entry kinds ``race-w``, ``race-vc``,
``race-rel``, ``race-log``) and a failed batch rolls clocks, epochs, and the
race log back byte-identically — the same guarantee the directory itself has.
Strict-mode checks run *before* any mutation, so a sync-path ``RaceError``
leaves no partial state behind even without a journal.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple

if TYPE_CHECKING:  # import cycle: coherence imports this module at runtime
    from .coherence import DirectoryJournal, SharedSegment

RACE_MODES = ("off", "warn", "raise")


class RaceError(RuntimeError):
    """A conflicting access to a release segment with no fence→acquire edge."""


def resolve_mode(explicit: Optional[str]) -> str:
    """Resolve a ``share(..., race_detect=)`` argument against the environment.

    An explicit mode always wins (so intentionally-racy tests can opt out with
    ``race_detect="off"`` even under a strict CI run); ``None`` defers to
    ``EMUCXL_CHECK`` — the token ``race`` anywhere in its comma-separated
    value turns strict checking on. Read per call, like the directory checks.
    """
    if explicit is not None:
        if explicit not in RACE_MODES:
            raise ValueError(
                f"unknown race_detect {explicit!r}; options: {list(RACE_MODES)}")
        return explicit
    tokens = os.environ.get("EMUCXL_CHECK", "").split(",")
    return "raise" if "race" in (t.strip().lower() for t in tokens) else "off"


@dataclasses.dataclass(frozen=True)
class RaceReport:
    """One detected conflict: the two unordered access sites and the edge
    that would have ordered them."""

    sid: int
    page: int
    kind: str                 # "read-write" | "write-write"
    prev_site: str            # the page's last write (host, call, epoch)
    curr_site: str            # the conflicting access
    missing: str              # the absent happens-before edge, spelled out

    def describe(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"race on segment {self.sid} page {self.page} "
                f"({self.kind}): {self.prev_site} vs {self.curr_site} — "
                f"{self.missing}")


class RaceDetector:
    """Vector-clock happens-before tracking for one release segment.

    Owned by ``SharedSegment`` (``seg.detector``; ``None`` when detection is
    off or the segment is eager). The coherence planners call the ``on_*``
    hooks *before* mutating protocol state; ``check_*`` never mutate, so a
    strict-mode raise is side-effect-free. All mutation goes through the
    supplied journal when one is planning a transactional batch.
    """

    __slots__ = ("seg", "mode", "vc", "rel", "write_epoch", "races",
                 "race_counts")

    def __init__(self, seg: "SharedSegment", mode: str):
        self.seg = seg
        self.mode = mode
        # host -> that host's vector clock (own component implicitly 1 when
        # absent: every host is born in epoch 1, so a never-acquired reader
        # has vc[r][w] == 0 < 1 and conflicts with any peer's first write).
        self.vc: Dict[int, Dict[int, int]] = {}
        # host -> vector clock published at its last release fence.
        self.rel: Dict[int, Dict[int, int]] = {}
        # page -> (writer host, writer clock at the write, site string).
        self.write_epoch: Dict[int, Tuple[int, int, str]] = {}
        # warn-mode findings, in detection order (journaled like the stats).
        # `races` holds one report per distinct (page, kind, sites) conflict;
        # `race_counts` holds how many times each recurred — a long run that
        # keeps hitting the same missing edge grows a counter, not the log.
        self.races: List[RaceReport] = []
        self.race_counts: Dict[Tuple[int, str, str, str], int] = {}

    # ---------------------------------------------------------------- clocks
    def _clock(self, host: int) -> int:
        return self.vc.get(host, {}).get(host, 1)

    def _ordered(self, host: int, writer: int, clock: int) -> bool:
        if host == writer:
            return True
        return self.vc.get(host, {}).get(writer, 0) >= clock

    # ---------------------------------------------------------------- checks
    def _conflicts(self, host: int, pages: Iterable[int], site: str,
                   kind: str) -> List[RaceReport]:
        out: List[RaceReport] = []
        for page in pages:
            epoch = self.write_epoch.get(page)
            if epoch is None:
                continue
            writer, clock, prev_site = epoch
            if self._ordered(host, writer, clock):
                continue
            out.append(RaceReport(
                sid=self.seg.sid, page=page, kind=kind,
                prev_site=prev_site, curr_site=site,
                missing=(f"no fence()→acquire() edge from host {writer} to "
                         f"host {host} after the write (writer clock {clock}, "
                         f"host {host} has observed "
                         f"{self.vc.get(host, {}).get(writer, 0)})"),
            ))
        return out

    @staticmethod
    def _report_key(report: RaceReport) -> Tuple[int, str, str, str]:
        return (report.page, report.kind, report.prev_site, report.curr_site)

    def _flag(self, conflicts: List[RaceReport],
              journal: Optional["DirectoryJournal"]) -> None:
        if not conflicts:
            return
        if self.mode == "raise":
            raise RaceError("; ".join(str(c) for c in conflicts))
        if journal is not None:
            journal.record_race_log(self.seg)
        # Dedupe identical (page, sites, edge) findings across flushes: the
        # first occurrence lands in the log, repeats bump its counter. The
        # `races` *stat* still counts every occurrence.
        for report in conflicts:
            key = self._report_key(report)
            seen = self.race_counts.get(key, 0)
            self.race_counts[key] = seen + 1
            if seen == 0:
                self.races.append(report)
        self.seg._bump(journal, "races", len(conflicts))

    # ----------------------------------------------------------------- hooks
    def on_read(self, host: int, pages: Iterable[int], site: str,
                journal: Optional["DirectoryJournal"] = None) -> None:
        """A read never advances clocks; it only has to be ordered after the
        last write of every page it touches."""
        self._flag(self._conflicts(host, pages, site, "read-write"), journal)

    def on_write(self, host: int, pages: Iterable[int], site: str,
                 journal: Optional["DirectoryJournal"] = None) -> None:
        pages = list(pages)
        self._flag(self._conflicts(host, pages, site, "write-write"), journal)
        clock = self._clock(host)
        for page in pages:
            if journal is not None:
                journal.record_race_write(self.seg, page)
            self.write_epoch[page] = (host, clock, site)

    def on_release(self, host: int, journal: Optional["DirectoryJournal"]
                   = None) -> None:
        """A fence publishes this host's clock vector and opens a new epoch.
        Runs even when the WC buffer is empty — a forced capacity drain may
        have published the bytes early, but the *edge* is the fence."""
        if journal is not None:
            journal.record_race_rel(self.seg, host)
            journal.record_race_vc(self.seg, host)
        clock = self._clock(host)
        row = dict(self.vc.get(host, {}))
        row[host] = clock
        self.rel[host] = dict(row)
        row[host] = clock + 1
        self.vc[host] = row

    def on_acquire(self, host: int, journal: Optional["DirectoryJournal"]
                   = None) -> None:
        """Join every peer's published release snapshot into this host's
        clock — after this, everything those fences ordered is ordered here."""
        peer_rows = [row for h, row in self.rel.items() if h != host]
        if not peer_rows:
            return
        if journal is not None:
            journal.record_race_vc(self.seg, host)
        row = dict(self.vc.get(host, {}))
        for prow in peer_rows:
            for h, c in prow.items():
                if row.get(h, 0) < c:
                    row[h] = c
        self.vc[host] = row

    # -------------------------------------------------------------- rollback
    # Called by DirectoryJournal.rollback for the race-* entry kinds.
    def restore_write(self, page: int,
                      epoch: Optional[Tuple[int, int, str]]) -> None:
        if epoch is None:
            self.write_epoch.pop(page, None)
        else:
            self.write_epoch[page] = epoch

    def restore_vc(self, host: int, row: Optional[Dict[int, int]]) -> None:
        if row is None:
            self.vc.pop(host, None)
        else:
            self.vc[host] = row

    def restore_rel(self, host: int, row: Optional[Dict[int, int]]) -> None:
        if row is None:
            self.rel.pop(host, None)
        else:
            self.rel[host] = row

    def restore_log(self, length: int,
                    counts: Dict[Tuple[int, str, str, str], int]) -> None:
        del self.races[length:]
        self.race_counts = dict(counts)

    # --------------------------------------------------------------- queries
    def report(self) -> List[Dict[str, object]]:
        """Warn-mode findings as dicts, each with its occurrence ``count``."""
        out: List[Dict[str, object]] = []
        for r in self.races:
            d = r.describe()
            d["count"] = self.race_counts.get(self._report_key(r), 1)
            out.append(d)
        return out

    def snapshot(self) -> Dict[str, object]:
        """Deep copy of all detector state (rollback-test oracle)."""
        return {
            "vc": {h: dict(r) for h, r in self.vc.items()},
            "rel": {h: dict(r) for h, r in self.rel.items()},
            "write_epoch": dict(self.write_epoch),
            "races": list(self.races),
            "race_counts": dict(self.race_counts),
        }
