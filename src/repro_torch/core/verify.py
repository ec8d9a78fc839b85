"""Plan-time symbolic batch verifier: abstract interpretation over op batches.

The fourth checking layer (docs/checking-layers.md). The AST linter runs
pre-commit, the FastTrack detector (``repro_torch.core.race``) pays a per-access
runtime cost, and the model checker (``repro_torch.core.mc``) is exhaustive but
offline. This module is the always-on middle ground: an O(batch)-cost pass
that abstract-interprets a *pending* op list — plus read-only segment/pool
metadata — before ``OpQueue.flush`` mutates any directory, write-combining,
or quota state. It never touches mutable state: inputs are frozen views
(:class:`SegmentView`, :class:`PoolView`) snapshotted by the caller, and the
verifier builds its own scratch copies.

What it computes
----------------
* **May/must page footprints** per (segment, host) stream: the pages a
  stream reads/writes, and the write-combined pages that *may* (over-
  approximation) or *must* (under-approximation) still be pending when the
  batch ends. The gap between may and must is real model behavior: a write
  to a page the host already holds in M or E bypasses the WC buffer, a read
  can take E and turn a later write into a silent upgrade, and a full buffer
  force-drains its LRU victim — all of which the verifier tracks abstractly.
* **An abstract happens-before interpretation** mirroring the dynamic
  detector exactly as ``OpQueue.flush`` drives it: per-host vector clocks
  seeded from the segment view, a release fence (or detach) publishes and
  bumps, an acquire joins every peer's published row — processed in
  submission order, which is the order the planners run at flush time.

Diagnostics
-----------
========  ========  =====================================================
code      severity  meaning
========  ========  =====================================================
PF001     must      unmatched acquire: no peer release fence earlier in
                    the batch can possibly drain — and the segment view
                    shows no peer release from an earlier flush it could
                    pair with instead — so the acquire is a guaranteed
                    no-op (it synchronizes with nothing)
PF002     must/may  release-mode writes still unfenced at batch end: they
                    sit invisibly in WC buffers ("must" when the verifier
                    can prove at least one page certainly pends)
PF003     must      worst-case quota/pool overflow: the batch's staged
                    migrate destinations exceed a quota, the pool, or the
                    local tier — planning will fail and roll back
PF004     may       forced-drain forecast: a stream's distinct may-pending
                    pages exceed ``wc_capacity`` (perf advisory — capacity
                    eviction is legal behavior, never a defect)
PF005     may       batch-local may-race: a conflicting access pair with
                    no fence→acquire edge, checked against every live
                    (page, writer) epoch — a superset of what the dynamic
                    detector (which only keeps the last writer) can flag
========  ========  =====================================================

Severity is *confidence in a defect*: ``"must"`` means the condition holds
on every execution of the batch and marks a guaranteed defect; ``"may"``
is an over-approximation or an advisory. ``preflight="raise"`` raises only
on must-severity findings, so sound over-approximation never blocks a
correct batch.

Soundness
---------
Every conflict the dynamic detector flags while planning a batch appears in
the verifier's PF005 may-set for that batch (cross-validated against the
``repro_torch.core.mc`` litmus corpus by ``tests/test_verify.py`` and CI's
``tools/emucxl_verify.py --corpus``): the abstract clocks replay the
detector's own join rules, and the per-(page, writer) epoch map is a
superset of the detector's last-writer epoch.

Stdlib-only by design — CI's ``emucxl-verify`` job runs without jax/numpy,
so this module must never import ``repro_torch.core.queue`` (which needs jax).
The queue builds :class:`OpDesc` records and calls :func:`verify_batch`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Set, Tuple

PREFLIGHT_MODES = ("off", "warn", "raise")

MUST = "must"
MAY = "may"

#: Diagnostic codes and their one-line meanings (the CLI's legend).
CODES: Dict[str, str] = {
    "PF001": "unmatched acquire (no batch or prior-flush peer release can satisfy it)",
    "PF002": "release writes still unfenced at batch end (invisible in WC buffers)",
    "PF003": "worst-case quota/pool overflow (guaranteed mid-batch rollback)",
    "PF004": "forced-drain forecast (distinct pending pages exceed wc_capacity)",
    "PF005": "batch-local may-race (conflicting accesses, no fence->acquire edge)",
}

#: Op kinds a descriptor may carry. ``detach`` appears in trace/litmus
#: replays (the sync path); the async queue itself never submits one.
OP_KINDS = ("read", "write", "memset", "memcpy", "migrate", "fence",
            "acquire", "detach", "noop")

_RELEASE_KINDS = ("fence", "detach")
_WRITE_KINDS = ("write", "memset", "memcpy")

# Node ids, mirrored from repro_torch.core.emucxl (which this module must not
# import: that would drag in jax).
LOCAL_MEMORY = 0
REMOTE_MEMORY = 1


def resolve_preflight_mode(explicit: Optional[str] = None) -> str:
    """Resolve a ``preflight=`` argument against the environment.

    Mirrors ``repro_torch.core.race.resolve_mode``: an explicit mode always wins;
    ``None`` defers to ``EMUCXL_CHECK`` — the token ``preflight`` anywhere
    in its comma-separated value turns raising preflight on. Read per call,
    like the directory checks.
    """
    if explicit is not None:
        if explicit not in PREFLIGHT_MODES:
            raise ValueError(
                f"unknown preflight {explicit!r}; options: "
                f"{list(PREFLIGHT_MODES)}")
        return explicit
    tokens = os.environ.get("EMUCXL_CHECK", "").split(",")
    return ("raise" if "preflight" in (t.strip().lower() for t in tokens)
            else "off")


# =====================================================================
# Inputs: frozen op descriptors and read-only state views
# =====================================================================

@dataclasses.dataclass(frozen=True)
class OpDesc:
    """One pending op, reduced to what the verifier needs.

    ``pages`` is the op's page footprint on its primary segment (the write
    side for memcpy); a memcpy's read side rides in ``src_*``. Private-buffer
    ops keep ``sid=None`` and are ignored by the segment analyses (they still
    count toward PF003 when they stage allocations).
    """

    kind: str
    sid: Optional[int] = None
    host: Optional[int] = None
    pages: Tuple[int, ...] = ()
    src_sid: Optional[int] = None
    src_host: Optional[int] = None
    src_pages: Tuple[int, ...] = ()
    node: Optional[int] = None          # migrate destination tier
    size: int = 0                       # migrate staged bytes
    label: str = ""                     # site string for diagnostics

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(
                f"unknown op kind {self.kind!r}; options: {list(OP_KINDS)}")


@dataclasses.dataclass(frozen=True)
class SegmentView:
    """Read-only snapshot of one shared segment's verifier-relevant state.

    Built by ``SharedSegment.preflight_view()`` (coherence.py) or
    :func:`fresh_segment_view` for replays of fresh litmus programs.
    All mappings are copied defensively by the verifier before use.
    """

    sid: int
    consistency: str = "release"            # "eager" | "release"
    wc_capacity: Optional[int] = None
    page_bytes: int = 4096
    num_pages: int = 1
    # host -> write-combined pages currently pending (LRU -> MRU order).
    pending: Mapping[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    # host -> pages held in M or E (writes to these bypass the WC buffer).
    held: Mapping[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    # Detector state (empty when no detector): page -> (writer, clock),
    # host -> clock row, host -> published release row.
    write_epoch: Mapping[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)
    vc: Mapping[int, Mapping[int, int]] = dataclasses.field(
        default_factory=dict)
    rel: Mapping[int, Mapping[int, int]] = dataclasses.field(
        default_factory=dict)


def fresh_segment_view(sid: int, num_pages: int = 1,
                       consistency: str = "release",
                       wc_capacity: Optional[int] = None,
                       page_bytes: int = 4096) -> SegmentView:
    """A view of a just-shared segment: nothing cached, pending, or written."""
    return SegmentView(sid=sid, consistency=consistency,
                       wc_capacity=wc_capacity, page_bytes=page_bytes,
                       num_pages=num_pages)


@dataclasses.dataclass(frozen=True)
class PoolView:
    """Read-only headroom snapshot for PF003's worst-case allocation sums."""

    pool_free: int = 0
    # host -> remaining quota bytes (None: host is unpartitioned).
    quota_free: Mapping[int, Optional[int]] = dataclasses.field(
        default_factory=dict)
    # host -> remaining local-tier bytes.
    local_free: Mapping[int, int] = dataclasses.field(default_factory=dict)


# =====================================================================
# Outputs
# =====================================================================

@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One typed preflight finding."""

    code: str                 # PF001..PF005
    severity: str             # "must" | "may"
    message: str
    op_index: Optional[int] = None
    sid: Optional[int] = None
    host: Optional[int] = None
    pages: Tuple[int, ...] = ()

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        where = []
        if self.op_index is not None:
            where.append(f"op {self.op_index}")
        if self.sid is not None:
            where.append(f"sid {self.sid}")
        if self.host is not None:
            where.append(f"host {self.host}")
        at = f" [{', '.join(where)}]" if where else ""
        return f"{self.code}({self.severity}){at}: {self.message}"


class PreflightResult:
    """Everything one ``verify_batch`` call derived, queryable by code.

    ``footprints`` maps (sid, host) streams to their page sets:
    ``reads`` / ``writes`` (exact — descriptors carry exact footprints),
    ``may_pending_end`` / ``must_pending_end`` (the WC-residue bounds).
    """

    __slots__ = ("diagnostics", "ops", "footprints")

    def __init__(self, diagnostics: List[Diagnostic], ops: int,
                 footprints: Dict[Tuple[int, int], Dict[str, Tuple[int, ...]]]):
        self.diagnostics = diagnostics
        self.ops = ops
        self.footprints = footprints

    # ------------------------------------------------------------------ queries
    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def by_severity(self, severity: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def must_count(self) -> int:
        return len(self.by_severity(MUST))

    @property
    def may_count(self) -> int:
        return len(self.by_severity(MAY))

    @property
    def ok(self) -> bool:
        """No guaranteed defect (may-level advisories do not fail a batch)."""
        return self.must_count == 0

    def codes(self) -> Set[str]:
        return {d.code for d in self.diagnostics}

    def race_pages(self, sid: Optional[int] = None) -> Set[int]:
        """The PF005 may-race page set (the dynamic detector's upper bound)."""
        return {p for d in self.by_code("PF005")
                if sid is None or d.sid == sid
                for p in d.pages}

    def summary(self) -> str:
        if not self.diagnostics:
            return f"preflight: {self.ops} op(s), clean"
        counts: Dict[str, int] = {}
        for d in self.diagnostics:
            counts[d.code] = counts.get(d.code, 0) + 1
        body = ", ".join(f"{c}x{n}" if n > 1 else c
                         for c, n in sorted(counts.items()))
        return (f"preflight: {self.ops} op(s), {self.must_count} must / "
                f"{self.may_count} may [{body}]")

    def as_dict(self) -> Dict[str, object]:
        return {
            "ops": self.ops,
            "must": self.must_count,
            "may": self.may_count,
            "diagnostics": [d.as_dict() for d in self.diagnostics],
            "footprints": {
                f"{sid}:{host}": {k: list(v) for k, v in fp.items()}
                for (sid, host), fp in sorted(self.footprints.items())
            },
        }

    def __repr__(self) -> str:
        return f"PreflightResult({self.summary()!r})"


class PreflightError(RuntimeError):
    """Raised by ``flush(preflight="raise")`` on must-severity diagnostics.

    Carries the full :class:`PreflightResult` as ``.result`` so callers can
    inspect every finding, not just the stringified must set."""

    def __init__(self, result: PreflightResult):
        self.result = result
        must = result.by_severity(MUST)
        lines = "; ".join(str(d) for d in must)
        super().__init__(
            f"preflight rejected the batch ({result.summary()}): {lines}")


# =====================================================================
# The abstract interpreter
# =====================================================================

class _StreamState:
    """Abstract WC-buffer state for one (sid, host) release stream."""

    __slots__ = ("may_pending", "must_pending", "uncertain", "peak_may",
                 "reads", "writes", "touched")

    def __init__(self, initial_pending: Tuple[int, ...]):
        # Ordered may-pending set (insertion order approximates LRU).
        self.may_pending: Dict[int, None] = {p: None for p in initial_pending}
        # Pages that certainly pend (the live WC content is certain).
        self.must_pending: Set[int] = set(initial_pending)
        # Once a forced drain becomes possible, must-pending is unprovable:
        # the victim choice depends on dynamic M/E state we only bound.
        self.uncertain = False
        self.peak_may = len(self.may_pending)
        self.reads: Set[int] = set()
        self.writes: Set[int] = set()
        self.touched = False


class _SegState:
    """Abstract detector clocks for one segment (mirrors RaceDetector)."""

    __slots__ = ("view", "vc", "rel", "epochs", "may_held")

    def __init__(self, view: SegmentView):
        self.view = view
        self.vc: Dict[int, Dict[int, int]] = {
            h: dict(row) for h, row in view.vc.items()}
        self.rel: Dict[int, Dict[int, int]] = {
            h: dict(row) for h, row in view.rel.items()}
        # page -> writer -> (clock, op_index | None). Keeping the newest
        # epoch per (page, writer) — instead of the detector's single last
        # writer per page — is the sound over-approximation: an access
        # unordered with ANY epoch of a writer is unordered with that
        # writer's newest one (clocks only grow).
        self.epochs: Dict[int, Dict[int, Tuple[int, Optional[int]]]] = {}
        for page, (writer, clock) in view.write_epoch.items():
            self.epochs[page] = {writer: (clock, None)}
        # host -> pages that MAY be held in M/E (writes to them may bypass
        # the WC buffer). Grows monotonically: reads may take E, a fence
        # upgrades drained pages to M. Never shrinks — shrinking could only
        # promote may->must, so keeping entries is conservative.
        self.may_held: Dict[int, Set[int]] = {
            h: set(pages) for h, pages in view.held.items()}

    def clock(self, host: int) -> int:
        return self.vc.get(host, {}).get(host, 1)

    def ordered(self, host: int, writer: int, clock: int) -> bool:
        if host == writer:
            return True
        return self.vc.get(host, {}).get(writer, 0) >= clock

    def on_release(self, host: int) -> None:
        clock = self.clock(host)
        row = dict(self.vc.get(host, {}))
        row[host] = clock
        self.rel[host] = dict(row)
        row[host] = clock + 1
        self.vc[host] = row

    def on_acquire(self, host: int) -> None:
        peer_rows = [row for h, row in self.rel.items() if h != host]
        if not peer_rows:
            return
        row = dict(self.vc.get(host, {}))
        for prow in peer_rows:
            for h, c in prow.items():
                if row.get(h, 0) < c:
                    row[h] = c
        self.vc[host] = row

    def conflicts(self, host: int, pages: Iterable[int]
                  ) -> List[Tuple[int, int, Optional[int]]]:
        """(page, writer, writer_op_index) for every unordered live epoch."""
        out = []
        for page in pages:
            for writer, (clock, idx) in self.epochs.get(page, {}).items():
                if not self.ordered(host, writer, clock):
                    out.append((page, writer, idx))
        return out

    def record_write(self, host: int, pages: Iterable[int],
                     op_index: int) -> None:
        clock = self.clock(host)
        for page in pages:
            self.epochs.setdefault(page, {})[host] = (clock, op_index)


def _accesses(op: OpDesc) -> List[Tuple[Optional[int], Optional[int],
                                        Tuple[int, ...], bool]]:
    """(sid, host, pages, is_write) access records an op performs, in the
    order the planners perform them (a memcpy reads its source first)."""
    if op.kind == "memcpy":
        out = []
        if op.src_sid is not None:
            out.append((op.src_sid, op.src_host, op.src_pages, False))
        out.append((op.sid, op.host, op.pages, True))
        return out
    if op.kind == "read":
        return [(op.sid, op.host, op.pages, False)]
    if op.kind in ("write", "memset"):
        return [(op.sid, op.host, op.pages, True)]
    return []


def verify_batch(ops: Sequence[OpDesc],
                 segments: Optional[Mapping[int, SegmentView]] = None,
                 pool: Optional[PoolView] = None) -> PreflightResult:
    """Abstract-interpret a pending batch; returns every PF diagnostic.

    ``ops`` is the batch in submission order — the order ``OpQueue.flush``
    plans (and therefore the order the dynamic detector would process).
    ``segments`` maps sids to read-only views; sids the batch references but
    the mapping omits are treated as fresh release segments (the replay
    tools' default). ``pool`` enables PF003; ``None`` skips it.
    Never mutates its inputs.
    """
    segments = dict(segments or {})
    diags: List[Diagnostic] = []

    def seg_view(sid: int) -> SegmentView:
        view = segments.get(sid)
        if view is None:
            pages = [p for op in ops
                     for (s, _h, ps, _w) in _accesses(op) if s == sid
                     for p in ps]
            view = fresh_segment_view(sid, num_pages=max(pages, default=0) + 1)
            segments[sid] = view
        return view

    seg_states: Dict[int, _SegState] = {}
    streams: Dict[Tuple[int, int], _StreamState] = {}

    def seg_state(sid: int) -> _SegState:
        st = seg_states.get(sid)
        if st is None:
            st = seg_states[sid] = _SegState(seg_view(sid))
        return st

    def stream(sid: int, host: int) -> _StreamState:
        key = (sid, host)
        st = streams.get(key)
        if st is None:
            view = seg_view(sid)
            st = streams[key] = _StreamState(
                tuple(view.pending.get(host, ())))
        return st

    # sid -> [(op_index, host, may_drain)] release points seen so far, the
    # PF001 oracle: an acquire is satisfiable iff some earlier peer entry
    # may drain (mirrors flush's seg_releases wiring, where only a fence
    # with fence_drained > 0 becomes a dependency edge).
    releases_seen: Dict[int, List[Tuple[int, int, bool]]] = {}

    for i, op in enumerate(ops):
        if op.kind in ("noop", "migrate"):
            continue                       # PF003 sums migrates below
        if op.kind in _RELEASE_KINDS:
            if op.sid is None:
                continue
            view = seg_view(op.sid)
            host = op.host if op.host is not None else 0
            st = stream(op.sid, host)
            st.touched = True
            may_drain = bool(st.may_pending)
            releases_seen.setdefault(op.sid, []).append((i, host, may_drain))
            if view.consistency == "release":
                seg = seg_state(op.sid)
                # Drained pages land in M for this host: later writes to
                # them are hits and will NOT re-enter the WC buffer.
                seg.may_held.setdefault(host, set()).update(st.may_pending)
                seg.on_release(host)
            st.may_pending.clear()
            st.must_pending.clear()
            st.uncertain = False
            continue
        if op.kind == "acquire":
            if op.sid is None:
                continue
            view = seg_view(op.sid)
            host = op.host if op.host is not None else 0
            stream(op.sid, host).touched = True
            satisfiable = any(
                h != host and may_drain
                for (_j, h, may_drain) in releases_seen.get(op.sid, ()))
            if not satisfiable:
                # Cross-batch pairing: a peer release drained by an
                # *earlier* flush is legal to acquire now. The view's
                # ``rel`` rows record exactly the peers that published a
                # release; ``held`` pages are the detector-off fallback
                # (drained pages land in M, though E pages from reads
                # alias into it — conservative either way, since
                # suppressing a must is always sound). "Guaranteed no-op"
                # survives the evidence only when the detector proves the
                # acquirer's clock already dominates every published peer
                # release — i.e. re-acquiring would join nothing new.
                peer_rel = {h: row for h, row in view.rel.items()
                            if h != host and row is not None}
                if peer_rel:
                    my_vc = view.vc.get(host, {})
                    satisfiable = any(
                        my_vc.get(k, 0) < v
                        for row in peer_rel.values()
                        for k, v in row.items())
                elif any(h != host and pages
                         for h, pages in view.held.items()):
                    satisfiable = True
            if not satisfiable:
                diags.append(Diagnostic(
                    code="PF001", severity=MUST,
                    message=(f"acquire by host {host} on segment {op.sid} "
                             f"has no peer release fence earlier in the "
                             f"batch that could drain — it will "
                             f"synchronize with nothing (guaranteed no-op)"
                             + (f" [{op.label}]" if op.label else "")),
                    op_index=i, sid=op.sid, host=host))
            if view.consistency == "release":
                seg_state(op.sid).on_acquire(host)
            continue
        # Data accesses (read / write / memset / memcpy).
        for (sid, host, pages, is_write) in _accesses(op):
            if sid is None or host is None or not pages:
                continue
            view = seg_view(sid)
            st = stream(sid, host)
            st.touched = True
            release_mode = view.consistency == "release"
            if release_mode:
                seg = seg_state(sid)
                # PF005: check against every live unordered epoch *before*
                # recording this access (the detector checks first too).
                conflicts = seg.conflicts(host, pages)
                if is_write:
                    seg.record_write(host, pages, i)
                else:
                    # Reads may fetch the page into E: a later write by this
                    # host could silently upgrade instead of pending.
                    seg.may_held.setdefault(host, set()).update(pages)
                if conflicts:
                    race_pages = tuple(sorted({p for p, _w, _j in conflicts}))
                    others = sorted({w for _p, w, _j in conflicts})
                    kind = "write-write" if is_write else "read-write"
                    diags.append(Diagnostic(
                        code="PF005", severity=MAY,
                        message=(f"{kind} may-race: host {host} "
                                 f"{'writes' if is_write else 'reads'} "
                                 f"page(s) {list(race_pages)} of segment "
                                 f"{sid} with no fence()->acquire() edge "
                                 f"from writer host(s) {others}"
                                 + (f" [{op.label}]" if op.label else "")),
                        op_index=i, sid=sid, host=host, pages=race_pages))
            if is_write:
                st.writes.update(pages)
                if release_mode:
                    seg = seg_state(sid)
                    held = seg.may_held.get(host, ())
                    for p in pages:
                        st.may_pending[p] = None
                        if p not in held and not st.uncertain:
                            st.must_pending.add(p)
                    cap = view.wc_capacity
                    if cap is not None and len(st.may_pending) > cap:
                        # A forced drain may evict any earlier pending
                        # page; certainty about residue is gone.
                        st.uncertain = True
                        st.must_pending.clear()
                    st.peak_may = max(st.peak_may, len(st.may_pending))
            else:
                st.reads.update(pages)

    # ------------------------------------------------------------- PF004
    for (sid, host), st in sorted(streams.items()):
        view = seg_view(sid)
        cap = view.wc_capacity
        if (view.consistency == "release" and cap is not None
                and st.peak_may > cap):
            diags.append(Diagnostic(
                code="PF004", severity=MAY,
                message=(f"host {host} may write-combine up to {st.peak_may} "
                         f"distinct pages on segment {sid} against "
                         f"wc_capacity={cap}: up to {st.peak_may - cap} "
                         f"forced drain(s) will publish LRU victims early"),
                sid=sid, host=host))

    # ------------------------------------------------------------- PF002
    for (sid, host), st in sorted(streams.items()):
        view = seg_view(sid)
        if view.consistency != "release" or not st.touched:
            continue
        if not st.may_pending:
            continue
        pages = tuple(st.may_pending)
        certain = bool(st.must_pending) and not st.uncertain
        diags.append(Diagnostic(
            code="PF002", severity=MUST if certain else MAY,
            message=(f"host {host} ends the batch with "
                     f"{len(pages)} write-combined page(s) "
                     f"{'(certainly ' + str(sorted(st.must_pending)) + ') ' if certain else ''}"
                     f"unfenced on segment {sid}: the writes stay invisible "
                     f"to peers until a fence() or detach"),
            sid=sid, host=host, pages=pages))

    # ------------------------------------------------------------- PF003
    if pool is not None:
        remote_by_host: Dict[int, int] = {}
        local_by_host: Dict[int, int] = {}
        first_migrate: Dict[Tuple[str, int], int] = {}
        for i, op in enumerate(ops):
            if op.kind != "migrate" or op.host is None:
                continue
            if op.node == REMOTE_MEMORY:
                remote_by_host[op.host] = remote_by_host.get(op.host, 0) \
                    + op.size
                first_migrate.setdefault(("remote", op.host), i)
            else:
                local_by_host[op.host] = local_by_host.get(op.host, 0) \
                    + op.size
                first_migrate.setdefault(("local", op.host), i)
        for host, staged in sorted(remote_by_host.items()):
            quota_free = pool.quota_free.get(host)
            if quota_free is not None and staged > quota_free:
                diags.append(Diagnostic(
                    code="PF003", severity=MUST,
                    message=(f"migrates stage {staged} remote bytes for "
                             f"host {host} but only {quota_free} quota "
                             f"bytes remain: planning will fail and roll "
                             f"the batch back (destinations are charged "
                             f"before sources are freed)"),
                    op_index=first_migrate[("remote", host)], host=host))
        total_remote = sum(remote_by_host.values())
        if total_remote > pool.pool_free:
            diags.append(Diagnostic(
                code="PF003", severity=MUST,
                message=(f"migrates stage {total_remote} remote bytes "
                         f"against {pool.pool_free} free pool bytes: "
                         f"planning will fail and roll the batch back"),
                op_index=min((i for k, i in first_migrate.items()
                              if k[0] == "remote"), default=None)))
        for host, staged in sorted(local_by_host.items()):
            local_free = pool.local_free.get(host)
            if local_free is not None and staged > local_free:
                diags.append(Diagnostic(
                    code="PF003", severity=MUST,
                    message=(f"migrates stage {staged} local bytes for "
                             f"host {host} but only {local_free} local "
                             f"bytes remain: planning will fail and roll "
                             f"the batch back"),
                    op_index=first_migrate[("local", host)], host=host))

    footprints = {
        key: {
            "reads": tuple(sorted(st.reads)),
            "writes": tuple(sorted(st.writes)),
            "may_pending_end": tuple(st.may_pending),
            "must_pending_end": tuple(sorted(st.must_pending)),
        }
        for key, st in sorted(streams.items()) if st.touched
    }
    order = {code: n for n, code in enumerate(CODES)}
    diags.sort(key=lambda d: (d.severity != MUST, order.get(d.code, 99),
                              d.op_index if d.op_index is not None else -1))
    return PreflightResult(diags, ops=len(ops), footprints=footprints)


# =====================================================================
# Replay adapters: litmus programs and captured traces
# =====================================================================

def descs_from_events(events: Iterable[Tuple[str, int, int, Optional[int]]],
                      page_bytes: int = 4096) -> List[OpDesc]:
    """Build descriptors from generic (kind, sid, host, page) tuples —
    the shape both litmus replays and plan-level traces reduce to."""
    out: List[OpDesc] = []
    for kind, sid, host, page in events:
        if kind not in OP_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        pages = () if page is None else (int(page),)
        out.append(OpDesc(kind=kind, sid=sid, host=host, pages=pages))
    return out


def descs_from_trace(events: Iterable[object]
                     ) -> Tuple[List[OpDesc], Dict[int, SegmentView]]:
    """Reduce a captured plan-level trace (``TraceRecorder`` events or their
    ``as_dict`` forms) to a replayable batch plus fresh segment views.

    Only planner events carry footprints (``read``/``write``/``fence``/
    ``acquire``/``detach``/``forced-drain``); queue/engine events are
    skipped. The replay treats every segment as fresh — a trace captured
    from the very first flush replays exactly; later flushes replay with
    pre-batch state abstracted away (still sound: less initial ordering
    can only grow the may-sets).
    """
    descs: List[OpDesc] = []
    max_page: Dict[int, int] = {}
    for ev in events:
        if isinstance(ev, dict):
            kind = ev.get("kind")
            sid, host, page = ev.get("sid"), ev.get("host"), ev.get("page")
        else:
            kind, sid, host, page = ev.kind, ev.sid, ev.host, ev.page
        if kind not in ("read", "write", "fence", "acquire", "detach"):
            continue
        if sid is None or host is None:
            continue
        pages = () if page is None else (int(page),)
        if page is not None:
            max_page[sid] = max(max_page.get(sid, 0), int(page))
        descs.append(OpDesc(kind=kind, sid=sid, host=host, pages=pages))
    views = {sid: fresh_segment_view(sid, num_pages=mp + 1)
             for sid, mp in max_page.items()}
    return descs, views
