"""emucxl-mc: stateless model checking for the coherence + consistency layers.

``docs/consistency-model.md`` is a normative contract and ``core/race.py`` a
dynamic checker — but both only ever see the schedules a test happens to run.
This module closes that gap in the way software model checkers do (Godefroid,
VeriSoft, POPL '97; Flanagan & Godefroid, DPOR, POPL '05): re-execute a small
litmus program under *every* schedule the stream-graph scheduler permits,
pruned with sleep sets over commuting operations, and check each explored
execution against an **axiomatic oracle** derived independently from the
documented model:

  * **happens-before** — a FastTrack-free re-derivation of the fence→acquire
    ordering predicts, per step, exactly how many conflicts the dynamic
    detector (``core/race.py``) must flag (0 or 1); any disagreement is a
    detector bug;
  * **protocol/state conformance** — a shadow model (``_SpecState``) replays
    the consistency doc's state table (MESI-lite+E transitions, store
    forwarding, write-combining LRU order, forced drains) and every step must
    leave the real ``Directory``/stats/WC buffers in exactly the shadow state;
  * **E/M exclusivity** — ``Directory.check()`` plus the release-mode
    invariant that a write-combined (pending) page is held at most Shared;
  * **rollback is the exact inverse** — every DFS step is undone through a
    ``DirectoryJournal`` and the restored state must be byte-identical to the
    pre-step snapshot (directory, stats, WC order, detector clocks and log).

Exploration runs the planners directly (``SharedSegment.plan_*`` with no
fabric), so the whole subsystem is stdlib-only: the CI job runs it on a bare
interpreter. Threads are hosts; one op per step keeps the per-step oracle
exact.

The DSL models the scheduler's reality: within a thread, ops are program-
ordered; across threads, ``Program.order`` constraints encode the dependency
edges ``OpQueue.flush`` wires between a draining fence and a later acquire on
another stream (an acquire *waits* for prior peer releases — interleavings
that violate a declared edge cannot be scheduled, so the checker does not
explore them). The naive bound reported against DPOR is the unconstrained
multinomial — the schedule count a checker without partial-order reduction
or stream-graph pruning would face.

Sleep sets alone are sound here because (a) enabledness is persistent — an
enabled op can never be disabled by another thread's step, only executed —
and (b) the independence relation below is *full-state* commutativity
(directory, stats, WC buffers, detector clocks, race verdicts), checked
against the planner semantics case by case, so pruned interleavings are
state-equivalent to explored ones.

``enumerate_protocol`` is the complementary exhaustive walk: instead of one
program's reachable states, it walks *every* reachable small-directory
configuration (≤3 hosts, ≤2 pages) under all single-op transitions, proving
``Directory.check()`` and the pending-page invariant hold on the entire
reachable state space, not just on litmus-reachable corners.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .coherence import (
    EAGER,
    EXCLUSIVE,
    MODIFIED,
    MSG_BYTES,
    RELEASE,
    SHARED,
    CoherenceError,
    DirectoryJournal,
    SharedSegment,
)
from .trace import TraceRecorder

__all__ = [
    "PAGE", "Op", "R", "W", "F", "A", "D", "Program", "CheckResult",
    "EnumResult", "CORPUS", "corpus", "find_program", "independent",
    "check_program", "check_corpus", "all_schedules", "naive_schedule_count",
    "SeededMutationSegment", "seeded_mutation_factory", "enumerate_protocol",
]

#: Litmus programs use one directory page per logical location.
PAGE = 4096

# Exploration backstops — far above any corpus program, so hitting one is a
# checker bug, not a tuning knob.
_MAX_EXECUTIONS = 250_000
_MAX_VIOLATIONS = 25


# --------------------------------------------------------------------- DSL
@dataclasses.dataclass(frozen=True)
class Op:
    """One litmus step: ``read``/``write`` touch one page; ``fence``,
    ``acquire`` and ``detach`` are the synchronization/teardown ops."""

    kind: str
    page: Optional[int] = None

    def __str__(self) -> str:
        tag = {"read": "R", "write": "W", "fence": "F",
               "acquire": "A", "detach": "D"}[self.kind]
        return tag if self.page is None else f"{tag}{self.page}"


def R(page: int) -> Op:
    return Op("read", page)


def W(page: int) -> Op:
    return Op("write", page)


def F() -> Op:
    return Op("fence")


def A() -> Op:
    return Op("acquire")


def D() -> Op:
    return Op("detach")


@dataclasses.dataclass(frozen=True)
class Program:
    """A litmus test: per-thread op sequences plus cross-thread scheduling
    constraints.

    ``order`` entries ``((ta, ia), (tb, ib))`` assert that thread ``ta``'s
    op ``ia`` precedes thread ``tb``'s op ``ib`` in every permitted
    schedule — the stream-graph dependency an acquire (or a submission
    barrier) wires in ``OpQueue.flush``. ``expect_race`` is the program's
    ∃-schedule verdict: racy iff *some* permitted schedule races.
    """

    name: str
    threads: Tuple[Tuple[Op, ...], ...]
    expect_race: bool
    consistency: str = RELEASE
    wc_capacity: Optional[int] = None
    order: Tuple[Tuple[Tuple[int, int], Tuple[int, int]], ...] = ()
    description: str = ""

    @property
    def num_threads(self) -> int:
        return len(self.threads)

    @property
    def num_pages(self) -> int:
        pages = [op.page for ops in self.threads for op in ops
                 if op.page is not None]
        return (max(pages) + 1) if pages else 1

    def write_set(self, thread: int) -> frozenset:
        return frozenset(op.page for op in self.threads[thread]
                         if op.kind == "write")

    def touch_set(self, thread: int) -> frozenset:
        return frozenset(op.page for op in self.threads[thread]
                         if op.page is not None)

    def __str__(self) -> str:
        body = " || ".join(
            " ".join(str(op) for op in ops) for ops in self.threads)
        return f"{self.name}: {body}"


def _prog(name, threads, expect_race, **kw):
    return Program(name=name,
                   threads=tuple(tuple(t) for t in threads),
                   expect_race=expect_race, **kw)


# ------------------------------------------------------------- independence
def _footprint(program: Program, thread: int, op: Op) -> frozenset:
    """Pages an op may transition. A buffered release-mode write with a
    *bounded* WC buffer may evict any earlier pending page (forced drain),
    so its footprint widens to the thread's whole write set; a fence drains
    the write set; a detach additionally drops every cached page."""
    if op.kind == "read":
        return frozenset((op.page,))
    if op.kind == "write":
        if program.consistency == RELEASE and program.wc_capacity is not None:
            return program.write_set(thread)
        return frozenset((op.page,))
    if op.kind == "fence":
        return program.write_set(thread)
    if op.kind == "detach":
        return program.touch_set(thread)
    return frozenset()      # acquire: clock-only


def independent(program: Program, ta: int, a: Op, tb: int, b: Op) -> bool:
    """Full-state commutativity of two ops on *different* threads.

    Verified against the planner semantics: an acquire touches only its own
    host's clock row (and reads the published releases), so it commutes with
    any data op but not with a release (fence/detach) — the join result
    depends on what was published. Two reads commute even on one page: the
    downgrade lattice (M→S forward, E→S) and the miss/hit stat deltas are
    symmetric in reader order, and the detector flags each read against the
    page's last-*write* epoch only. Everything else is footprint disjointness.
    """
    if ta == tb:
        return False
    kinds = {a.kind, b.kind}
    if "acquire" in kinds:
        if kinds == {"acquire"}:
            return True
        other = b.kind if a.kind == "acquire" else a.kind
        return other in ("read", "write")
    if kinds == {"read"}:
        return True
    return not (_footprint(program, ta, a) & _footprint(program, tb, b))


# ------------------------------------------------------ happens-before oracle
class _HBOracle:
    """Independent re-derivation of the documented fence→acquire model.

    Formulated over *release points*, not vector clocks: each host counts its
    own epochs; a release appends ``(host, reachable-view ∪ {self: epoch})``
    to a global publication list; an acquire folds every peer publication
    into the host's view. An access to a page last written in a peer's epoch
    ``c`` races exactly when the accessor's view of that peer is ``< c``.
    ``step`` returns the number of conflicts the dynamic detector must flag
    for that op (0 or 1 — litmus ops touch one page).
    """

    def __init__(self, num_threads: int):
        self.epoch = [1] * num_threads
        self.view: List[Dict[int, int]] = [{} for _ in range(num_threads)]
        self.releases: List[Tuple[int, Dict[int, int]]] = []
        self.last_write: Dict[int, Tuple[int, int]] = {}

    def _flags(self, host: int, page: int) -> int:
        lw = self.last_write.get(page)
        if lw is None:
            return 0
        writer, clock = lw
        if writer == host:
            return 0
        return 0 if self.view[host].get(writer, 0) >= clock else 1

    def step(self, host: int, op: Op) -> int:
        if op.kind == "read":
            return self._flags(host, op.page)
        if op.kind == "write":
            n = self._flags(host, op.page)
            self.last_write[op.page] = (host, self.epoch[host])
            return n
        if op.kind in ("fence", "detach"):
            row = dict(self.view[host])
            row[host] = self.epoch[host]
            self.releases.append((host, row))
            self.epoch[host] += 1
            return 0
        if op.kind == "acquire":
            view = self.view[host]
            for rhost, row in self.releases:
                if rhost == host:
                    continue
                for peer, clock in row.items():
                    if view.get(peer, 0) < clock:
                        view[peer] = clock
            return 0
        raise ValueError(f"unknown op kind {op.kind!r}")

    def save(self):
        return (list(self.epoch), [dict(v) for v in self.view],
                [(h, dict(r)) for h, r in self.releases],
                dict(self.last_write))

    def load(self, state) -> None:
        epoch, view, releases, last_write = state
        self.epoch = list(epoch)
        self.view = [dict(v) for v in view]
        self.releases = [(h, dict(r)) for h, r in releases]
        self.last_write = dict(last_write)


# ------------------------------------------------------- protocol shadow model
# Stat fields the shadow model predicts exactly per step. `races` belongs to
# the HB oracle; `fence_coalesced`/`acquires` are async-batch bookkeeping the
# planners never touch.
_SPEC_FIELDS = (
    "read_hits", "write_hits", "read_misses", "write_misses",
    "invalidations", "writebacks", "forwards", "e_upgrades", "wc_writes",
    "fences", "forced_drains", "forced_drain_pages", "bytes_moved",
    "msg_bytes",
)


class _SpecState:
    """Shadow re-execution of the documented state table (the transition
    table in coherence.py's header + the release-consistency rules in
    docs/consistency-model.md), kept deliberately separate from the planner
    code so a planner regression cannot hide in its own oracle."""

    def __init__(self, consistency: str, wc_capacity: Optional[int],
                 page_bytes: int):
        self.consistency = consistency
        self.cap = wc_capacity
        self.page_bytes = page_bytes
        self.dir: Dict[int, Dict[int, str]] = {}
        self.wc: Dict[int, List[int]] = {}          # host -> LRU->MRU pages
        self.stats: Dict[str, int] = {f: 0 for f in _SPEC_FIELDS}

    # -- state helpers
    def _st(self, page: int, host: int) -> Optional[str]:
        return self.dir.get(page, {}).get(host)

    def _set(self, page: int, host: int, state: Optional[str]) -> None:
        entry = self.dir.setdefault(page, {})
        if state is None:
            entry.pop(host, None)
            if not entry:
                self.dir.pop(page, None)
        else:
            entry[host] = state

    def _bump(self, field: str, amount: int = 1) -> None:
        self.stats[field] += amount

    # -- transition rules
    def _upgrade(self, host: int, page: int) -> None:
        st = self._st(page, host)
        if st == MODIFIED:
            return
        if st == EXCLUSIVE:
            self._bump("e_upgrades")
            self._set(page, host, MODIFIED)
            return
        self._bump("write_misses")
        for peer, peer_st in list(self.dir.get(page, {}).items()):
            if peer == host:
                continue
            if peer_st == MODIFIED:
                self._bump("writebacks")
                self._bump("bytes_moved", self.page_bytes)
            self._bump("invalidations")
            self._bump("msg_bytes", MSG_BYTES)
            self._set(page, peer, None)
        if st is None:
            self._bump("bytes_moved", self.page_bytes)      # RFO fetch
        self._set(page, host, MODIFIED)

    def read(self, host: int, page: int) -> None:
        st = self._st(page, host)
        if st in (MODIFIED, EXCLUSIVE, SHARED):
            self._bump("read_hits")
            return
        if page in self.wc.get(host, ()):
            self._bump("read_hits")                         # store forwarding
            return
        self._bump("read_misses")
        holders = self.dir.get(page, {})
        owner = next((h for h, s in holders.items() if s == MODIFIED), None)
        if owner is not None and owner != host:
            self._bump("forwards")
            self._bump("writebacks")
            self._bump("bytes_moved", self.page_bytes)
            self._set(page, owner, SHARED)
        else:
            for peer, peer_st in list(holders.items()):
                if peer != host and peer_st == EXCLUSIVE:
                    self._set(page, peer, SHARED)
        self._bump("bytes_moved", self.page_bytes)
        others = any(h != host for h in self.dir.get(page, {}))
        self._set(page, host, SHARED if others else EXCLUSIVE)

    def write(self, host: int, page: int) -> None:
        st = self._st(page, host)
        if st == MODIFIED:
            self._bump("write_hits")
            return
        if st == EXCLUSIVE:
            self._bump("write_hits")
            self._upgrade(host, page)
            return
        if self.consistency == RELEASE:
            pending = self.wc.get(host)
            if pending is not None and page in pending:
                pending.remove(page)
                pending.append(page)                        # MRU touch
                self._bump("wc_writes")
                return
            if (self.cap is not None and pending is not None
                    and len(pending) >= self.cap):
                victim = pending.pop(0)                     # LRU eviction
                self._bump("forced_drains")
                self._bump("forced_drain_pages")
                self._upgrade(host, victim)
            self.wc.setdefault(host, []).append(page)
            self._bump("wc_writes")
            return
        self._upgrade(host, page)

    def fence(self, host: int) -> None:
        pending = self.wc.pop(host, None)
        if not pending:
            return
        for page in pending:
            self._upgrade(host, page)
        self._bump("fences")

    def detach(self, host: int) -> None:
        self.fence(host)
        for page in [p for p, e in self.dir.items() if host in e]:
            if self._st(page, host) == MODIFIED:
                self._bump("writebacks")
                self._bump("bytes_moved", self.page_bytes)
            self._set(page, host, None)

    def step(self, host: int, op: Op) -> None:
        if op.kind == "read":
            self.read(host, op.page)
        elif op.kind == "write":
            self.write(host, op.page)
        elif op.kind == "fence":
            self.fence(host)
        elif op.kind == "detach":
            self.detach(host)
        # acquire: no protocol state, no stats

    def save(self):
        return ({p: dict(e) for p, e in self.dir.items()},
                {h: list(ps) for h, ps in self.wc.items()},
                dict(self.stats))

    def load(self, state) -> None:
        d, wc, stats = state
        self.dir = {p: dict(e) for p, e in d.items()}
        self.wc = {h: list(ps) for h, ps in wc.items()}
        self.stats = dict(stats)


# ------------------------------------------------------------------- results
@dataclasses.dataclass
class CheckResult:
    """Outcome of exploring one program under every permitted schedule."""

    program: Program
    explored: int                       # complete executions DPOR ran
    naive: int                          # unconstrained multinomial bound
    racy_schedules: int
    racy: bool                          # ∃ explored schedule with a race
    witness_racy: Optional[Tuple[int, ...]]
    witness_free: Optional[Tuple[int, ...]]
    violations: List[str]

    @property
    def verdict_ok(self) -> bool:
        return self.racy == self.program.expect_race

    @property
    def ok(self) -> bool:
        return not self.violations and self.verdict_ok

    def summary(self) -> Dict[str, object]:
        return {
            "program": self.program.name,
            "threads": self.program.num_threads,
            "ops": sum(len(t) for t in self.program.threads),
            "explored": self.explored,
            "naive": self.naive,
            "reduction": (round(1 - self.explored / self.naive, 4)
                          if self.naive else 0.0),
            "racy_schedules": self.racy_schedules,
            "racy": self.racy,
            "expect_race": self.program.expect_race,
            "violations": len(self.violations),
            "ok": self.ok,
        }


class _Abort(Exception):
    """Exploration state is no longer trustworthy (a rollback failed to
    restore it); unwind the DFS and report what was found."""


def naive_schedule_count(program: Program) -> int:
    """The unconstrained interleaving count ``(Σ|t|)! / Π |t|!`` — what a
    checker without DPOR or stream-graph pruning would enumerate."""
    total = sum(len(t) for t in program.threads)
    out = math.factorial(total)
    for t in program.threads:
        out //= math.factorial(len(t))
    return out


def _enabled(program: Program, pc: List[int]) -> List[int]:
    """Threads whose next op exists and has every declared predecessor
    already executed — the stream-graph scheduler's enabled set."""
    out = []
    for t, ops in enumerate(program.threads):
        i = pc[t]
        if i >= len(ops):
            continue
        if all(pc[pt] > pi for (pt, pi), succ in program.order
               if succ == (t, i)):
            out.append(t)
    return out


def all_schedules(program: Program,
                  limit: Optional[int] = None) -> Iterator[Tuple[int, ...]]:
    """Every permitted interleaving, as tuples of thread ids (no reduction —
    the replay cross-validation in tests iterates these)."""
    total = sum(len(t) for t in program.threads)
    pc = [0] * program.num_threads
    path: List[int] = []
    emitted = 0

    def walk():
        nonlocal emitted
        if limit is not None and emitted >= limit:
            return
        if len(path) == total:
            emitted += 1
            yield tuple(path)
            return
        for t in _enabled(program, pc):
            pc[t] += 1
            path.append(t)
            yield from walk()
            path.pop()
            pc[t] -= 1

    return walk()


# ----------------------------------------------------------------- explorer
def _default_segment(program: Program) -> SharedSegment:
    return SharedSegment(
        program.num_pages * PAGE, PAGE, backing_addr=0, home_host=0, port=0,
        sid=0, consistency=program.consistency,
        wc_capacity=program.wc_capacity, race_detect="warn")


def _segment_snapshot(seg: SharedSegment):
    return (seg.directory.snapshot(), seg.stats.as_dict(),
            {h: list(ps) for h, ps in seg.wc.items() if ps},
            seg.detector.snapshot() if seg.detector is not None else None)


def _pending_invariant(seg: SharedSegment) -> Optional[str]:
    """A write-combined page is unpublished: the buffering host may hold it
    at most Shared (M/E would mean the protocol already upgraded it)."""
    for host, pending in seg.wc.items():
        for page in pending:
            st = seg.directory.state(page, host)
            if st not in (None, SHARED):
                return (f"pending page {page} held in {st} by host {host} "
                        f"(write-combined pages must be at most S)")
    return None


def check_program(program: Program,
                  segment_factory: Optional[
                      Callable[[Program], SharedSegment]] = None
                  ) -> CheckResult:
    """Explore every permitted schedule of `program` (sleep-set DPOR) and
    check each step against the axiomatic oracle. Returns the aggregate
    verdict; ``result.ok`` requires zero violations *and* the explored racy
    verdict to match ``program.expect_race``."""
    seg = (segment_factory or _default_segment)(program)
    seg.tracer = TraceRecorder()        # exercises the trace layer too
    journal = DirectoryJournal()
    spec = _SpecState(seg.consistency, seg.wc_capacity, seg.page_bytes)
    oracle = _HBOracle(program.num_threads)

    total = sum(len(t) for t in program.threads)
    pc = [0] * program.num_threads
    path: List[int] = []
    violations: List[str] = []
    counters = {"explored": 0, "racy": 0}
    witness: Dict[str, Optional[Tuple[int, ...]]] = {
        "racy": None, "free": None}

    def violation(msg: str) -> None:
        at = "-".join(str(t) for t in path) or "<start>"
        violations.append(f"[{program.name} @ {at}] {msg}")
        if len(violations) >= _MAX_VIOLATIONS:
            raise _Abort()

    def run_op(thread: int, op: Op) -> None:
        offset = (op.page or 0) * seg.page_bytes
        if op.kind == "read":
            seg.plan_read(None, thread, offset, seg.page_bytes, journal)
        elif op.kind == "write":
            seg.plan_write(None, thread, offset, seg.page_bytes, journal)
        elif op.kind == "fence":
            seg.plan_fence(None, thread, journal)
        elif op.kind == "acquire":
            seg.plan_acquire(thread, journal)
        elif op.kind == "detach":
            seg.plan_detach(None, thread, journal)
        else:
            raise ValueError(f"unknown op kind {op.kind!r}")

    def check_step(thread: int, op: Op, races_before: int,
                   expected_flags: int) -> None:
        if seg.detector is not None:
            delta = seg.stats.races - races_before
            if delta != expected_flags:
                violation(
                    f"happens-before: {op} by host {thread} flagged {delta} "
                    f"conflict(s); the fence→acquire model requires "
                    f"{expected_flags}")
        try:
            seg.directory.check()
        except CoherenceError as exc:
            violation(f"E/M exclusivity: {exc}")
        bad = _pending_invariant(seg)
        if bad is not None:
            violation(f"store-forwarding visibility: {bad}")
        spec_dir, spec_wc, spec_stats = spec.save()
        if seg.directory.snapshot() != spec_dir:
            violation(
                f"state table: after {op} by host {thread} directory is "
                f"{seg.directory.snapshot()} but the documented model gives "
                f"{spec_dir}")
        real_wc = {h: list(ps) for h, ps in seg.wc.items() if ps}
        if real_wc != spec_wc:
            violation(
                f"write-combining order: after {op} by host {thread} "
                f"buffers are {real_wc}, model gives {spec_wc}")
        real_stats = seg.stats.as_dict()
        diffs = {f: (real_stats[f], spec_stats[f]) for f in _SPEC_FIELDS
                 if real_stats[f] != spec_stats[f]}
        if diffs:
            violation(
                f"protocol counters: after {op} by host {thread} "
                f"{diffs} (real, model)")

    def explore(sleep: set) -> None:
        if len(path) == total:
            counters["explored"] += 1
            if counters["explored"] > _MAX_EXECUTIONS:
                violation("execution budget exceeded (checker bug?)")
                raise _Abort()
            racy = seg.stats.races > 0
            sched = tuple(path)
            if racy:
                counters["racy"] += 1
                if witness["racy"] is None:
                    witness["racy"] = sched
            elif witness["free"] is None:
                witness["free"] = sched
            return
        for thread in _enabled(program, pc):
            if thread in sleep:
                continue
            op = program.threads[thread][pc[thread]]
            mark = journal.mark()
            before = _segment_snapshot(seg)
            spec_state, oracle_state = spec.save(), oracle.save()
            races_before = seg.stats.races

            run_op(thread, op)
            expected_flags = oracle.step(thread, op)
            spec.step(thread, op)
            check_step(thread, op, races_before, expected_flags)

            pc[thread] += 1
            path.append(thread)
            child_sleep = {
                s for s in sleep
                if independent(program, s,
                               program.threads[s][pc[s]], thread, op)}
            explore(child_sleep)
            path.pop()
            pc[thread] -= 1

            journal.rollback(mark)
            spec.load(spec_state)
            oracle.load(oracle_state)
            if _segment_snapshot(seg) != before:
                after = _segment_snapshot(seg)
                labels = ("directory", "stats", "wc", "detector")
                diffs = [labels[i] for i in range(4) if after[i] != before[i]]
                violation(
                    f"rollback inverse: undoing {op} by host {thread} left "
                    f"{', '.join(diffs)} different from the pre-step state")
                raise _Abort()
            sleep.add(thread)

    try:
        explore(set())
    except _Abort:
        pass

    return CheckResult(
        program=program,
        explored=counters["explored"],
        naive=naive_schedule_count(program),
        racy_schedules=counters["racy"],
        racy=counters["racy"] > 0,
        witness_racy=witness["racy"],
        witness_free=witness["free"],
        violations=violations,
    )


# ------------------------------------------------------------------- corpus
# Every program is multi-threaded: the CI gate requires DPOR (plus the
# stream-graph order pruning) to explore strictly fewer schedules than the
# naive multinomial on each of them.
CORPUS: Tuple[Program, ...] = (
    _prog("mp_handoff",
          [(W(0), F()), (A(), R(0))], expect_race=False,
          order=(((0, 1), (1, 0)),),
          description="Classic message passing, fully synchronized: the "
                      "consumer's acquire is scheduled after the producer's "
                      "fence (the flush dependency edge)."),
    _prog("mp_unsequenced",
          [(W(0), F()), (A(), R(0))], expect_race=True,
          description="Same ops, no scheduling edge: some interleaving runs "
                      "the acquire before the fence published anything, so "
                      "the read races."),
    _prog("mp_missing_acquire",
          [(W(0), F()), (R(1), R(0))], expect_race=True,
          order=(((0, 1), (1, 1)),),
          description="The consumer read follows the fence in every "
                      "schedule but never acquires — stale by contract."),
    _prog("mp_missing_fence",
          [(W(0),), (A(), R(0))], expect_race=True,
          order=(((0, 0), (1, 1)),),
          description="Acquire without a producer fence: nothing was ever "
                      "published, the read races in every schedule."),
    _prog("store_buffering",
          [(W(0), F(), A(), R(1)), (W(1), F(), A(), R(0))],
          expect_race=True,
          description="Dekker/SB shape with no cross-thread edges: an "
                      "acquire can run before the peer's fence."),
    _prog("store_buffering_sequenced",
          [(W(0), F(), A(), R(1)), (W(1), F(), A(), R(0))],
          expect_race=False,
          order=(((0, 1), (1, 2)), ((1, 1), (0, 2))),
          description="SB with both acquires scheduled after the peer "
                      "fences: race-free in all permitted schedules."),
    _prog("disjoint_writers",
          [(W(0), F()), (W(1), F())], expect_race=False,
          description="Fully independent threads: DPOR collapses all six "
                      "interleavings into one."),
    _prog("false_sharing",
          [(W(0), F()), (W(1), W(0), F())], expect_race=True,
          description="Two unordered writers of page 0: a write-write race "
                      "under every schedule (page-granular false sharing)."),
    _prog("private_rmw",
          [(R(0), W(0), F()), (R(1), W(1), F())], expect_race=False,
          description="Each thread read-modify-writes a private page: the "
                      "read takes E, the write silently upgrades E→M — the "
                      "seeded-mutation target."),
    _prog("wc_capacity_eviction",
          [(W(0), W(1), F()), (A(), R(2))], expect_race=False,
          wc_capacity=1,
          order=(((0, 2), (1, 0)),),
          description="A one-page WC buffer forces the second write to "
                      "drain the first early (forced_drains); the reader is "
                      "fully synchronized."),
    _prog("detach_publishes",
          [(W(0), D()), (A(), R(0))], expect_race=False,
          order=(((0, 1), (1, 0)),),
          description="Detach is a release point: the acquire scheduled "
                      "after it observes the write."),
    _prog("three_host_chain",
          [(W(0), F()), (A(), W(1), F()), (A(), R(0), R(1))],
          expect_race=False,
          order=(((0, 1), (1, 0)), ((1, 2), (2, 0))),
          description="Transitive publication across three hosts: host 2's "
                      "acquire inherits host 0's release through host 1's "
                      "view."),
)


def corpus() -> Tuple[Program, ...]:
    return CORPUS


def find_program(name: str) -> Program:
    for p in CORPUS:
        if p.name == name:
            return p
    raise KeyError(f"no litmus program named {name!r}; "
                   f"corpus: {[p.name for p in CORPUS]}")


def check_corpus(programs: Optional[Sequence[Program]] = None
                 ) -> List[CheckResult]:
    return [check_program(p) for p in (programs or CORPUS)]


# ---------------------------------------------------------- seeded mutation
class SeededMutationSegment(SharedSegment):
    """The acceptance-criteria mutant: the silent E→M upgrade happens but is
    **not journaled**, so a rollback leaves the page Modified and the
    ``e_upgrades`` counter bumped. The post-step state is fully correct —
    only the rollback-is-the-exact-inverse oracle can catch it."""

    def _upgrade(self, fabric, host, page, journal, msgs):
        if self.directory.state(page, host) == EXCLUSIVE:
            self.stats.e_upgrades += 1                  # unjournaled!
            self.directory.set_state(page, host, MODIFIED)
            return
        super()._upgrade(fabric, host, page, journal, msgs)


def seeded_mutation_factory(program: Program) -> SharedSegment:
    return SeededMutationSegment(
        program.num_pages * PAGE, PAGE, backing_addr=0, home_host=0, port=0,
        sid=0, consistency=program.consistency,
        wc_capacity=program.wc_capacity, race_detect="warn")


# ------------------------------------------------------- protocol enumerator
@dataclasses.dataclass
class EnumResult:
    """Exhaustive walk of a small Directory configuration."""

    num_hosts: int
    num_pages: int
    consistency: str
    wc_capacity: Optional[int]
    states: int
    transitions: int
    violations: List[str]

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> Dict[str, object]:
        return {
            "hosts": self.num_hosts, "pages": self.num_pages,
            "consistency": self.consistency,
            "wc_capacity": self.wc_capacity,
            "states": self.states, "transitions": self.transitions,
            "violations": len(self.violations), "ok": self.ok,
        }


def enumerate_protocol(num_hosts: int = 3, num_pages: int = 2,
                       consistency: str = RELEASE,
                       wc_capacity: Optional[int] = None,
                       max_states: int = 100_000) -> EnumResult:
    """BFS the *entire* reachable protocol state space of one small segment:
    every (directory, WC-order) configuration reachable by any sequence of
    per-host read/write/fence/detach ops, with ``Directory.check()`` and the
    pending-page invariant asserted after every transition. Complements the
    litmus corpus: programs reach corners, this proves there are no others."""
    if num_hosts > 3 or num_pages > 2:
        raise ValueError("enumerator is sized for <=3 hosts x <=2 pages")
    seg = SharedSegment(
        num_pages * PAGE, PAGE, backing_addr=0, home_host=0, port=0, sid=0,
        consistency=consistency, wc_capacity=wc_capacity, race_detect="off")
    violations: List[str] = []

    def key(state) -> Tuple:
        d, wc = state
        return (tuple(sorted((p, tuple(sorted(e.items())))
                             for p, e in d.items())),
                tuple(sorted((h, tuple(ps)) for h, ps in wc.items())))

    def capture():
        return (seg.directory.snapshot(),
                {h: list(ps) for h, ps in seg.wc.items() if ps})

    def restore(state) -> None:
        d, wc = state
        seg.directory.restore({p: dict(e) for p, e in d.items()})
        seg.wc = {h: dict.fromkeys(ps) for h, ps in wc.items()}

    def transitions():
        for host in range(num_hosts):
            for page in range(num_pages):
                yield (f"read(h{host}, p{page})",
                       lambda h=host, p=page: seg.plan_read(
                           None, h, p * PAGE, PAGE))
                yield (f"write(h{host}, p{page})",
                       lambda h=host, p=page: seg.plan_write(
                           None, h, p * PAGE, PAGE))
            yield (f"fence(h{host})",
                   lambda h=host: seg.plan_fence(None, h))
            yield (f"detach(h{host})",
                   lambda h=host: seg.plan_detach(None, h))

    start = capture()
    seen = {key(start)}
    frontier = [start]
    n_transitions = 0
    while frontier:
        state = frontier.pop()
        for label, fire in transitions():
            restore(state)
            n_transitions += 1
            try:
                fire()
                seg.directory.check()
            except CoherenceError as exc:
                violations.append(f"{label} from {key(state)}: {exc}")
                if len(violations) >= _MAX_VIOLATIONS:
                    frontier.clear()
                    break
                continue
            bad = _pending_invariant(seg)
            if bad is not None:
                violations.append(f"{label} from {key(state)}: {bad}")
                if len(violations) >= _MAX_VIOLATIONS:
                    frontier.clear()
                    break
                continue
            nxt = capture()
            k = key(nxt)
            if k not in seen:
                seen.add(k)
                if len(seen) > max_states:
                    violations.append(
                        f"state budget {max_states} exceeded (enumerator "
                        f"bug? last transition {label})")
                    frontier.clear()
                    break
                frontier.append(nxt)

    return EnumResult(
        num_hosts=num_hosts, num_pages=num_pages, consistency=consistency,
        wc_capacity=wc_capacity, states=len(seen),
        transitions=n_transitions, violations=violations)
