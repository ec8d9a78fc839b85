"""Hardware-coherent shared segments: a directory-based MESI-lite protocol.

CXL 3.0's headline feature over RDMA-era disaggregation is *hardware-coherent*
shared memory: several hosts map the same pooled bytes and the fabric keeps
their caches coherent with back-invalidations, instead of software copying
buffers around (CXL-DMSim, arXiv 2411.02282; the ETH CXL programming model,
arXiv 2407.16300). This module models that protocol at **page granularity**:

  * a ``SharedSegment`` is one pooled allocation that N emulated hosts attach
    to — the pool holds ONE copy of the bytes no matter how many hosts map it;
  * a ``Directory`` tracks per-(page, host) state, MESI-lite: ``M`` (modified,
    exclusive dirty copy in that host's cache), ``E`` (exclusive *clean* copy —
    a sole reader; upgrades to M silently, no RFO fetch), ``S`` (shared clean
    copy), invalid = absence of an entry;
  * state transitions emit **coherence messages** — back-invalidations, dirty
    writebacks, and read fetches — each sized and routed as a real transfer on
    the fabric (core/fabric.py), so coherence traffic contends with ordinary
    DMAs and shows up in link occupancy and modeled time.

Protocol events (what the planners return as routed messages):

  ============================  ==========================  ====================
  event                         trigger                     fabric route / size
  ============================  ==========================  ====================
  read fetch                    reader in I                 pool port -> reader
                                                            uplink, page bytes
  dirty-read forward            reader in I, peer holds M   owner uplink -> pool
                                (writeback M -> S first)    port, page bytes
  back-invalidation             writer upgrades, peer in    pool port -> peer
                                S/E                         uplink, MSG_BYTES
  dirty writeback + invalidate  writer upgrades, peer in M  peer uplink -> pool
                                                            port, page bytes
  write fetch (RFO)             writer in I                 pool port -> writer
                                                            uplink, page bytes
  silent E upgrade              writer in E (sole copy)     none — no fetch, no
                                                            invalidation
  ============================  ==========================  ====================

Cache hits (reader in M/E/S, writer in M) emit nothing and cost only the local
tier's DMA time — that asymmetry is exactly what makes false sharing visible:
two hosts alternately writing the same page ping-pong M between them, paying a
writeback + invalidation + fetch per write (an *invalidation storm*), while the
same writes to disjoint pages settle into silent M hits.

**Release consistency / write-combining** (``consistency="release"``): instead
of upgrading to M eagerly on every write, a fenced segment absorbs each host's
writes into a per-(segment, host) write-combining buffer (an LRU-ordered set
of pending pages) and only runs the M-upgrade protocol — invalidations,
writebacks, RFO fetches — when the host issues a ``fence()``. K writes to one
page between fences collapse into ONE upgrade, which is what defuses
false-sharing storms; the cost is the weaker model (peers may read stale bytes
until the fence, the CXL.mem analogue of releasing a lock). A host reading a
page it has write-combined sees its own pending store (store forwarding) — a
read hit, no fabric fetch.

The buffer is **capacity-bounded** (``wc_capacity`` pages per host, default
``DEFAULT_WC_CAPACITY``; ``None`` = unbounded): a real WC/snoop buffer is a
finite hardware structure, so when a host's pending set is full the next
distinct page forces a **partial drain** — the least-recently-written pending
page is evicted through the normal M-upgrade protocol (journaled like any
other planner mutation) and counted in ``forced_drains``/``forced_drain_pages``.
Shrinking the capacity slides release consistency continuously toward eager
MESI-lite: at ``wc_capacity=1`` nearly every distinct-page write drains its
predecessor, matching eager message counts to within the one-page lag.

**Transactional planning**: every directory/stats/write-buffer mutation the
planners make can be recorded in a ``DirectoryJournal``. ``OpQueue.flush``
plans a whole batch under one journal and, if planning fails mid-batch,
replays the journal in reverse — so a failed batch leaves the directory,
per-segment stats, and write-combining buffers byte-identical to the
pre-batch state (the async rollback guarantee the property tests pin).

The directory itself lives with the pool (the paper's switch-side metadata);
EmuCXL consults it inside the same lock that serializes all other operations,
so no separate synchronization is needed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .race import RaceDetector, resolve_mode
from .trace import TraceRecorder

MODIFIED = "M"
EXCLUSIVE = "E"
SHARED = "S"

EAGER = "eager"
RELEASE = "release"
_CONSISTENCY_MODES = (EAGER, RELEASE)

# Write-combining buffer depth (pages per host) a release segment gets unless
# share(..., wc_capacity=) overrides it. 64 entries is the scale of a real
# WC/snoop buffer; pass wc_capacity=None for the (pre-bound) unbounded model.
DEFAULT_WC_CAPACITY = 64

# Control-message payload for an invalidation (a snoop/back-invalidate carries a
# physical address + opcode — one flit, modeled as a cache line on the wire).
MSG_BYTES = 64


class CoherenceError(RuntimeError):
    pass


@dataclasses.dataclass
class CoherenceStats:
    """Cumulative protocol-event counts for one segment (and fleet-wide when
    summed across segments by ``EmuCXL.coherence_stats``)."""

    read_hits: int = 0
    write_hits: int = 0
    read_misses: int = 0
    write_misses: int = 0          # write needed an upgrade or a fetch
    invalidations: int = 0         # back-invalidations sent to S/E-state peers
    writebacks: int = 0            # dirty M pages flushed to the pool
    forwards: int = 0              # dirty-read forwards (reader hit a peer's M)
    e_upgrades: int = 0            # silent E -> M upgrades (no RFO, no inval)
    wc_writes: int = 0             # writes absorbed by a write-combining buffer
    fences: int = 0                # release fences that drained pending pages
    fence_coalesced: int = 0       # back-to-back fences folded into one drain
    acquires: int = 0              # acquire fences that synced on a peer release
    forced_drains: int = 0         # capacity evictions (full WC buffer)
    forced_drain_pages: int = 0    # pages upgraded early by forced drains
    races: int = 0                 # conflicts recorded by race_detect="warn"
    bytes_moved: int = 0           # page payloads moved by the protocol
    msg_bytes: int = 0             # control-message bytes (invalidations)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def merge(self, other: "CoherenceStats") -> "CoherenceStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self


@dataclasses.dataclass(frozen=True)
class CoherenceMsg:
    """One protocol message to route over the fabric: (links, payload bytes)."""

    path: Tuple[str, ...]
    nbytes: int
    kind: str                      # fetch | forward | invalidate | writeback


class DirectoryJournal:
    """Undo log for coherence mutations planned inside one transaction.

    The planners (``plan_read``/``plan_write``/``plan_fence``/``plan_detach``)
    mutate three kinds of modeled state: directory entries, stats counters, and
    write-combining buffers. When handed a journal, every mutation is recorded
    *before* it is applied; ``rollback()`` replays the log in reverse, restoring
    all three byte-identically. ``mark()``/``rollback(mark)`` supports partial
    unwind — ``OpQueue.flush`` uses per-op marks so an apply-phase failure only
    unwinds the ops that never took effect.
    """

    __slots__ = ("_entries",)

    def __init__(self):
        # ("dir", seg, page, host, old_state) | ("stat", seg, field, delta)
        # | ("wc+", seg, host, page) — page appended at the MRU end
        # | ("wc-", seg, host, page, pos) — page removed from LRU position pos
        # | ("wc~", seg, host, page, pos) — page moved from pos to the MRU end
        # | ("race-w", seg, page, old_epoch) — last-writer epoch overwritten
        # | ("race-vc", seg, host, old_row) — a host's vector clock replaced
        # | ("race-rel", seg, host, old_row) — a host's release snapshot
        # | ("race-log", seg, old_len, old_counts) — warn-mode reports appended
        self._entries: List[Tuple] = []

    def __len__(self) -> int:
        return len(self._entries)

    def mark(self) -> int:
        """Position token for partial rollback (see ``rollback``)."""
        return len(self._entries)

    def record_state(self, seg: "SharedSegment", page: int, host: int) -> None:
        self._entries.append(
            ("dir", seg, page, host, seg.directory.state(page, host)))

    def record_stat(self, seg: "SharedSegment", field: str, delta: int) -> None:
        self._entries.append(("stat", seg, field, delta))

    def record_wc_add(self, seg: "SharedSegment", host: int, page: int) -> None:
        self._entries.append(("wc+", seg, host, page))

    def record_wc_remove(self, seg: "SharedSegment", host: int, page: int,
                         pos: int) -> None:
        self._entries.append(("wc-", seg, host, page, pos))

    def record_wc_touch(self, seg: "SharedSegment", host: int, page: int,
                        pos: int) -> None:
        self._entries.append(("wc~", seg, host, page, pos))

    # Race-detector state is planner state too: journaled with deep-copied
    # old values so rollback restores clocks/epochs/logs byte-identically.
    def record_race_write(self, seg: "SharedSegment", page: int) -> None:
        self._entries.append(
            ("race-w", seg, page, seg.detector.write_epoch.get(page)))

    def record_race_vc(self, seg: "SharedSegment", host: int) -> None:
        row = seg.detector.vc.get(host)
        self._entries.append(
            ("race-vc", seg, host, None if row is None else dict(row)))

    def record_race_rel(self, seg: "SharedSegment", host: int) -> None:
        row = seg.detector.rel.get(host)
        self._entries.append(
            ("race-rel", seg, host, None if row is None else dict(row)))

    def record_race_log(self, seg: "SharedSegment") -> None:
        det = seg.detector
        self._entries.append(
            ("race-log", seg, len(det.races), dict(det.race_counts)))

    @staticmethod
    def _wc_insert_at(seg: "SharedSegment", host: int, page: int,
                      pos: int) -> None:
        """Re-place `page` at LRU position `pos` — rollback must restore the
        buffer's *order* byte-identically, or a replayed batch would evict a
        different victim than the original would have."""
        pending = seg.wc.setdefault(host, {})
        order = [p for p in pending if p != page]
        order.insert(pos, page)
        pending.clear()
        for p in order:
            pending[p] = None

    def rollback(self, to_mark: int = 0) -> None:
        """Undo every recorded mutation after `to_mark`, newest first."""
        while len(self._entries) > to_mark:
            entry = self._entries.pop()
            kind, seg = entry[0], entry[1]
            if kind == "dir":
                _, _, page, host, old_state = entry
                seg.directory.set_state(page, host, old_state)
            elif kind == "stat":
                _, _, field, delta = entry
                setattr(seg.stats, field, getattr(seg.stats, field) - delta)
            elif kind == "wc+":
                _, _, host, page = entry
                pending = seg.wc.get(host)
                if pending is not None:
                    pending.pop(page, None)
                    if not pending:
                        seg.wc.pop(host, None)
            elif kind == "race-w":
                _, _, page, old_epoch = entry
                seg.detector.restore_write(page, old_epoch)
            elif kind == "race-vc":
                _, _, host, old_row = entry
                seg.detector.restore_vc(host, old_row)
            elif kind == "race-rel":
                _, _, host, old_row = entry
                seg.detector.restore_rel(host, old_row)
            elif kind == "race-log":
                _, _, old_len, old_counts = entry
                seg.detector.restore_log(old_len, old_counts)
            else:  # "wc-" undoes a removal, "wc~" undoes a move-to-MRU: both
                # re-place the page at its recorded LRU position.
                _, _, host, page, pos = entry
                self._wc_insert_at(seg, host, page, pos)


class Directory:
    """Per-(page, host) M/E/S state for one segment.

    Sparse: pages nobody caches have no entry (all-invalid). At most one host
    may hold a page in M or E, and either excludes any other entry for that
    page — the class invariant ``check()`` enforces. ``check()`` runs after
    every planned coherence batch when ``EMUCXL_CHECK=1`` (CI's test job sets
    it) and in targeted protocol tests.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._state: Dict[int, Dict[int, str]] = {}

    def state(self, page: int, host: int) -> Optional[str]:
        return self._state.get(page, {}).get(host)

    def holders(self, page: int) -> Dict[int, str]:
        return dict(self._state.get(page, {}))

    def owner(self, page: int) -> Optional[int]:
        """The host holding `page` in M, if any."""
        for host, st in self._state.get(page, {}).items():
            if st == MODIFIED:
                return host
        return None

    def set_state(self, page: int, host: int, state: Optional[str]) -> None:
        entry = self._state.setdefault(page, {})
        if state is None:
            entry.pop(host, None)
            if not entry:
                self._state.pop(page, None)
        else:
            entry[host] = state

    def cached_pages(self, host: int) -> List[int]:
        return [p for p, e in self._state.items() if host in e]

    def snapshot(self) -> Dict[int, Dict[int, str]]:
        """Deep copy of all per-page holder maps (rollback-test oracle)."""
        return {p: dict(e) for p, e in self._state.items()}

    def restore(self, snap: Dict[int, Dict[int, str]]) -> None:
        """Overwrite every holder map from a ``snapshot()`` — state injection
        for the model checker's protocol enumerator (core/mc.py)."""
        self._state = {p: dict(e) for p, e in snap.items() if e}

    def check(self) -> None:
        for page, entry in self._state.items():
            for exclusive_state in (MODIFIED, EXCLUSIVE):
                owners = [h for h, st in entry.items() if st == exclusive_state]
                if len(owners) > 1:
                    raise CoherenceError(
                        f"page {page}: two {exclusive_state} owners {owners}")
                if owners and len(entry) > 1:
                    raise CoherenceError(
                        f"page {page}: {exclusive_state} at host {owners[0]} "
                        f"coexists with sharers "
                        f"{sorted(h for h in entry if h != owners[0])}"
                    )


class SharedSegment:
    """One hardware-coherent pooled region, attachable by any emulated host.

    Created by ``EmuCXL.share`` (v1) / ``CXLSession.share`` (v2). The segment
    owns the single pooled copy of the data (`backing_addr` names the pool
    allocation that pays the quota charge); each ``attach`` maps the same bytes
    for one host without charging the pool again — the bytes-saved side of the
    coherence trade that benchmarks/coherence_bench.py measures.

    Segment ids are scoped per owning ``EmuCXL`` instance (the library passes
    `sid` explicitly), so independent sessions and test runs both start at
    sid 0; the class-level counter only backs direct construction.
    """

    _next_id = itertools.count()

    def __init__(self, size: int, page_bytes: int, backing_addr: int,
                 home_host: int, port: int, sid: Optional[int] = None,
                 consistency: str = EAGER,
                 wc_capacity: Optional[int] = DEFAULT_WC_CAPACITY,
                 race_detect: Optional[str] = None,
                 home: Optional[object] = None):
        if page_bytes <= 0:
            raise CoherenceError(f"invalid page_bytes {page_bytes}")
        if consistency not in _CONSISTENCY_MODES:
            raise CoherenceError(
                f"unknown consistency {consistency!r}; options: "
                f"{list(_CONSISTENCY_MODES)}"
            )
        if wc_capacity is not None and wc_capacity < 1:
            raise CoherenceError(
                f"invalid wc_capacity {wc_capacity}; need >= 1 page per host "
                f"(or None for an unbounded buffer)"
            )
        try:
            race_mode = resolve_mode(race_detect)
        except ValueError as exc:
            raise CoherenceError(str(exc)) from None
        self.sid = next(SharedSegment._next_id) if sid is None else sid
        self.size = size
        self.page_bytes = page_bytes
        self.num_pages = -(-size // page_bytes)
        self.backing_addr = backing_addr
        self.home_host = home_host
        self.port = port
        # Directory home-node placement (core/policy.py DirectoryHomePolicy):
        # None keeps every page's directory home on the segment's own backing
        # port — the pre-sharding behavior. A policy shards the directory by
        # page, so protocol messages (RFO fetches, invalidations, writebacks,
        # fence drains) are charged over the route to each page's *own* home
        # switch port instead of all converging on one.
        self.home = home
        self.consistency = consistency
        self.wc_capacity = wc_capacity
        self.directory = Directory(self.num_pages)
        self.stats = CoherenceStats()
        # Release consistency: host -> pages written but not yet fenced (the
        # write-combining buffer; empty/absent for eager segments). The inner
        # dict is an *ordered set*: iteration order is LRU -> MRU write
        # recency, which picks the victim when the buffer hits wc_capacity.
        self.wc: Dict[int, Dict[int, None]] = {}
        # Happens-before race detector: release segments only ("eager" writes
        # publish immediately, so page-level staleness races cannot occur).
        self.race_detect = race_mode if consistency == RELEASE else "off"
        self.detector: Optional[RaceDetector] = (
            RaceDetector(self, race_mode)
            if consistency == RELEASE and race_mode != "off" else None)
        # Optional linearized-event recorder (core/trace.py): when attached
        # (EmuCXL.attach_tracer, or directly by the model checker), every
        # planner event — reads with observed write-epochs, upgrades, fences,
        # acquires — is appended to one totally-ordered trace.
        self.tracer: Optional[TraceRecorder] = None
        self.attachments: Set[int] = set()     # attachment addresses
        self.attached_hosts: Dict[int, int] = {}   # host -> attachment count
        self.destroyed = False
        # Writer weight charged to the placement policy at share() time; paid
        # back on destroy so port load doesn't accrete dead segments.
        self.placement_weight = 0

    # ------------------------------------------------------------------ geometry
    def pages_for(self, offset: int, n: int) -> range:
        if n <= 0:
            return range(0, 0)
        return range(offset // self.page_bytes,
                     (offset + n - 1) // self.page_bytes + 1)

    # ------------------------------------------------------------------ journaled mutators
    def _set(self, journal: Optional[DirectoryJournal], page: int, host: int,
             state: Optional[str]) -> None:
        if journal is not None:
            journal.record_state(self, page, host)
        self.directory.set_state(page, host, state)

    def _bump(self, journal: Optional[DirectoryJournal], field: str,
              amount: int = 1) -> None:
        if journal is not None:
            journal.record_stat(self, field, amount)
        setattr(self.stats, field, getattr(self.stats, field) + amount)

    # Write-combining buffer mutators: every change is journaled with enough
    # positional information to restore the LRU *order*, not just membership.
    def _wc_add(self, journal: Optional[DirectoryJournal], host: int,
                page: int) -> None:
        if journal is not None:
            journal.record_wc_add(self, host, page)
        self.wc.setdefault(host, {})[page] = None

    def _wc_remove(self, journal: Optional[DirectoryJournal], host: int,
                   page: int) -> None:
        pending = self.wc[host]
        if journal is not None:
            # The hot removals (forced-drain eviction, fence drain) always
            # take the LRU head — O(1); the list scan only runs off that path.
            pos = (0 if next(iter(pending)) == page
                   else list(pending).index(page))
            journal.record_wc_remove(self, host, page, pos)
        del pending[page]
        if not pending:
            self.wc.pop(host, None)

    def _wc_touch(self, journal: Optional[DirectoryJournal], host: int,
                  page: int) -> None:
        """Refresh `page` to most-recently-written (it stays pending)."""
        pending = self.wc[host]
        if next(reversed(pending)) == page:
            return
        if journal is not None:
            journal.record_wc_touch(self, host, page,
                                    list(pending).index(page))
        del pending[page]
        pending[page] = None

    # ------------------------------------------------------------------ protocol
    def home_port(self, page: int, pool_ports: Optional[int] = None) -> int:
        """The pool port owning `page`'s directory entry (its *home node*).

        With no ``home`` policy every page homes on the segment's backing
        port. `pool_ports` (the fabric's count) lets a sharding policy spread
        pages across every port of the topology, not just the backing one."""
        if self.home is None:
            return self.port
        ports = pool_ports if pool_ports is not None else self.port + 1
        return self.home.home_port(self.sid, page, ports)

    def _path(self, fabric, host: int, page: int) -> Tuple[str, ...]:
        """Fabric route between `host`'s cache and `page`'s home pool port.

        Without a fabric the path is empty — the message is still emitted so
        the caller can charge the uncontended hw-constant fallback for it."""
        if fabric is None:
            return ()
        return fabric.pool_path(host, self.home_port(page, fabric.pool_ports))

    # ------------------------------------------------------------------ tracing
    def _observed_epoch(self, page: int):
        """The write-epoch a read of `page` observes right now: the detector's
        last-writer epoch when a detector runs (journal-consistent across
        rollbacks), else the tracer's last recorded write event."""
        if self.detector is not None:
            epoch = self.detector.write_epoch.get(page)
            return None if epoch is None else (epoch[0], epoch[1])
        if self.tracer is not None:
            return self.tracer.observed_epoch(self.sid, page)
        return None

    def _trace(self, kind: str, host: int, page: Optional[int] = None,
               **detail) -> None:
        if self.tracer is not None:
            self.tracer.emit(kind, sid=self.sid, host=host, page=page,
                             **detail)

    def plan_read(self, fabric, host: int, offset: int, n: int,
                  journal: Optional[DirectoryJournal] = None
                  ) -> List[CoherenceMsg]:
        """Directory transitions + protocol messages for `host` reading a range.

        Mutates the directory (the read takes effect) and records every
        mutation in `journal` when one is supplied; the caller routes the
        returned messages over the fabric (or charges hw constants for
        empty-path messages when no fabric is attached)."""
        if self.detector is not None:
            # Checks run before any mutation: a strict-mode RaceError leaves
            # the directory, stats, and clocks untouched even without a
            # journal (the sync paths rely on this).
            self.detector.on_read(
                host, self.pages_for(offset, n),
                f"host {host} read [{offset}, {offset + n})", journal)
        msgs: List[CoherenceMsg] = []
        d = self.directory
        for page in self.pages_for(offset, n):
            st = d.state(page, host)
            if st in (MODIFIED, EXCLUSIVE, SHARED):
                self._bump(journal, "read_hits")
                self._trace("read", host, page, outcome="hit",
                            epoch=self._observed_epoch(page))
                continue
            if page in self.wc.get(host, ()):
                # Store forwarding: the host is reading bytes it has
                # write-combined but not yet fenced — its own pending store is
                # the freshest copy, so there is nothing to fetch. (Without
                # this, a host paid a fabric fetch for bytes it just wrote.)
                self._bump(journal, "read_hits")
                self._trace("read", host, page, outcome="store-forward",
                            epoch=self._observed_epoch(page))
                continue
            self._bump(journal, "read_misses")
            self._trace("read", host, page, outcome="miss",
                        epoch=self._observed_epoch(page))
            owner = d.owner(page)
            if owner is not None and owner != host:
                # Dirty-read forward: the owner's cache has the only fresh copy;
                # it is written back through the owner's uplink and the owner
                # downgrades M -> S before the reader's fetch.
                self._bump(journal, "forwards")
                self._bump(journal, "writebacks")
                self._bump(journal, "bytes_moved", self.page_bytes)
                msgs.append(CoherenceMsg(
                    self._path(fabric, owner, page), self.page_bytes,
                    "forward"))
                self._set(journal, page, owner, SHARED)
            else:
                # A clean exclusive peer silently downgrades (its copy stays
                # valid, memory is up to date — no message needed).
                for peer, peer_st in d.holders(page).items():
                    if peer != host and peer_st == EXCLUSIVE:
                        self._set(journal, page, peer, SHARED)
            self._bump(journal, "bytes_moved", self.page_bytes)
            msgs.append(CoherenceMsg(
                self._path(fabric, host, page), self.page_bytes, "fetch"))
            # Sole reader lands in E (upgradeable without an RFO); any company
            # means S.
            others = any(h != host for h in d.holders(page))
            self._set(journal, page, host, SHARED if others else EXCLUSIVE)
        return msgs

    def _upgrade(self, fabric, host: int, page: int,
                 journal: Optional[DirectoryJournal],
                 msgs: List[CoherenceMsg]) -> None:
        """Take M on one page for `host`: the shared core of an eager write
        miss and a fence drain. Appends this upgrade's protocol messages."""
        d = self.directory
        st = d.state(page, host)
        if st == MODIFIED:
            return
        self._trace("upgrade", host, page, from_state=st)
        if st == EXCLUSIVE:
            # Sole clean copy: silent upgrade — the E state's whole purpose.
            self._bump(journal, "e_upgrades")
            self._set(journal, page, host, MODIFIED)
            return
        self._bump(journal, "write_misses")
        for peer, peer_st in d.holders(page).items():
            if peer == host:
                continue
            if peer_st == MODIFIED:
                # Peer holds the only fresh copy: flush it to the pool,
                # then invalidate — the expensive half of false sharing.
                self._bump(journal, "writebacks")
                self._bump(journal, "bytes_moved", self.page_bytes)
                msgs.append(CoherenceMsg(
                    self._path(fabric, peer, page), self.page_bytes,
                    "writeback"))
            self._bump(journal, "invalidations")
            self._bump(journal, "msg_bytes", MSG_BYTES)
            msgs.append(CoherenceMsg(
                self._path(fabric, peer, page), MSG_BYTES, "invalidate"))
            self._set(journal, page, peer, None)
        if st is None:
            # Read-for-ownership: the writer needs the page's current bytes
            # before modifying part of it.
            self._bump(journal, "bytes_moved", self.page_bytes)
            msgs.append(CoherenceMsg(
                self._path(fabric, host, page), self.page_bytes, "fetch"))
        self._set(journal, page, host, MODIFIED)

    def plan_write(self, fabric, host: int, offset: int, n: int,
                   journal: Optional[DirectoryJournal] = None
                   ) -> List[CoherenceMsg]:
        """Directory transitions + protocol messages for `host` writing a range.

        Eager segments upgrade to M immediately (invalidations/writebacks per
        page); release segments absorb non-M/E pages into the host's
        write-combining buffer and emit nothing until ``plan_fence`` — unless
        the buffer is at ``wc_capacity``, in which case the least-recently
        written pending page is force-drained through the normal upgrade
        protocol to make room (a real WC buffer's capacity eviction)."""
        if self.detector is not None:
            self.detector.on_write(
                host, self.pages_for(offset, n),
                f"host {host} write [{offset}, {offset + n})", journal)
        msgs: List[CoherenceMsg] = []
        d = self.directory
        for page in self.pages_for(offset, n):
            st = d.state(page, host)
            if st == MODIFIED:
                self._bump(journal, "write_hits")
                self._trace("write", host, page, outcome="hit")
                continue
            if st == EXCLUSIVE:
                self._bump(journal, "write_hits")
                self._trace("write", host, page, outcome="e-upgrade")
                self._upgrade(fabric, host, page, journal, msgs)
                continue
            if self.consistency == RELEASE:
                pending = self.wc.get(host)
                if pending is not None and page in pending:
                    self._wc_touch(journal, host, page)
                    self._bump(journal, "wc_writes")
                    self._trace("write", host, page, outcome="wc-touch")
                    continue
                if (self.wc_capacity is not None and pending is not None
                        and len(pending) >= self.wc_capacity):
                    victim = next(iter(pending))     # LRU pending page
                    self._wc_remove(journal, host, victim)
                    self._bump(journal, "forced_drains")
                    self._bump(journal, "forced_drain_pages")
                    self._trace("forced-drain", host, victim)
                    self._upgrade(fabric, host, victim, journal, msgs)
                self._wc_add(journal, host, page)
                self._bump(journal, "wc_writes")
                self._trace("write", host, page, outcome="wc-buffered")
                continue
            self._trace("write", host, page, outcome="eager")
            self._upgrade(fabric, host, page, journal, msgs)
        return msgs

    def plan_fence(self, fabric, host: int,
                   journal: Optional[DirectoryJournal] = None
                   ) -> List[CoherenceMsg]:
        """Release fence: drain `host`'s write-combining buffer.

        Every pending page runs the M-upgrade protocol exactly once — however
        many writes it absorbed since the last fence — and the buffer empties,
        draining in LRU order (so each journaled removal is the O(1) head).
        No-op (and uncounted) when nothing is pending, so fencing an eager
        segment is free."""
        if self.detector is not None:
            # The release edge exists even when the buffer is empty — a forced
            # capacity drain may have published the bytes early, but only the
            # fence opens a new epoch peers can acquire.
            self.detector.on_release(host, journal)
        msgs: List[CoherenceMsg] = []
        pending = self.wc.get(host)
        self._trace("fence", host,
                    pending=tuple(pending) if pending else ())
        if not pending:
            return msgs
        for page in list(pending):
            self._wc_remove(journal, host, page)
            self._upgrade(fabric, host, page, journal, msgs)
        self._bump(journal, "fences")
        return msgs

    def plan_acquire(self, host: int,
                     journal: Optional[DirectoryJournal] = None
                     ) -> List[CoherenceMsg]:
        """Acquire barrier: join every peer's published release snapshot into
        `host`'s view. Pure synchronization — no directory traffic, no stat
        (the `acquires` counter belongs to the async batch scheduler, which
        bumps it once per *flush* that carries an acquire edge)."""
        self._trace("acquire", host)
        if self.detector is not None:
            self.detector.on_acquire(host, journal)
        return []

    def pending_pages(self, host: Optional[int] = None) -> int:
        """Write-combined pages awaiting a fence (for one host, or all)."""
        if host is not None:
            return len(self.wc.get(host, ()))
        return sum(len(p) for p in self.wc.values())

    def plan_detach(self, fabric, host: int,
                    journal: Optional[DirectoryJournal] = None
                    ) -> List[CoherenceMsg]:
        """Flush `host` out of the directory: pending write-combined pages are
        fenced first (detach is a release point), dirty pages write back, clean
        entries just drop. Called when an attachment is released."""
        self._trace("detach", host)
        msgs = self.plan_fence(fabric, host, journal)
        d = self.directory
        for page in d.cached_pages(host):
            if d.state(page, host) == MODIFIED:
                self._bump(journal, "writebacks")
                self._bump(journal, "bytes_moved", self.page_bytes)
                msgs.append(CoherenceMsg(
                    self._path(fabric, host, page), self.page_bytes,
                    "writeback"))
            self._set(journal, page, host, None)
        return msgs

    # ------------------------------------------------------------------ queries
    def sharers(self, page: int) -> List[int]:
        return sorted(self.directory.holders(page))

    def preflight_view(self) -> Dict[str, object]:
        """Read-only footprint snapshot for the plan-time batch verifier
        (``repro_torch.core.verify``): geometry, per-host pending WC pages (LRU
        order), per-host M/E-held pages (writes to these bypass the WC
        buffer), and the detector's clock/epoch state when one is armed.
        Every container is freshly built — the verifier can never mutate
        live directory, WC, stats, or detector state through it."""
        held: Dict[int, List[int]] = {}
        for page, entry in self.directory._state.items():
            for host, st in entry.items():
                if st in (MODIFIED, EXCLUSIVE):
                    held.setdefault(host, []).append(page)
        det = self.detector
        return {
            "sid": self.sid,
            "consistency": self.consistency,
            "wc_capacity": self.wc_capacity,
            "page_bytes": self.page_bytes,
            "num_pages": self.num_pages,
            "pending": {h: tuple(ps) for h, ps in self.wc.items() if ps},
            "held": {h: tuple(sorted(ps)) for h, ps in held.items()},
            "write_epoch": ({p: (w, c) for p, (w, c, _site)
                             in det.write_epoch.items()} if det else {}),
            "vc": ({h: dict(row) for h, row in det.vc.items()}
                   if det else {}),
            "rel": ({h: dict(row) for h, row in det.rel.items()}
                    if det else {}),
        }

    def describe(self) -> Dict[str, object]:
        return {
            "sid": self.sid,
            "size": self.size,
            "page_bytes": self.page_bytes,
            "num_pages": self.num_pages,
            "home_host": self.home_host,
            "port": self.port,
            "home": (None if self.home is None
                     else type(self.home).__name__),
            "consistency": self.consistency,
            "wc_capacity": self.wc_capacity,
            "race_detect": self.race_detect,
            "pending_pages": self.pending_pages(),
            "attached_hosts": sorted(self.attached_hosts),
            "stats": self.stats.as_dict(),
        }


def total_stats(segments: Iterable[SharedSegment]) -> CoherenceStats:
    out = CoherenceStats()
    for seg in segments:
        out.merge(seg.stats)
    return out
