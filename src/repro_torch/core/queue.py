"""emucxl queues: the paper's linked-list demo and the v2 async operation queue.

``EmuQueue`` (paper §IV-A, Listing 1) is the direct-access usage demo: each node is
its own ``emucxl_alloc`` on the queue's configured tier, and the list is threaded
through the emulated address space — `next` pointers are emucxl addresses stored
*inside* node payloads, so every traversal is a real read from the (possibly
remote) memory space. Node layout (16 bytes): int64 data | int64 next (0 == NULL).

``OpQueue`` is the v2 session scheduler (beyond the paper, toward CXL 3.0's queued
transactions): ``CXLSession.submit`` enqueues read/write/migrate/memcpy/memset/
fence/acquire operations as Future-style ``Ticket``s, and ``flush()`` completes
the whole batch at once on the discrete-event engine (``core/engine.py``): each
op becomes a job whose fabric transfers begin the instant its dependencies
resolve, so concurrent ops — e.g. eight hosts migrating simultaneously —
genuinely contend for links and the batch makespan reflects overlap, not the
serial sum a loop of v1 calls would charge. Ops without a fabric path fall back
to the uncontended hw constants and are summed serially (there is no contention
model to overlap them under).

**Streams and fences**: a ``FenceOp`` is a release point, not just another op,
and an ``AcquireOp`` is its read-side pair. Flush builds a per-(segment, host)
*stream* dependency graph and executes it on the discrete-event engine
(``core/engine.py``): an op waits only on its own streams' preceding fence
drain (and an acquire on its segment's prior peer releases) — never on
unrelated streams' traffic, which is what a CXL switch's queued transactions
actually permit. Back-to-back fences on one stream with no intervening write
coalesce into one drain (the ``fence_coalesced`` stat): the second fence has
nothing left to publish. An acquire with no prior peer release in the batch
synchronizes with nothing and costs nothing.

Batch semantics: costs are planned against start-of-batch placement (the ops are
"concurrent" up to fence ordering); data effects apply in submission order, so a
read submitted after a write of the same buffer observes it — per-host program
order within a segment is preserved regardless of how the schedule overlaps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import emucxl as ecxl
from repro_torch.core import verify
from repro_torch.core.engine import SimulationEngine

_NODE_BYTES = 16
_NULL = 0


def _pack(data: int, next_addr: int) -> np.ndarray:
    return np.array([data, next_addr], dtype=np.int64).view(np.uint8)


def _unpack(raw: np.ndarray):
    vals = raw.view(np.int64)
    return int(vals[0]), int(vals[1])


class EmuQueue:
    """Singly linked FIFO queue whose nodes live in emucxl-managed memory."""

    def __init__(self, policy: int, lib: Optional[ecxl.EmuCXL] = None):
        if policy not in (ecxl.LOCAL_MEMORY, ecxl.REMOTE_MEMORY):
            raise ValueError("policy must be 0 (local) or 1 (remote)")
        self.policy = policy
        self.lib = lib if lib is not None else ecxl.default_instance()
        self.front = _NULL
        self.rear = _NULL
        self.count = 0

    # -- Listing 1: createNode --------------------------------------------------
    def _create_node(self, data: int) -> int:
        addr = self.lib.alloc(_NODE_BYTES, self.policy)
        self.lib.write(_pack(data, _NULL), 0, addr)
        return addr

    def enqueue(self, data: int) -> bool:
        newnode = self._create_node(data)
        if self.front == _NULL and self.rear == _NULL:
            self.front = self.rear = newnode
        else:
            rdata, _ = _unpack(self.lib.read(self.rear, 0, _NODE_BYTES))
            self.lib.write(_pack(rdata, newnode), 0, self.rear)
            self.rear = newnode
        self.count += 1
        return True

    def dequeue(self) -> Optional[int]:
        if self.front == _NULL and self.rear == _NULL:
            return None
        data, nxt = _unpack(self.lib.read(self.front, 0, _NODE_BYTES))
        temp = self.front
        self.front = nxt
        if self.front == _NULL:
            self.rear = _NULL
        self.lib.free(temp, _NODE_BYTES)
        self.count -= 1
        return data

    def destroy(self) -> None:
        while self.dequeue() is not None:
            pass

    def __len__(self) -> int:
        return self.count


# =====================================================================
# v2 async operation queue (CXLSession.submit / flush)
# =====================================================================

@dataclasses.dataclass
class ReadOp:
    """DMA `size` bytes at `offset` out of `buf` (size=None: to end of buffer)."""

    buf: Any
    offset: int = 0
    size: Optional[int] = None


@dataclasses.dataclass
class WriteOp:
    """DMA `data` (coerced to uint8) into `buf` at `offset`."""

    buf: Any
    data: Any = None
    offset: int = 0
    size: Optional[int] = None


@dataclasses.dataclass
class MigrateOp:
    """Move `buf` to (node, host). The handle survives; only the address moves."""

    buf: Any
    node: int = ecxl.REMOTE_MEMORY
    host: Optional[int] = None


@dataclasses.dataclass
class MemcpyOp:
    """Copy `size` bytes from `src` into `dst` (cross-tier/cross-host aware)."""

    dst: Any
    src: Any
    size: int = 0


@dataclasses.dataclass
class MemsetOp:
    """Fill the first `size` bytes of `buf` with `value` (size=None: whole buffer)."""

    buf: Any
    value: int = 0
    size: Optional[int] = None


@dataclasses.dataclass
class FenceOp:
    """Release fence on `buf`'s shared segment for `buf`'s host: drain the
    write-combining buffer, emitting the batched invalidations/writebacks as
    part of this batch's overlapped fabric span."""

    buf: Any


@dataclasses.dataclass
class AcquireOp:
    """Acquire fence on `buf`'s shared segment for `buf`'s host: block this
    (segment, host) stream until every peer release fence planned earlier in
    the batch has drained its write-combined pages. With no prior peer release
    in the batch it is a pure no-op — nothing to synchronize with, zero
    modeled charge."""

    buf: Any


class Ticket:
    """Future-style completion token for one submitted operation.

    ``result()`` forces a flush of the owning queue if the batch has not been
    completed yet, then returns the op's value (ndarray for reads, the Buffer for
    migrate/memset, True for writes/memcpy/fences/acquires) or re-raises the
    batch failure.
    ``modeled_time`` is this op's own modeled duration inside the batch — its
    transfers' fabric span plus fallback charges, or for an ``AcquireOp`` the
    virtual seconds its stream stalled on peer releases. The batch *makespan*
    (what a caller actually waits) is returned by ``flush()``.
    """

    __slots__ = ("op", "_queue", "_state", "_value", "_error", "modeled_time")

    def __init__(self, op, queue: "OpQueue"):
        self.op = op
        self._queue = queue
        self._state = "pending"
        self._value = None
        self._error: Optional[BaseException] = None
        self.modeled_time = 0.0

    def done(self) -> bool:
        return self._state != "pending"

    def result(self):
        if self._state == "pending":
            self._queue.flush()
        if self._state == "failed":
            raise self._error
        return self._value

    def _complete(self, value, modeled_time: float) -> None:
        self._value = value
        self.modeled_time = modeled_time
        self._state = "done"

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._state = "failed"

    def __repr__(self) -> str:
        return f"Ticket({type(self.op).__name__}, {self._state})"


@dataclasses.dataclass
class _Plan:
    """Flush-time execution plan for one ticket (internal)."""

    kind: str               # noop|read|write|migrate|memcpy|memset|fence|acquire
    buf: Any = None                 # primary buffer handle (dst for memcpy)
    src: Any = None                 # source handle (memcpy only)
    # Fabric routes this op wants: (link path, payload bytes). They are NOT
    # begun at plan time — flush's engine begins them the instant the op's
    # dependencies resolve, filling `transfers` with the in-flight Transfers.
    routes: List[Tuple[Tuple[str, ...], int]] = dataclasses.field(
        default_factory=list)
    transfers: List[Any] = dataclasses.field(default_factory=list)
    # Uncontended fallback charges: (tier, seconds) — the same per-tier split
    # the sync path charges (EmuCXL._AccessPlan), so parity holds exactly.
    hw_charges: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    n: int = 0
    offset: int = 0
    data: Optional[np.ndarray] = None
    value_byte: int = 0
    node: int = 0                   # migrate destination
    staged_addr: Optional[int] = None   # migrate destination allocation
    # Stream bookkeeping: the (sid, host) streams this op belongs to (a
    # memcpy may touch two), the subset it *writes*, the coalescing metadata
    # for fences, and the dependency edges flush wired for the engine.
    streams: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    write_streams: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    segment: Any = None             # fence/acquire target segment
    fence_drained: int = 0          # pages this fence drained (0 = no-op fence)
    # Plans this op must wait on before its transfers may enter the fabric:
    # the last draining fence/synchronizing acquire on each of its streams,
    # plus (for an acquire) the batch's prior peer release fences.
    deps: List["_Plan"] = dataclasses.field(default_factory=list)
    acquired: int = 0               # peer release fences this acquire synced on
    acquire_wait: float = 0.0       # virtual seconds this acquire blocked for
    # Coherence-journal position before this op planned: an apply-phase failure
    # unwinds the journal back to the first failed op's mark.
    journal_mark: int = 0

    @property
    def hw_time(self) -> float:
        return sum(t for _, t in self.hw_charges)

    def adopt(self, access_plan) -> "_Plan":
        """Adopt a lib ``_AccessPlan``: carry its fallback charges and queue
        its fabric routes for the event engine."""
        self.hw_charges.extend(access_plan.hw_charges)
        self.routes.extend(access_plan.routes)
        return self


class OpQueue:
    """FIFO of pending ops for one session, completed in contention-aware batches.

    Handle validity is checked at ``submit`` time (the API boundary) so stale
    handles fail fast; placement-dependent costs are planned at ``flush`` time
    against start-of-batch placement; data effects apply in submission order.
    """

    def __init__(self, session):
        self._session = session
        self._pending: List[Ticket] = []
        self.batches_flushed = 0
        self.ops_completed = 0

    def __len__(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------------ submit
    def _check_buf(self, buf) -> None:
        if getattr(buf, "session", None) is not self._session:
            raise ecxl.EmuCXLError(
                "operation references a buffer from a different session"
            )
        buf.address  # resolves the handle: raises StaleHandleError if invalid

    def submit(self, op) -> Ticket:
        with self._session.lib._lock:
            return self._submit_locked(op)

    def _submit_locked(self, op) -> Ticket:
        if isinstance(op, MemcpyOp):
            self._check_buf(op.dst)
            self._check_buf(op.src)
        elif isinstance(op, (ReadOp, WriteOp, MigrateOp, MemsetOp, FenceOp,
                             AcquireOp)):
            self._check_buf(op.buf)
            if isinstance(op, WriteOp):
                # Snapshot the payload now: the ticket is Future-style, so the
                # caller may legitimately reuse its staging array after submit.
                op.data = np.array(op.data, dtype=np.uint8, copy=True).reshape(-1)
        else:
            raise ecxl.EmuCXLError(f"unknown operation type {type(op).__name__}")
        ticket = Ticket(op, self)
        self._pending.append(ticket)
        return ticket

    def cancel(self, ticket: Ticket) -> None:
        """Withdraw a still-pending ticket from the queue (batch-staging unwind).

        No-op if the ticket already flushed; the cancelled ticket fails with a
        cancellation error so a later result() cannot silently return None."""
        with self._session.lib._lock:
            if ticket in self._pending:
                self._pending.remove(ticket)
                ticket._fail(ecxl.EmuCXLError("operation cancelled before flush"))

    # ------------------------------------------------------------------ planning
    @staticmethod
    def _stream_of(rec) -> List[Tuple[int, int]]:
        """The (sid, host) fence stream a record belongs to ([] if private)."""
        if rec.segment is None:
            return []
        return [(rec.segment.sid, rec.host)]

    def _plan_one(self, lib, fabric, op, journal) -> _Plan:
        hw = lib.hw
        if isinstance(op, MigrateOp):
            rec = lib._resolve(op.buf.address)
            lib._check_mobile(rec)
            lib._check_node(op.node)
            target_host = rec.host if op.host is None else op.host
            lib._check_host(target_host)
            if op.node == rec.node and target_host == rec.host:
                lib._touch(rec)
                return _Plan("noop", buf=op.buf)
            new_addr = lib.alloc(rec.size, op.node, target_host)
            new_rec = lib._allocs[new_addr]
            plan = _Plan("migrate", buf=op.buf, n=rec.size, node=op.node,
                         staged_addr=new_addr)
            # Route resolution happens HERE, at plan time: the topology router
            # (fabric.pool_path -> Topology.route) pins the ordered link path —
            # including the ECMP spine choice on multi-path fabrics — before
            # the event engine runs, so a batch's routes are deterministic
            # regardless of execution interleaving.
            path = lib._fabric_path(rec, op.node, target_host, new_rec.port)
            if path is not None:
                plan.routes.append((path, rec.size))
            elif op.node != rec.node or op.node == ecxl.LOCAL_MEMORY:
                plan.hw_charges.append(
                    (ecxl.REMOTE_MEMORY, hw.migrate_time(rec.size)))
            return plan
        # The remaining ops share the sync calls' bounds/validation/accounting
        # core (EmuCXL._plan_dma/_plan_copy) — one attribution rule, two
        # execution styles.
        if isinstance(op, MemcpyOp):
            drec = lib._resolve(op.dst.address)
            srec = lib._resolve(op.src.address)
            plan = _Plan("memcpy", buf=op.dst, src=op.src, n=op.size)
            plan.write_streams = self._stream_of(drec)
            plan.streams = plan.write_streams + [
                s for s in self._stream_of(srec)
                if s not in plan.write_streams]
            return plan.adopt(lib._plan_copy(srec, drec, op.size, journal))
        rec = lib._resolve(op.buf.address)
        stream = self._stream_of(rec)
        if isinstance(op, FenceOp):
            plan = _Plan("fence", buf=op.buf, streams=stream,
                         segment=rec.segment)
            if rec.segment is not None:
                plan.fence_drained = rec.segment.pending_pages(rec.host)
            return plan.adopt(lib._plan_fence(rec, journal))
        if isinstance(op, AcquireOp):
            if rec.segment is None:
                raise ecxl.EmuCXLError(
                    f"address {rec.address:#x} is not a shared-segment "
                    f"mapping; acquire targets coherent attachments"
                )
            # No protocol traffic of its own: the waiting (if any) is pure
            # ordering, wired by flush as dependencies on the batch's prior
            # peer release fences. plan_acquire joins every peer release
            # published up to this point in plan (== program) order, journaled
            # so a failed batch rolls the clocks back.
            rec.segment.plan_acquire(rec.host, journal)
            return _Plan("acquire", buf=op.buf, streams=stream,
                         segment=rec.segment)
        if isinstance(op, ReadOp):
            n = (rec.size - op.offset) if op.size is None else op.size
            plan = _Plan("read", buf=op.buf, n=n, offset=op.offset,
                         streams=stream)
            write = False
        elif isinstance(op, WriteOp):
            flat = np.asarray(op.data, dtype=np.uint8).reshape(-1)
            n = op.size if op.size is not None else flat.size
            lib._validate_payload(flat, n)
            plan = _Plan("write", buf=op.buf, n=n, offset=op.offset, data=flat,
                         streams=stream, write_streams=stream)
            write = True
        else:  # MemsetOp
            n = rec.size if op.size is None else op.size
            plan = _Plan("memset", buf=op.buf, n=n, value_byte=op.value & 0xFF,
                         streams=stream, write_streams=stream)
            write = True
        return plan.adopt(
            lib._plan_dma(rec, plan.offset, plan.n, write=write,
                          journal=journal))

    # ------------------------------------------------------------------ preflight
    def _preflight_descs(self, lib, tickets) -> Tuple[list, dict]:
        """Reduce pending tickets to verifier descriptors plus read-only
        segment views — the same footprint math ``_plan_one`` uses, with no
        directory/WC/stats/detector mutation anywhere on the path."""
        descs: list = []
        views: dict = {}

        def view_of(seg):
            if seg is not None and seg.sid not in views:
                views[seg.sid] = verify.SegmentView(**seg.preflight_view())
            return seg

        for t in tickets:
            op = t.op
            label = type(op).__name__
            try:
                if isinstance(op, MigrateOp):
                    rec = lib._resolve(op.buf.address)
                    target = rec.host if op.host is None else op.host
                    if (rec.segment is not None
                            or (op.node == rec.node and target == rec.host)):
                        # Shared mappings cannot migrate (planning raises on
                        # its own) and same-placement migrates are no-ops:
                        # neither stages an allocation.
                        descs.append(verify.OpDesc(kind="noop", label=label))
                    else:
                        descs.append(verify.OpDesc(
                            kind="migrate", host=target, node=op.node,
                            size=rec.size, label=label))
                    continue
                if isinstance(op, MemcpyOp):
                    drec = lib._resolve(op.dst.address)
                    srec = lib._resolve(op.src.address)
                    dseg = view_of(drec.segment)
                    sseg = view_of(srec.segment)
                    n = op.size
                    descs.append(verify.OpDesc(
                        kind="memcpy",
                        sid=dseg.sid if dseg else None, host=drec.host,
                        pages=(tuple(dseg.pages_for(0, n)) if dseg else ()),
                        src_sid=sseg.sid if sseg else None,
                        src_host=srec.host,
                        src_pages=(tuple(sseg.pages_for(0, n))
                                   if sseg else ()),
                        label=label))
                    continue
                rec = lib._resolve(op.buf.address)
                seg = view_of(rec.segment)
                sid = seg.sid if seg else None
                if isinstance(op, FenceOp):
                    kind, pages = "fence", ()
                elif isinstance(op, AcquireOp):
                    kind, pages = "acquire", ()
                elif isinstance(op, ReadOp):
                    n = (rec.size - op.offset) if op.size is None else op.size
                    kind = "read"
                    pages = tuple(seg.pages_for(op.offset, n)) if seg else ()
                elif isinstance(op, WriteOp):
                    n = op.size if op.size is not None else int(op.data.size)
                    kind = "write"
                    pages = tuple(seg.pages_for(op.offset, n)) if seg else ()
                else:                                        # MemsetOp
                    n = rec.size if op.size is None else op.size
                    kind = "memset"
                    pages = tuple(seg.pages_for(0, n)) if seg else ()
                descs.append(verify.OpDesc(
                    kind=kind, sid=sid, host=rec.host, pages=pages,
                    label=label))
            except Exception:
                # Stale handle / bad bounds: planning will surface the real
                # error with full rollback; preflight just skips the op.
                descs.append(verify.OpDesc(kind="noop", label=label))
        return descs, views

    def _preflight_check(self, lib, tickets) -> "verify.PreflightResult":
        descs, views = self._preflight_descs(lib, tickets)
        pool = lib._pool
        pool_view = verify.PoolView(
            pool_free=pool.free,
            quota_free={
                h: (None if pool.quota(h) is None
                    else pool.quota(h) - pool.used_by_host[h])
                for h in range(lib.num_hosts)},
            local_free={h: lib._local_capacity - lib._used_local[h]
                        for h in range(lib.num_hosts)},
        )
        return verify.verify_batch(descs, views, pool_view)

    # ------------------------------------------------------------------ apply
    def _apply_one(self, lib, plan: _Plan):
        """Apply one op's data effect; handles are re-resolved so earlier ops in
        the same batch (e.g. a migrate) are observed."""
        if plan.kind == "noop":
            return plan.buf
        if plan.kind in ("fence", "acquire"):
            # The protocol work happened at plan time (directory upgrades) and
            # in the batch's fabric span; neither fence side has a data effect
            # of its own (an acquire is pure ordering).
            lib._touch(lib._resolve(plan.buf.address))
            return True
        if plan.kind == "migrate":
            rec = lib._resolve(plan.buf.address)
            new_rec = lib._allocs[plan.staged_addr]
            new_rec.data.copy_(rec.data)
            lib.free(rec.address)
            table = plan.buf.session._table
            table.update_address(*plan.buf.handle, plan.staged_addr)
            return plan.buf
        if plan.kind == "memcpy":
            drec = lib._resolve(plan.buf.address)
            srec = lib._resolve(plan.src.address)
            sstore, dstore = lib._storage_rec(srec), lib._storage_rec(drec)
            dstore.data[: plan.n].copy_(sstore.data[: plan.n])
            lib._touch(drec)
            lib._touch(srec)
            return True
        rec = lib._resolve(plan.buf.address)
        store = lib._storage_rec(rec)
        lib._touch(rec)
        if plan.kind == "read":
            return store.data[plan.offset : plan.offset + plan.n].to(
                "cpu", copy=True).numpy()
        if plan.kind == "write":
            store.data[plan.offset : plan.offset + plan.n].copy_(
                torch.tensor(plan.data[: plan.n]))
            return True
        store.data[: plan.n].fill_(plan.value_byte)  # memset
        return plan.buf

    # ------------------------------------------------------------------ flush
    def flush(self, only: Optional[List[Ticket]] = None,
              preflight: Optional[str] = None) -> float:
        """Complete every pending op as ONE overlapped batch; returns the modeled
        makespan (virtual seconds the whole batch occupies). With `only`, flush
        just those still-pending tickets (in submission order) and leave the
        rest queued — ``CXLSession.migrate_batch`` scopes itself this way so it
        never drains unrelated ops into its own makespan.

        Fabric-routed ops execute on the **discrete-event engine**
        (``core/engine.py``) under a per-(segment, host)-stream dependency
        graph: an op's transfers enter the fabric the instant the last
        draining ``FenceOp`` (or synchronizing ``AcquireOp``) on its *own*
        streams completes — never later, and never because an unrelated
        stream fenced. An ``AcquireOp`` additionally waits on its segment's
        prior peer release fences in the batch, which is the read-side
        guarantee of release consistency; with no prior peer release it
        depends on nothing and is free. Dependency-free ops all begin at the
        batch's start instant and share link bandwidth exactly as concurrent
        hosts would; a batch with no fences therefore reproduces the single
        begin-all-then-drain schedule (and its modeled times) bit for bit.
        Fallback (uncontended) ops are summed serially and overlap with the
        fabric span, since they occupy different modeled resources (HBM/local
        engines vs fabric links). A fence that drains nothing creates no
        dependency edge; if it trails another fence on its stream with no
        intervening write, the pair coalesces into one drain
        (``fence_coalesced``).

        modeled_time convention: the overlapped fabric span is charged once to
        REMOTE_MEMORY (the fabric engine's counter, matching ``migrate_batch``),
        even when a routed op's endpoints are both LOCAL — the overlap makes a
        per-tier split ill-defined. Fallback ops charge their own tier, exactly
        like their synchronous counterparts.

        Every coherence-directory transition (and stats / write-combining
        mutation) planned by the batch is recorded in a ``DirectoryJournal``;
        if planning fails mid-batch the journal replays in reverse, so a failed
        batch leaves directory holders, per-segment stats, and pending
        write-combining buffers byte-identical to the pre-batch state — the
        same all-or-nothing guarantee staged allocations and fabric transfers
        already had. An apply-phase failure unwinds the journal back to the
        first op that never took effect (earlier ops in the batch committed).

        ``preflight`` runs the plan-time symbolic batch verifier
        (``repro_torch.core.verify``) over the selected tickets *before* the first
        planner call — so before any directory/WC/stats/detector state can
        change. ``"warn"`` records the :class:`~repro_torch.core.verify.PreflightResult`
        into ``coherence_stats()["preflight"]``; ``"raise"`` additionally
        raises :class:`~repro_torch.core.verify.PreflightError` (failing every
        ticket, with nothing to roll back) when any must-severity diagnostic
        — a guaranteed defect — is found; ``"off"`` skips the pass. ``None``
        defers to the session default (``CXLSession(preflight=...)``), which
        itself defers to the ``EMUCXL_CHECK`` environment token
        ``preflight``.
        """
        lib = self._session.lib
        with lib._lock:
            if only is None:
                tickets, self._pending = self._pending, []
            else:
                chosen = {id(t) for t in only}
                tickets = [t for t in self._pending if id(t) in chosen]
                self._pending = [t for t in self._pending
                                 if id(t) not in chosen]
            if not tickets:
                return 0.0
            try:
                lib._require_init()
            except Exception as e:
                for t in tickets:
                    t._fail(e)
                raise
            mode = verify.resolve_preflight_mode(
                preflight if preflight is not None
                else getattr(self._session, "_preflight", None))
            if mode != "off":
                result = self._preflight_check(lib, tickets)
                lib._record_preflight(result)
                if lib.tracer is not None:
                    lib.tracer.emit("preflight", ops=result.ops,
                                    must=result.must_count,
                                    may=result.may_count)
                if mode == "raise" and not result.ok:
                    err = verify.PreflightError(result)
                    for t in tickets:
                        t._fail(err)
                    raise err
            fabric = lib.fabric
            start = fabric.clock if fabric is not None else 0.0
            plans: List[Tuple[Ticket, _Plan]] = []
            journal = ecxl.DirectoryJournal()
            serial = 0.0
            # Stream dependency graph: stream -> the last plan that closed it
            # (a draining fence, or an acquire that synchronized); whether the
            # stream's last boundary was a fence with no write since (the
            # coalescing precondition); and, per segment, the release fences
            # planned so far — what a later acquire must wait on.
            last_barrier: dict = {}
            fenced_since_write: dict = {}
            seg_releases: dict = {}     # sid -> [(host, fence plan), ...]
            try:
                for t in tickets:
                    mark = journal.mark()
                    if lib.tracer is not None:
                        lib.tracer.emit("op", op=type(t.op).__name__,
                                        mark=mark)
                    plan = self._plan_one(lib, fabric, t.op, journal)
                    plan.journal_mark = mark
                    for s in plan.streams:
                        dep = last_barrier.get(s)
                        if dep is not None and dep not in plan.deps:
                            plan.deps.append(dep)
                    if plan.kind == "fence":
                        key = plan.streams[0]
                        if plan.fence_drained:
                            # Same-stream ops after this fence may not overlap
                            # its drain: they depend on it in the engine.
                            last_barrier[key] = plan
                            fenced_since_write[key] = True
                            seg_releases.setdefault(key[0], []).append(
                                (key[1], plan))
                        elif fenced_since_write.get(key):
                            # Back-to-back fences, nothing written between:
                            # one drain serves both. (A no-op fence with no
                            # draining fence behind it coalesces nothing —
                            # there is no drain to fold into.)
                            plan.segment._bump(journal, "fence_coalesced")
                    elif plan.kind == "acquire":
                        # The read-side pair: wait for every peer host's
                        # release fence planned before this point, so reads
                        # after the acquire observe the published pages.
                        key = plan.streams[0]
                        for host, fence_plan in seg_releases.get(key[0], ()):
                            if host != key[1] and fence_plan not in plan.deps:
                                plan.deps.append(fence_plan)
                                plan.acquired += 1
                        if plan.acquired:
                            plan.segment._bump(journal, "acquires")
                            # Later ops on this stream order behind the
                            # acquire, not the (foreign) fences directly.
                            last_barrier[key] = plan
                    else:
                        for s in plan.write_streams:
                            fenced_since_write[s] = False
                    plans.append((t, plan))
                    serial += plan.hw_time
                lib._maybe_check()      # EMUCXL_CHECK: planned batch invariant
            except Exception as e:
                # Mid-batch failure (quota/capacity/stale handle/bounds):
                # replay the coherence journal in reverse and release staged
                # destinations; no fabric transfer has begun yet (routes are
                # deferred to the event engine below), sources are untouched,
                # and every ticket in the batch fails with the cause.
                journal.rollback()
                if lib.tracer is not None:
                    lib.tracer.emit("rollback", mark=0, phase="plan")
                for _, plan in plans:
                    if plan.staged_addr is not None:
                        lib.free(plan.staged_addr)
                for t in tickets:
                    t._fail(e)
                raise
            if fabric is not None:
                # Execute the dependency graph on the discrete-event engine.
                # Jobs exist for every plan that moves fabric bytes, waits on
                # another plan, or is itself waited on (a route-less barrier
                # completes instantly once its own deps do). Dependency-free
                # jobs all begin at the batch start instant, so a fence-free
                # batch evolves exactly like one begin-all-then-drain wave.
                engine = SimulationEngine(fabric, tracer=lib.tracer)
                barrier_ids = {id(d) for _, p in plans for d in p.deps}
                jobs: dict = {}
                for _, plan in plans:
                    if plan.routes or plan.deps or id(plan) in barrier_ids:
                        jobs[id(plan)] = engine.job(plan.routes,
                                                    label=plan.kind)
                for _, plan in plans:
                    job = jobs.get(id(plan))
                    if job is None:
                        continue
                    for dep in plan.deps:
                        dep_job = jobs.get(id(dep))
                        if dep_job is not None:
                            job.after(dep_job)
                engine.run()
                for _, plan in plans:
                    job = jobs.get(id(plan))
                    if job is not None:
                        plan.transfers = job.transfers
                        if plan.kind == "acquire":
                            # An acquire's modeled cost is the wait itself:
                            # how long its stream stalled for peer releases.
                            plan.acquire_wait = max(
                                0.0, job.completed_at - start)
                fabric_span = fabric.clock - start
                makespan = max(fabric_span, serial)
                lib.modeled_time[ecxl.REMOTE_MEMORY] += fabric_span
            else:
                makespan = serial
            for _, plan in plans:
                # Fallback components charge their tier like the sync calls.
                for tier, t in plan.hw_charges:
                    lib.modeled_time[tier] += t
            for i, (t, plan) in enumerate(plans):
                try:
                    value = self._apply_one(lib, plan)
                except Exception as e:
                    # Earlier tickets in the batch completed; this one and every
                    # later one must not be left pending (result() would return
                    # None) — fail them all with the cause, unwind the
                    # coherence transitions the failed ops planned (earlier,
                    # committed ops keep theirs), and release the staged
                    # migrate destinations that never committed so the tier
                    # isn't leaked (mirrors the plan-phase rollback).
                    journal.rollback(plan.journal_mark)
                    if lib.tracer is not None:
                        lib.tracer.emit("rollback", mark=plan.journal_mark,
                                        phase="apply")
                    for t2, p2 in plans[i:]:
                        t2._fail(e)
                        if (p2.staged_addr is not None
                                and p2.staged_addr in lib._allocs):
                            try:
                                committed = p2.buf.address == p2.staged_addr
                            except ecxl.EmuCXLError:
                                committed = False
                            if not committed:
                                lib.free(p2.staged_addr)
                    raise
                elapsed = plan.hw_time + plan.acquire_wait + max(
                    (tr.elapsed for tr in plan.transfers), default=0.0
                )
                t._complete(value, elapsed)
            self.batches_flushed += 1
            self.ops_completed += len(tickets)
        return makespan
