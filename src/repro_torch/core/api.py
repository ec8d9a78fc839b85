"""emucxl v2: the handle-based session API over the paper's disaggregated-memory model.

The paper's contribution is a *standardized user-space API*; v1 reproduces it
literally — ~20 C-style ``emucxl_*`` free functions over one process-global
instance, trafficking in raw ``int`` addresses. v2 keeps the same modeled
machinery (``EmuCXL``, ``Fabric``, ``SharedPool``, the policies) but fixes the
three things the C surface cannot express:

  1. **No global state.** A ``CXLSession`` is a context manager owning one fabric
     domain; any number of independent sessions coexist in one process.
  2. **Typed, generation-counted handles.** ``alloc`` returns a ``Buffer``
     (core/handle.py), not an address. Use-after-free, double free, and
     stale-handle-after-resize raise ``StaleHandleError`` at the API boundary;
     ``migrate`` keeps the handle valid across moves.
  3. **An async operation queue.** ``session.submit(ReadOp/WriteOp/MigrateOp/
     MemcpyOp/MemsetOp) -> Ticket`` batches ops through ``core/queue.py``; one
     ``flush()`` drains them *concurrently* through the fabric, so N hosts' ops
     contend for links and the makespan reflects overlap — the CXL 3.0 queued-
     transaction picture a one-blocking-call-at-a-time API cannot model.

Policies are injected at construction (``placement`` picks pool ports,
``promotion`` is the session-default Policy1/Policy2 handed to middleware)
instead of being hard-coded defaults scattered across consumers.

The v1 ``emucxl_*`` facade (core/emucxl.py) is now a thin compatibility shim over
a default session, so paper-fidelity code keeps working unchanged — and gains the
handle table's use-after-free/double-free detection for free.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.coherence import DEFAULT_WC_CAPACITY, SharedSegment
from repro_torch.core.emucxl import (
    REMOTE_MEMORY,
    EmuCXL,
    EmuCXLError,
)
from repro_torch.core.fabric import Fabric
from repro_torch.core.handle import Buffer, HandleTable, StaleHandleError
from repro_torch.core.hw import V5E, HardwareModel
from repro_torch.core.policy import Policy1, PromotionPolicy
from repro_torch.core.queue import (
    AcquireOp,
    FenceOp,
    MemcpyOp,
    MemsetOp,
    MigrateOp,
    OpQueue,
    ReadOp,
    Ticket,
    WriteOp,
)
from repro_torch.core.verify import resolve_preflight_mode

__all__ = [
    "CXLSession", "Buffer", "SharedSegment", "StaleHandleError", "as_session",
    "ReadOp", "WriteOp", "MigrateOp", "MemcpyOp", "MemsetOp", "FenceOp",
    "AcquireOp", "Ticket", "OpQueue",
]


class CXLSession:
    """One emulated CXL fabric domain: tiers, pool, policies, handles, op queue.

    Construction opens the device (v1's ``emucxl_init``); ``close()`` — or leaving
    the ``with`` block — frees everything (v1's ``emucxl_exit``). Sessions are
    fully independent: separate allocation registries, handle tables, modeled
    clocks, and (unless explicitly shared) fabrics.

    ``placement`` and ``promotion`` make the policy layer (core/policy.py) a
    constructor-injected dependency: ``placement`` routes every pooled allocation
    (it is handed to the underlying ``EmuCXL``), while ``promotion`` is the
    session-wide default the middleware (KV store, paged KV pool) picks up when
    not given an explicit policy.

    ``topology`` (core/topology.py) declares the fabric's shape — e.g.
    ``spine_leaf(leaves=2, spines=2)`` — and the session builds its own
    ``Fabric`` over it; mutually exclusive with ``fabric``, which hands in a
    pre-built (possibly shared) fabric instead. With a topology, ``num_hosts``
    defaults to the topology's host count rather than 1.

    ``device`` ("cuda" by default) is where the LOCAL tier lives; the REMOTE
    tier is then pinned host memory. Pass ``device="cpu"`` to keep both tiers
    on the CPU; asking for CUDA on a machine without it raises.
    """

    def __init__(
        self,
        local_capacity: Optional[int] = None,
        remote_capacity: Optional[int] = None,
        *,
        device="cuda",
        num_hosts: Optional[int] = None,
        fabric=None,
        topology=None,
        host_quota=None,
        placement=None,
        promotion: Optional[PromotionPolicy] = None,
        hw: HardwareModel = V5E,
        lib: Optional[EmuCXL] = None,
        preflight: Optional[str] = None,
        _initialize: bool = True,
    ):
        if topology is not None:
            if fabric is not None:
                raise EmuCXLError(
                    "pass either fabric= (a pre-built Fabric) or topology= "
                    "(a shape for the session to build one from), not both")
            fabric = Fabric(hw=hw, topology=topology)
            if num_hosts is None:
                num_hosts = fabric.num_hosts
        if num_hosts is None:
            num_hosts = 1
        if preflight is not None:
            # Validate eagerly (resolve_preflight_mode raises on bad input)
            # but store the raw value: None keeps deferring to EMUCXL_CHECK
            # per flush, like race_detect does per share.
            resolve_preflight_mode(preflight)
        self._preflight = preflight
        self._lib = lib if lib is not None else EmuCXL(hw)
        self._owns_lib = _initialize
        self._table = HandleTable()
        self.promotion: PromotionPolicy = (
            promotion if promotion is not None else Policy1()
        )
        self.queue = OpQueue(self)
        self._closed = False
        if _initialize:
            self._lib.init(
                local_capacity, remote_capacity, device, num_hosts, fabric,
                host_quota, placement,
            )

    @classmethod
    def wrap(cls, lib: EmuCXL) -> "CXLSession":
        """Adopt an existing (possibly already-initialized) ``EmuCXL`` without
        owning its lifecycle — the v1-interop constructor."""
        return cls(lib=lib, _initialize=False)

    # ------------------------------------------------------------------ lifecycle
    def __enter__(self) -> "CXLSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Flush pending ops, free all allocations, close the emulated device.

        A failing flush still closes the session and exits the library — the
        flush error propagates, but no state is stranded half-open (the v1
        facade in particular must be re-initializable afterwards)."""
        if self._closed:
            return
        try:
            if len(self.queue):
                self.queue.flush()
        finally:
            self._closed = True
            if self._owns_lib and self._lib._initialized:
                self._lib.exit()

    def _check_open(self) -> None:
        if self._closed:
            raise EmuCXLError("session is closed")

    # ------------------------------------------------------------------ plumbing
    @property
    def lib(self) -> EmuCXL:
        """The underlying modeled library (v1 interop / introspection)."""
        return self._lib

    @property
    def fabric(self):
        return self._lib.fabric

    @property
    def placement(self):
        return self._lib.placement

    @property
    def num_hosts(self) -> int:
        return self._lib.num_hosts

    @property
    def modeled_time(self) -> Dict[int, float]:
        return self._lib.modeled_time

    # ------------------------------------------------------------------ allocation
    # Handle-table mutations piggyback on the lib's RLock so the v2 surface (and
    # the v1 facade over it) keeps v1's full-serialization guarantee — without
    # it, two racing allocs/frees could interleave insert/retire on one slot and
    # mint aliasing handles.
    def _register(self, address: int) -> Buffer:
        with self._lib._lock:
            index, generation = self._table.insert(address)
            return Buffer(self, index, generation)

    def alloc(self, size: int, node: int = REMOTE_MEMORY, host: int = 0) -> Buffer:
        """Allocate `size` bytes on tier `node` for `host`; returns a Buffer."""
        with self._lib._lock:
            self._check_open()
            return self._register(self._lib.alloc(size, node, host))

    def alloc_array(self, shape, dtype, node: int = REMOTE_MEMORY,
                    host: int = 0) -> Buffer:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return self.alloc(max(nbytes, 1), node, host)

    def free(self, buf: Buffer, size: Optional[int] = None) -> None:
        """Release a buffer. The handle becomes stale; a second free raises."""
        with self._lib._lock:
            self._check_open()
            if size is not None and size != buf.size:
                raise EmuCXLError(
                    f"free size mismatch: allocation is {buf.size} bytes, caller "
                    f"passed {size}"
                )
            index, generation = buf.handle
            address = self._table.retire(index, generation, "freed")
            self._lib.free(address)

    def resize(self, buf: Buffer, size: int) -> Buffer:
        """realloc: returns a NEW handle; `buf` is retired (stale hereafter)."""
        with self._lib._lock:
            self._check_open()
            index, generation = buf.handle
            old_address = self._table.resolve(index, generation)
            new_address = self._lib.resize(old_address, size)
            self._table.retire(index, generation, "resized")
            return self._register(new_address)

    # ------------------------------------------------------------------ shared segments
    def share(self, size: int, host: int = 0, page_bytes: int = 4096,
              writers=None, consistency: str = "eager",
              wc_capacity: Optional[int] = DEFAULT_WC_CAPACITY,
              race_detect: Optional[str] = None,
              home=None
              ) -> SharedSegment:
        """Create a hardware-coherent shared segment (core/coherence.py).

        One pooled copy of the bytes, charged once to `host`'s quota; any host
        — in this session or another session wrapping the same ``EmuCXL`` —
        can ``attach`` it. `writers` hints the expected writer hosts so a
        sharing-aware placement can pick the segment's pool port.
        ``consistency="release"`` enables write-combining: writes buffer
        locally per (segment, host) and only publish — invalidations,
        writebacks — at a ``fence()``. The buffer holds at most `wc_capacity`
        pages per host (None = unbounded); overflowing it force-drains the
        LRU pending page through the normal upgrade protocol.

        `race_detect` ("off"/"warn"/"raise", default: resolve from
        ``EMUCXL_CHECK=race``) arms the happens-before race detector on
        release segments — see core/race.py and docs/consistency-model.md.

        `home` (a ``DirectoryHomePolicy``, e.g. ``StripedHome()``) shards the
        segment's directory across pool ports: each page's protocol messages
        are charged to that page's *home* port's route instead of the
        segment's backing port. ``None`` keeps the directory on the backing
        port."""
        with self._lib._lock:
            self._check_open()
            return self._lib.share(size, host, page_bytes, writers,
                                   consistency, wc_capacity, race_detect,
                                   home)

    def attach(self, segment: SharedSegment, host: int = 0) -> Buffer:
        """Map `segment` for `host`; returns a Buffer over the shared bytes.

        Reads and writes through the handle run the MESI-lite directory
        protocol: misses fetch pages over the fabric, writes back-invalidate
        peer hosts, and all of it contends with ordinary DMAs."""
        with self._lib._lock:
            self._check_open()
            return self._register(self._lib.attach(segment, host))

    def detach(self, buf: Buffer) -> None:
        """Unmap a segment attachment; the handle becomes stale. The host's
        last detach flushes its dirty pages back over the fabric."""
        with self._lib._lock:
            self._check_open()
            index, generation = buf.handle
            address = self._table.resolve(index, generation)
            self._lib.detach(address)
            self._table.retire(index, generation, "detached")

    def destroy(self, segment: SharedSegment) -> None:
        """Release a fully-detached segment's pooled backing."""
        with self._lib._lock:
            self._check_open()
            self._lib.destroy_segment(segment)

    def fence(self, buf: Optional[Buffer] = None) -> float:
        """Release fence: publish write-combined stores (see ``share``'s
        ``consistency="release"``). With `buf` (a segment attachment), fences
        that (segment, host) pair; with None, every pending pair in the
        underlying library. Returns the modeled seconds the fence's protocol
        traffic occupied (0.0 when nothing was pending)."""
        with self._lib._lock:
            self._check_open()
            return self._lib.fence(None if buf is None else buf.address)

    def acquire(self, buf: Optional[Buffer] = None) -> float:
        """Acquire fence: the read-side pair of ``fence``. Later reads through
        `buf` (or any attachment, with None) observe every write a peer's
        release fence published before this point. Synchronous calls already
        have that ordering — prior fences fully drained before returning — so
        this validates its target and returns 0.0; the modeled wait appears
        under the async queue (``AcquireOp``), where a batch's in-flight
        releases exist to be waited on."""
        with self._lib._lock:
            self._check_open()
            return self._lib.acquire(None if buf is None else buf.address)

    def coherence_stats(self) -> Dict[str, object]:
        return self._lib.coherence_stats()

    def attach_tracer(self, tracer) -> None:
        """Record a linearized event trace (``repro_torch.core.trace``) of every
        coherence plan, flush, and engine job; ``None`` detaches."""
        self._lib.attach_tracer(tracer)

    # ------------------------------------------------------------------ sync ops
    def memcpy(self, dst: Buffer, src: Buffer, size: int) -> Buffer:
        self._check_open()
        self._lib.memcpy(dst.address, src.address, size)
        return dst

    def memmove(self, dst: Buffer, src: Buffer, size: int) -> Buffer:
        return self.memcpy(dst, src, size)

    def memset(self, buf: Buffer, value: int, size: Optional[int] = None) -> Buffer:
        self._check_open()
        return buf.memset(value, size)

    def migrate_batch(self, moves) -> float:
        """Concurrent migrates of [(buf, node[, host]), ...]; returns the modeled
        makespan. Sugar for submitting MigrateOps and flushing.

        All-or-nothing staging: if any move fails validation, the moves already
        enqueued are withdrawn — none of the batch leaks into a later flush.
        The flush is scoped to this batch's own tickets: operations submitted
        earlier stay queued for the caller's next ``flush()`` and neither
        execute here nor fold into the returned makespan."""
        # One critical section from first staging to flush: without it a
        # concurrent flush() could drain (or race) the half-staged batch.
        with self._lib._lock:
            self._check_open()
            tickets = []
            try:
                for move in moves:
                    buf, node = move[0], move[1]
                    host = move[2] if len(move) > 2 else None
                    tickets.append(
                        self.queue.submit(MigrateOp(buf, node, host)))
            except Exception:
                for ticket in tickets:
                    self.queue.cancel(ticket)
                raise
            return self.queue.flush(only=tickets)

    # ------------------------------------------------------------------ async queue
    def submit(self, *ops) -> Union[Ticket, List[Ticket]]:
        """Enqueue operation(s); returns one Ticket per op (a list for several).

        Nothing executes until ``flush()`` (or a ticket's ``result()``) — all ops
        pending at that moment complete as ONE overlapped batch on the fabric.

        All-or-nothing staging: if any op fails validation (stale handle,
        unknown op type, foreign buffer), the ops already enqueued by this
        call are withdrawn — a partially-staged submit never leaves tickets
        silently pending to execute on an unrelated later flush."""
        # Stage the whole group under one lock hold: a concurrent flush()
        # between stagings could execute the early tickets before a later op
        # fails validation, breaking the withdraw-on-failure guarantee.
        with self._lib._lock:
            self._check_open()
            if not ops:
                raise EmuCXLError("submit() needs at least one operation")
            tickets: List[Ticket] = []
            try:
                for op in ops:
                    tickets.append(self.queue.submit(op))
            except Exception:
                for ticket in tickets:
                    self.queue.cancel(ticket)
                raise
            return tickets[0] if len(tickets) == 1 else tickets

    def flush(self, preflight: Optional[str] = None) -> float:
        """Complete every pending op; returns the batch's modeled makespan.

        ``preflight`` overrides the session's plan-time batch-verifier mode
        for this flush only (``"warn" | "raise" | "off"``; ``None`` keeps the
        session default set by ``CXLSession(preflight=...)``, which itself
        defers to ``EMUCXL_CHECK=preflight``). See ``repro_torch.core.verify``."""
        self._check_open()
        return self.queue.flush(preflight=preflight)

    @property
    def pending_ops(self) -> int:
        return len(self.queue)

    # ------------------------------------------------------------------ introspection
    def stats(self, node: int, host: Optional[int] = None) -> int:
        return self._lib.stats(node, host)

    def capacity(self, node: int, host: Optional[int] = None) -> int:
        return self._lib.capacity(node, host)

    def pool_stats(self) -> Dict[str, object]:
        return self._lib.pool_stats()

    def fabric_stats(self) -> Dict[str, Dict[str, float]]:
        return self._lib.fabric_stats()

    def host_quota(self, host: int) -> Optional[int]:
        return self._lib.host_quota(host)

    def live_buffers(self) -> int:
        """Number of live (non-stale) handles in this session."""
        return len(self._table)

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (f"CXLSession({state}, hosts={self.num_hosts}, "
                f"buffers={len(self._table)}, pending_ops={len(self.queue)})")


def as_session(obj) -> CXLSession:
    """Coerce middleware constructor input to a session.

    Accepts a ``CXLSession`` (returned as-is), an ``EmuCXL`` (wrapped, lifecycle
    stays with the caller — the v1 interop path), or None (wraps the process
    default instance, matching v1 middleware defaults).
    """
    if isinstance(obj, CXLSession):
        return obj
    if isinstance(obj, EmuCXL):
        return CXLSession.wrap(obj)
    if obj is None:
        from repro_torch.core.emucxl import default_instance

        return CXLSession.wrap(default_instance())
    raise EmuCXLError(
        f"expected CXLSession, EmuCXL, or None; got {type(obj).__name__}"
    )
