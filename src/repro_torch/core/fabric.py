"""CXL fabric model: hosts, switch ports, and links with bandwidth contention.

CXL 3.0 turns the paper's single-host two-tier picture into a *pooled* one: N
hosts reach a shared memory pool through a switch fabric, and every DMA crosses
a path of links with finite bandwidth. The shape of that fabric is pluggable
(``core/topology.py``): the default is the legacy single switch — host uplinks
``host{i}``, pool ports ``pool{j}``, two-link paths — but the same machinery
runs a two-tier spine-leaf or any custom adjacency. Contention is a fluid-flow
("progressive filling") model:

  * every in-flight transfer owns a path of links (resolved by the topology's
    router: shortest path, deterministic ECMP across equal-cost spines);
  * concurrent transfers crossing the same link share its bandwidth equally;
  * a transfer's instantaneous rate is the minimum share across its path;
  * path latency (links + one switch traversal per hop) elapses before data
    starts flowing;
  * a link may bound how many transfers flow at once (``queue_capacity``):
    excess transfers wait in the port's FIFO — backpressure — and their
    queue depth/wait/drop accounting lands in ``LinkStats`` and the trace.

Time here is *modeled* (virtual seconds), continuous with `EmuCXL.modeled_time`:
the emulation runs on whatever host executes it, while the fabric accounts what
the transfers would cost on the modeled topology. Contention only appears when
transfers overlap in virtual time — `begin()` several, then `drain()` — which is
how `EmuCXL.migrate_batch` models N hosts acting concurrently. A lone
`transfer()` reduces exactly to latency + bytes/bandwidth, matching the old
uncontended constants in `core/hw.py`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.hw import V5E, HardwareModel
from repro_torch.core.topology import (
    HOST,
    POOL,
    Topology,
    TopologyError,
    host_node,
    pool_node,
    single_switch,
    switch_hops,
)

_EPS = 1e-15


class FabricError(RuntimeError):
    pass


@dataclasses.dataclass
class LinkStats:
    """Cumulative per-link/per-port accounting (virtual time)."""

    bytes_carried: int = 0
    transfers: int = 0
    busy_time: float = 0.0       # virtual seconds with >= 1 flowing transfer
    peak_concurrency: int = 0
    # Port-queue accounting (all zero for unbounded-queue links, the default):
    queue_waits: int = 0         # transfers that had to wait for a slot here
    queue_wait_time: float = 0.0  # total virtual seconds those transfers waited
    peak_queue_depth: int = 0    # deepest the FIFO ever got
    drops: int = 0               # arrivals beyond queue_depth (would-be drops;
    #                              the fabric is lossless, so they still queue)


class Link:
    """One full-duplex-modeled-as-one-lane fabric link (a switch port pair).

    ``queue_capacity`` bounds concurrently *flowing* transfers: further
    arrivals wait in ``fifo`` (arrival order) until a slot frees — a transfer
    cannot begin flowing on a full downstream port. ``queue_depth`` bounds the
    FIFO itself; arrivals beyond it still queue (lossless, credit-based) but
    count as ``drops`` in the stats. ``None`` (default) disables both, which
    is the legacy unbounded behavior.
    """

    def __init__(self, name: str, bandwidth: float, latency: float,
                 queue_capacity: Optional[int] = None,
                 queue_depth: Optional[int] = None):
        if bandwidth <= 0:
            raise FabricError(f"link {name}: bandwidth must be > 0")
        if queue_capacity is not None and queue_capacity < 1:
            raise FabricError(f"link {name}: queue_capacity must be >= 1")
        if queue_depth is not None and queue_depth < 1:
            raise FabricError(f"link {name}: queue_depth must be >= 1")
        self.name = name
        self.bandwidth = bandwidth
        self.latency = latency
        self.queue_capacity = queue_capacity
        self.queue_depth = queue_depth
        self.active: set = set()          # tids currently routed over this link
        self.flowing: set = set()         # tids holding a service slot
        self.fifo: List[int] = []         # ready tids awaiting a slot, FIFO
        self.stats = LinkStats()

    @property
    def occupancy(self) -> int:
        """Live number of in-flight transfers crossing this link."""
        return len(self.active)

    @property
    def queue_len(self) -> int:
        """Live number of transfers waiting for a slot on this port."""
        return len(self.fifo)

    def has_slot(self) -> bool:
        return (self.queue_capacity is None
                or len(self.flowing) < self.queue_capacity)


@dataclasses.dataclass
class Transfer:
    """One in-flight (or completed) DMA across the fabric.

    Lifecycle: *latency* (until ``ready_at``) -> *queued* (``queued_at`` set:
    in its ports' FIFOs awaiting slots — instantaneous when every link's queue
    is unbounded) -> *flowing* (``admitted_at`` set) -> completed.
    ``queue_wait`` is the queued duration, charged to the ports' stats."""

    tid: int
    path: Tuple[str, ...]
    nbytes: int
    start: float                  # virtual time begin() was called
    ready_at: float               # start + path latency; data flows after this
    remaining: float              # bytes left to move
    completed_at: Optional[float] = None
    queued_at: Optional[float] = None
    admitted_at: Optional[float] = None
    queue_wait: float = 0.0

    @property
    def elapsed(self) -> float:
        if self.completed_at is None:
            raise FabricError(f"transfer {self.tid} still in flight")
        return self.completed_at - self.start


class Fabric:
    """N hosts and P pool ports over a pluggable switch topology.

    Without an explicit ``topology`` this is the legacy single switch: link
    names ``host0..host{N-1}`` (host uplinks) and ``pool0..pool{P-1}``
    (switch-to-pool-device ports), a host-to-pool path of (host_i, pool_j),
    a host-to-host path of (host_a, host_b). With one (``core/topology.py``:
    ``spine_leaf``, or a custom adjacency) paths may also cross inter-switch
    trunk links, and routing — shortest path, deterministic ECMP — is the
    topology's. Switches add fixed latency per traversal but are not
    themselves bandwidth bottlenecks (their ports are; bound a port's
    concurrency with ``queue_capacity`` to model switch queueing).
    """

    def __init__(
        self,
        num_hosts: int = 1,
        pool_ports: int = 1,
        hw: HardwareModel = V5E,
        host_bandwidth: Optional[float] = None,
        pool_port_bandwidth: Optional[float] = None,
        link_latency: Optional[float] = None,
        switch_latency: Optional[float] = None,
        topology: Optional[Topology] = None,
    ):
        self.hw = hw
        self.switch_latency = (
            switch_latency if switch_latency is not None else hw.switch_latency
        )
        host_bw = host_bandwidth if host_bandwidth is not None else hw.host_link_bandwidth
        pool_bw = (
            pool_port_bandwidth
            if pool_port_bandwidth is not None
            else hw.pool_port_bandwidth
        )
        lat = link_latency if link_latency is not None else hw.remote_access_latency / 2
        if topology is None:
            if num_hosts < 1 or pool_ports < 1:
                raise FabricError("need >= 1 host and >= 1 pool port")
            topology = single_switch(num_hosts, pool_ports)
        try:
            topology.validate()
        except TopologyError as exc:
            raise FabricError(str(exc)) from None
        self.topology = topology
        self.num_hosts = topology.num_hosts
        self.pool_ports = topology.pool_ports
        # Trunks default to pool-port bandwidth: the paper's switch fabric is
        # provisioned at least as fat as its device ports.
        default_bw = {HOST: host_bw, POOL: pool_bw}
        self.links: Dict[str, Link] = {}
        for spec in topology.links.values():
            self._add_link(Link(
                spec.name,
                spec.bandwidth if spec.bandwidth is not None
                else default_bw.get(spec.kind, pool_bw),
                spec.latency if spec.latency is not None else lat,
                queue_capacity=spec.queue_capacity,
                queue_depth=spec.queue_depth,
            ))
        self.clock = 0.0
        self._tids = itertools.count()
        self._active: Dict[int, Transfer] = {}
        self._cancelled: set = set()    # tids aborted by cancel(), for drain()
        self._queue_order: List[int] = []   # queued tids, global arrival order
        # Optional TraceRecorder (core/trace.py): transfer-begin/-complete
        # (and port-queue drop) events, attached by EmuCXL.attach_tracer.
        self.tracer = None

    def _add_link(self, link: Link) -> None:
        self.links[link.name] = link

    # ------------------------------------------------------------------ topology
    def host_link(self, host: int) -> str:
        self._check_host(host)
        return self.topology.host_link(host)

    def pool_link(self, port: int) -> str:
        if not 0 <= port < self.pool_ports:
            raise FabricError(f"invalid pool port {port} (have {self.pool_ports})")
        return self.topology.pool_link(port)

    def pool_path(self, host: int, port: int) -> Tuple[str, ...]:
        """Route for a host <-> shared-pool DMA (resolved by the topology)."""
        self._check_host(host)
        if not 0 <= port < self.pool_ports:
            raise FabricError(f"invalid pool port {port} (have {self.pool_ports})")
        return self.topology.route(host_node(host), pool_node(port))

    def host_path(self, src: int, dst: int) -> Tuple[str, ...]:
        """Route for a direct host <-> host move (CXL 3.0 peer sharing)."""
        self._check_host(src)
        self._check_host(dst)
        return self.topology.route(host_node(src), host_node(dst))

    def _check_host(self, host: int) -> None:
        if not 0 <= host < self.num_hosts:
            raise FabricError(f"invalid host {host} (fabric has {self.num_hosts})")

    def path_latency(self, path: Iterable[str]) -> float:
        """Links' propagation delay + one switch traversal per hop between
        consecutive links (minimum one — the single-switch charge)."""
        path = tuple(path)
        return (sum(self.links[n].latency for n in path)
                + self.switch_latency * switch_hops(path))

    # ------------------------------------------------------------------ transfers
    def begin(self, path: Iterable[str], nbytes: int) -> Transfer:
        """Register an in-flight transfer starting at the current virtual time."""
        path = tuple(path)
        if not path:
            raise FabricError("empty path")
        for name in path:
            if name not in self.links:
                raise FabricError(f"unknown link {name!r}")
        if nbytes <= 0:
            raise FabricError(f"invalid transfer size {nbytes}")
        t = Transfer(
            tid=next(self._tids),
            path=path,
            nbytes=nbytes,
            start=self.clock,
            ready_at=self.clock + self.path_latency(path),
            remaining=float(nbytes),
        )
        self._active[t.tid] = t
        for name in path:
            link = self.links[name]
            link.active.add(t.tid)
            link.stats.transfers += 1
            link.stats.bytes_carried += nbytes
            link.stats.peak_concurrency = max(link.stats.peak_concurrency,
                                              link.occupancy)
        if self.tracer is not None:
            self.tracer.emit("transfer-begin", tid=t.tid, route=t.path,
                             nbytes=nbytes, at=self.clock)
        self._intake()     # a zero-latency path must be visible immediately
        return t

    def _intake(self) -> None:
        """Move latency-expired transfers into their ports' FIFOs, then admit
        as many queued transfers as the ports' slots allow. Idempotent; runs
        at every instant the admissible set can change (begin, step, cancel),
        so between calls every admissible transfer is already flowing and
        ``next_event_time`` can stay non-mutating."""
        newly = [t for t in self._active.values()
                 if t.queued_at is None and t.ready_at <= self.clock + _EPS]
        for t in sorted(newly, key=lambda t: (t.ready_at, t.tid)):
            t.queued_at = self.clock
            self._queue_order.append(t.tid)
            for name in t.path:
                link = self.links[name]
                link.fifo.append(t.tid)
                depth = len(link.fifo)
                link.stats.peak_queue_depth = max(
                    link.stats.peak_queue_depth, depth)
                if link.queue_depth is not None and depth > link.queue_depth:
                    link.stats.drops += 1
                    if self.tracer is not None:
                        self.tracer.emit("transfer-drop", tid=t.tid,
                                         link=name, depth=depth,
                                         at=self.clock)
        self._admit()

    def _admit(self) -> None:
        """One pass over the queued transfers in global arrival order: a
        transfer starts flowing the instant *every* link on its path has a
        free slot (it never holds slots while waiting, so multi-port paths
        cannot deadlock). Per port this preserves FIFO order whenever the
        port itself is the bottleneck; a transfer stalled on a *different*
        full port does not block later arrivals whose own ports have room
        (virtual-output-queueing, not head-of-line blocking). One pass
        suffices: admission only consumes slots — they free on completion."""
        still: List[int] = []
        for tid in self._queue_order:
            t = self._active.get(tid)
            if t is None:
                continue
            if all(self.links[n].has_slot() for n in t.path):
                t.admitted_at = self.clock
                t.queue_wait = self.clock - t.queued_at
                for name in t.path:
                    link = self.links[name]
                    link.fifo.remove(tid)
                    link.flowing.add(tid)
                    if t.queue_wait > _EPS:
                        link.stats.queue_waits += 1
                        link.stats.queue_wait_time += t.queue_wait
            else:
                still.append(tid)
        self._queue_order = still

    def _flow_rates(self, flowing: List[Transfer]) -> Dict[int, float]:
        """Equal-share progressive filling: rate = min over path of bw / users."""
        users: Dict[str, int] = {}
        for t in flowing:
            for name in t.path:
                users[name] = users.get(name, 0) + 1
        return {
            t.tid: min(self.links[n].bandwidth / users[n] for n in t.path)
            for t in flowing
        }

    def _step(self, limit: Optional[float] = None) -> List[Transfer]:
        """Advance virtual time to the next internal event (a transfer's data
        starting to flow, or a transfer completing), capped at `limit` when
        given. Returns the transfers that completed at the new clock — an
        empty list when idle, or when the cap cut the step short of any
        completion. With ``limit=None`` the fluid evolution is exactly the
        classic uncapped step; a capped step at an intermediate instant makes
        identical proportional progress, just split in two. Queued transfers
        (ready, but backpressured on a full port) have no event of their own:
        they are admitted when a completion frees slots."""
        if not self._active:
            if limit is not None and limit > self.clock:
                self.clock = limit
            return []
        self._intake()
        active = list(self._active.values())
        flowing = [t for t in active if t.admitted_at is not None]
        waiting = [t for t in active if t.queued_at is None]
        rates = self._flow_rates(flowing)
        candidates = (
            [t.remaining / rates[t.tid] for t in flowing if rates[t.tid] > 0]
            + [t.ready_at - self.clock for t in waiting]
        )
        if not candidates:
            # Unreachable: with every queue_capacity >= 1 and nothing flowing,
            # _admit always admits the arrival-order head.
            raise FabricError("active transfers but no next event")
        dt = max(min(candidates), 0.0)
        if limit is not None:
            dt = min(dt, max(limit - self.clock, 0.0))
        busy_links = {name for t in flowing for name in t.path}
        for name in busy_links:
            self.links[name].stats.busy_time += dt
        self.clock += dt
        completed: List[Transfer] = []
        for t in flowing:
            t.remaining -= rates[t.tid] * dt
            if t.remaining <= _EPS * max(t.nbytes, 1):
                t.remaining = 0.0
                t.completed_at = self.clock
                del self._active[t.tid]
                for name in t.path:
                    link = self.links[name]
                    link.active.discard(t.tid)
                    link.flowing.discard(t.tid)
                completed.append(t)
                if self.tracer is not None:
                    self.tracer.emit("transfer-complete", tid=t.tid,
                                     route=t.path, queue_wait=t.queue_wait,
                                     at=self.clock)
        if completed or self._active:
            self._intake()   # freed slots and/or newly-expired latencies
        return completed

    def step(self) -> List[Transfer]:
        """Advance to the next internal event; returns transfers that completed.

        Public face of the event loop for `core/engine.py`: the engine calls
        this when the fabric's next event precedes every scheduled event."""
        return self._step()

    def next_event_time(self) -> Optional[float]:
        """Virtual time of the next internal transition, or None when idle.

        Non-mutating twin of `_step`'s dt computation, so a discrete-event
        loop can merge the fabric's timeline with its own event heap. Queued
        (backpressured) transfers contribute no event: their admission rides
        a completion, which is one."""
        if not self._active:
            return None
        active = list(self._active.values())
        flowing = [t for t in active if t.admitted_at is not None]
        waiting = [t for t in active if t.queued_at is None]
        rates = self._flow_rates(flowing)
        candidates = (
            [t.remaining / rates[t.tid] for t in flowing if rates[t.tid] > 0]
            + [t.ready_at - self.clock for t in waiting]
        )
        if not candidates:
            raise FabricError("active transfers but no next event")
        return self.clock + max(min(candidates), 0.0)

    def advance_to(self, when: float) -> List[Transfer]:
        """Advance virtual time to exactly `when`, in-flight transfers making
        proportional fluid progress; returns every transfer that completed on
        the way (in completion order). Idle fabric: the clock just jumps."""
        completed: List[Transfer] = []
        while self.clock + _EPS < when:
            completed.extend(self._step(limit=when))
        return completed

    def cancel(self, transfer: Transfer) -> None:
        """Abort an in-flight transfer without advancing time (rollback path).

        Reverses begin()'s registration and stats so a failed multi-part
        operation doesn't leave the fabric permanently occupied. No-op if the
        transfer already completed (it happened; there is nothing to abort).
        peak_concurrency is intentionally left as observed. A cancelled
        flowing transfer frees its port slots, which may admit queued work.
        """
        t = self._active.pop(transfer.tid, None)
        if t is None:
            return
        self._cancelled.add(t.tid)
        if t.tid in self._queue_order:
            self._queue_order.remove(t.tid)
        for name in t.path:
            link = self.links[name]
            link.active.discard(t.tid)
            link.flowing.discard(t.tid)
            if t.tid in link.fifo:
                link.fifo.remove(t.tid)
            link.stats.transfers -= 1
            link.stats.bytes_carried -= t.nbytes
        if t.admitted_at is not None and self._queue_order:
            self._admit()

    def drain(self, transfer: Optional[Transfer] = None) -> float:
        """Advance virtual time until `transfer` (or everything) completes.

        Other in-flight transfers make proportional progress; contention is the
        whole point. Returns the completion time of `transfer`, or the final
        clock when draining everything. Draining a cancel()ed transfer raises
        a precise error immediately instead of spinning the clock forward and
        failing with an opaque "never completed".
        """
        if transfer is None:
            while self._active:
                self._step()
            # Everything in flight has resolved: cancelled tids can no longer
            # be usefully diagnosed, so drop them (the set must not grow for
            # the fabric's lifetime in failure-heavy workloads).
            self._cancelled.clear()
            return self.clock
        while transfer.completed_at is None:
            if transfer.tid in self._cancelled:
                raise FabricError(
                    f"transfer {transfer.tid} was cancelled before completion"
                )
            if not self._active:
                raise FabricError(
                    f"transfer {transfer.tid} never completed (not registered "
                    f"with this fabric?)"
                )
            self._step()
        return transfer.completed_at

    def transfer(self, path: Iterable[str], nbytes: int) -> float:
        """Synchronous transfer: begin + drain; returns modeled elapsed seconds.

        If other transfers are in flight they contend with this one (and advance
        alongside it) — a lone call is exactly latency + nbytes/bandwidth.
        """
        t = self.begin(path, nbytes)
        self.drain(t)
        return t.elapsed

    # ------------------------------------------------------------------ queries
    def idle(self) -> bool:
        return not self._active

    def in_flight(self) -> int:
        return len(self._active)

    def link_occupancy(self, name: str) -> int:
        return self.links[name].occupancy

    def least_loaded_port(self) -> int:
        """Pool port whose link has the fewest in-flight transfers.

        Ties break by the lowest port index — the (occupancy, index) key makes
        the choice a pure function of fabric state, so placement policies are
        reproducible run to run (pinned by tests/test_topology.py)."""
        return min(range(self.pool_ports),
                   key=lambda j: (self.links[self.pool_link(j)].occupancy, j))

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-link occupancy/utilization snapshot (the `emucxl_stats` extension).

        Includes the port-queue counters (all zero on unbounded-queue links):
        ``queue_len`` (live), ``queue_waits``/``queue_wait_time`` (cumulative
        backpressure), ``peak_queue_depth``, and ``drops`` (arrivals beyond
        the bounded FIFO depth)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, link in self.links.items():
            out[name] = {
                "bandwidth": link.bandwidth,
                "occupancy": float(link.occupancy),
                "bytes_carried": float(link.stats.bytes_carried),
                "transfers": float(link.stats.transfers),
                "busy_time": link.stats.busy_time,
                "peak_concurrency": float(link.stats.peak_concurrency),
                "utilization": (link.stats.busy_time / self.clock
                                if self.clock > 0 else 0.0),
                "queue_len": float(link.queue_len),
                "queue_waits": float(link.stats.queue_waits),
                "queue_wait_time": link.stats.queue_wait_time,
                "peak_queue_depth": float(link.stats.peak_queue_depth),
                "drops": float(link.stats.drops),
            }
        return out
