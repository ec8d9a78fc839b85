"""Discrete-event scheduling core: a heap-of-events engine over the fabric.

This is the substrate ``OpQueue.flush`` executes batches on (and the one the
multi-switch topology / QoS roadmap items should build on). It replaces the
old *wave* scheduler, which serialized fence epochs globally: every op
submitted after a fence waited for the drain of **everything** in flight —
stream A's post-fence traffic stalled on stream B's unrelated wave-0 bulk.
Event-driven simulation is how real CXL fabric studies model this
(CXL-DMSim, arXiv:2411.02282): begins and completions are *events* on a
virtual-time heap, and an operation starts the instant its own dependencies
resolve, never a barrier later.

Two cooperating pieces (see ``docs/architecture.md`` for the full layer map):

``SimulationEngine``
    Owns a priority queue of ``(virtual time, sequence, action)`` events and a
    virtual clock shared with the fabric. ``schedule``/``schedule_in`` post
    events; ``run()`` pops them in time order, interleaved with the fabric's
    own internal events (transfer completions, latency expiries) via
    ``Fabric.next_event_time``/``Fabric.step``. When an event fires strictly
    between fabric events, in-flight transfers make *partial* fluid progress
    up to exactly that instant (``Fabric.advance_to``) — virtual time is one
    totally-ordered axis, not per-component clocks.

``Job``
    One schedulable unit: a set of fabric routes (data DMAs plus coherence
    protocol messages — both are just transfers to the engine) that begin
    *together* the moment every dependency job has completed. Dependencies
    form a DAG built by the caller (``job.after(dep)``); a job with no routes
    completes instantly when it becomes ready, which is how pure ordering
    points (acquire fences) ride the same machinery as data movement.

``OpQueue.flush`` builds one job per planned op and wires dependencies
per (segment, host) *stream*: an op depends only on the last release fence
(or acquire) on its own streams, and an acquire depends on the prior peer
release fences of its segment. Independent streams never synchronize — the
whole point. A batch with no fences degenerates to every job beginning at
the same instant, which reproduces the old single-wave schedule (and its
modeled times) bit for bit.

The engine is deliberately small: no processes, no channels — the fluid-flow
bandwidth model in ``core/fabric.py`` already resolves contention, so the
engine only decides *when* transfers enter the fabric.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.fabric import Fabric, Transfer

_EPS = 1e-15


class EngineError(RuntimeError):
    pass


class Job:
    """A set of fabric routes that begin together once all dependencies finish.

    Created via ``SimulationEngine.job``; wire the DAG with ``after`` before
    ``run``. ``began_at``/``completed_at`` record the virtual instants the
    job's transfers entered the fabric and the last one drained (equal for a
    route-less job — a pure ordering point). ``transfers`` holds the in-flight
    ``Transfer`` records, in route order, once the job has begun.
    """

    __slots__ = ("label", "routes", "transfers", "began_at", "completed_at",
                 "_deps_remaining", "_dependents", "_outstanding")

    def __init__(self, routes: Sequence[Tuple[Tuple[str, ...], int]],
                 label: str = ""):
        self.label = label
        self.routes = list(routes)
        self.transfers: List[Transfer] = []
        self.began_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self._deps_remaining = 0
        self._dependents: List["Job"] = []
        self._outstanding = 0

    @property
    def done(self) -> bool:
        return self.completed_at is not None

    @property
    def ready(self) -> bool:
        return self._deps_remaining == 0

    def after(self, dep: "Job") -> "Job":
        """Make this job wait for `dep` to complete; returns self for chaining.

        A dependency that already completed is a no-op (its effects are
        already in the past). Must be called before the engine begins this
        job — the DAG is fixed at ``run`` time."""
        if self.began_at is not None:
            raise EngineError(f"job {self.label!r} already began; cannot add "
                              f"dependencies")
        if dep.done:
            return self
        self._deps_remaining += 1
        dep._dependents.append(self)
        return self


class SimulationEngine:
    """Heap-of-events discrete-event loop, co-simulated with one ``Fabric``.

    Events are ``(virtual time, sequence, zero-arg action)`` triples; the
    sequence number makes same-instant events fire in scheduling order, so a
    deterministic program yields a deterministic schedule. ``run()`` merges
    the event heap with the fabric's internal transitions and returns the
    quiescent virtual time. Without a fabric the engine keeps its own clock
    (pure-event simulations, unit tests); jobs with routes then have nowhere
    to execute and are rejected.
    """

    def __init__(self, fabric: Optional[Fabric] = None, tracer=None):
        self.fabric = fabric
        self.tracer = tracer
        self._clock = fabric.clock if fabric is not None else 0.0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._watch: dict = {}        # transfer tid -> owning Job
        self._jobs: List[Job] = []
        self.events_processed = 0

    # ------------------------------------------------------------------ clock
    @property
    def now(self) -> float:
        """Current virtual time (the fabric's clock when one is attached)."""
        return self.fabric.clock if self.fabric is not None else self._clock

    # ------------------------------------------------------------------ events
    def schedule(self, when: float, action: Callable[[], None]) -> None:
        """Post `action` to fire at virtual time `when` (>= now)."""
        if when < self.now - _EPS:
            raise EngineError(
                f"cannot schedule an event at {when} (now is {self.now})")
        heapq.heappush(self._heap, (max(when, self.now), next(self._seq),
                                    action))

    def schedule_in(self, delay: float, action: Callable[[], None]) -> None:
        """Post `action` to fire `delay` virtual seconds from now."""
        if delay < 0:
            raise EngineError(f"negative delay {delay}")
        self.schedule(self.now + delay, action)

    # ------------------------------------------------------------------ jobs
    def job(self, routes: Sequence[Tuple[Tuple[str, ...], int]] = (),
            label: str = "") -> Job:
        """Register a job of fabric `routes` [(link path, nbytes), ...]."""
        if routes and self.fabric is None:
            raise EngineError("a job with fabric routes needs a fabric")
        j = Job(routes, label)
        self._jobs.append(j)
        return j

    def _begin(self, job: Job) -> None:
        job.began_at = self.now
        if self.tracer is not None:
            # The resolved routes (ordered link names) were pinned at plan
            # time by the topology's router; recording them here is what lets
            # a trace explain *where* the modeled time of this job went.
            self.tracer.emit("job-begin", label=job.label, at=self.now,
                             routes=tuple(tuple(p) for p, _ in job.routes))
        for path, nbytes in job.routes:
            tr = self.fabric.begin(path, nbytes)
            job.transfers.append(tr)
            self._watch[tr.tid] = job
        job._outstanding = len(job.transfers)
        if job._outstanding == 0:
            self._complete(job)

    def _complete(self, job: Job) -> None:
        job.completed_at = self.now
        if self.tracer is not None:
            # Aggregate port-queue wait across the job's transfers: nonzero
            # only when a bounded switch port backpressured one of them.
            self.tracer.emit("job-complete", label=job.label, at=self.now,
                             queue_wait=sum(t.queue_wait
                                            for t in job.transfers))
        for dep in job._dependents:
            dep._deps_remaining -= 1
            if dep._deps_remaining == 0:
                # The dependent's transfers enter the fabric at this instant —
                # an ordinary event, so begins interleave with everything else
                # in deterministic time/sequence order.
                self.schedule(self.now, lambda j=dep: self._begin(j))

    def _transfer_done(self, tr: Transfer) -> None:
        job = self._watch.pop(tr.tid, None)
        if job is None:
            return
        job._outstanding -= 1
        if job._outstanding == 0:
            self._complete(job)

    # ------------------------------------------------------------------ loop
    def run(self) -> float:
        """Run to quiescence: no pending events, nothing in flight.

        Raises ``EngineError`` if jobs remain blocked when the system goes
        quiet (a dependency cycle, or a dependency that was never run)."""
        for j in self._jobs:
            if j.ready and j.began_at is None:
                self.schedule(self.now, lambda job=j: self._begin(job))
        while True:
            heap_t = self._heap[0][0] if self._heap else None
            fab_t = (self.fabric.next_event_time()
                     if self.fabric is not None else None)
            if heap_t is None and fab_t is None:
                break
            if heap_t is not None and (fab_t is None or heap_t <= fab_t):
                # Advance in-flight transfers' fluid progress to the event
                # instant; anything completing exactly then resolves first.
                if self.fabric is not None:
                    for tr in self.fabric.advance_to(heap_t):
                        self._transfer_done(tr)
                else:
                    self._clock = max(self._clock, heap_t)
                _, _, action = heapq.heappop(self._heap)
                self.events_processed += 1
                action()
            else:
                for tr in self.fabric.step():
                    self._transfer_done(tr)
        stuck = [j for j in self._jobs if not j.done]
        if stuck:
            raise EngineError(
                f"{len(stuck)} job(s) never became ready "
                f"({[j.label for j in stuck]}): dependency cycle, or a "
                f"dependency outside this engine")
        if self.fabric is not None:
            # Finalize the (already idle) fabric: drops cancelled-tid
            # bookkeeping exactly like a plain drain() would.
            self.fabric.drain()
        return self.now
