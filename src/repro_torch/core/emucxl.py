"""The emucxl standardized API (paper Table II), generalized to multi-host pooling.

The paper's library hands out virtual addresses backed by `kmalloc_node` on NUMA node 0
(local) or node 1 (the emulated CXL pool). Here the two tiers are real memories:

  node 0 (LOCAL)  -> CUDA device memory                (``memory_kind="device"``)
  node 1 (REMOTE) -> page-locked host memory behind PCIe (``memory_kind="pinned_host"``)

so demotes and promotes are real host<->device DMAs. A caller that asks for
``device="cpu"`` gets both tiers in ordinary host memory
(``memory_kind="unpinned_host"``); tier placement stays fully modeled in the
registry and the cost model either way, which is what tests and benchmarks consume.

Beyond the paper (CXL 3.0 direction): one ``EmuCXL`` instance can emulate **N hosts**
sharing one remote pool through a switch fabric (``core/fabric.py``). Allocations carry
a ``(host, node)`` placement; the remote tier is a ``SharedPool`` with per-host quotas;
cross-tier DMAs route through the fabric so their modeled time reflects live link
contention instead of the uncontended constants in ``core/hw.py``. With the default
``num_hosts=1`` and no fabric, behavior is exactly the paper's single-host two-tier
model.

Allocations are byte-granular ``uint8`` buffers, faithful to the paper's ``void*``/``size_t``
API; tensor views are layered on top for framework use. Every allocation carries metadata
(address, size, node, host, port) in a registry backing ``is_local / get_numa_node /
get_size / stats``, exactly like the paper's user-space metadata structure.

Differences from the paper: accesses are DMA'd slices rather than cache-line loads,
and ``memmove`` is identical to ``memcpy`` because distinct allocations never overlap.
Each allocation's bytes are one 1-D ``torch.uint8`` tensor updated in place; reads
return copies and writes copy their input in, so no caller memory is ever aliased.
Segment attachments share their backing record's tensor (one pooled copy), so
``.data`` is never rebound on a live record.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.coherence import (
    _CONSISTENCY_MODES,
    DEFAULT_WC_CAPACITY,
    EAGER,
    CoherenceStats,
    DirectoryJournal,
    SharedSegment,
    total_stats,
)
from repro_torch.core.fabric import Fabric, Transfer
from repro_torch.core.hw import V5E, HardwareModel
from repro_torch.core.race import RACE_MODES
from repro_torch.core.policy import PlacementPolicy, StaticPlacement
from repro_torch.core.pool import PoolCapacityError, PoolQuotaError, SharedPool
from repro_torch.device import resolve_device

# The v1 facade below defines and self-calls the Table II functions.
# emucxl: allow-v1

LOCAL_MEMORY = 0
REMOTE_MEMORY = 1
_VALID_NODES = (LOCAL_MEMORY, REMOTE_MEMORY)

# Tier -> memory kind on a CUDA device; a CPU instance keeps both tiers in
# ordinary host memory (see _tier_kinds).
_PREFERRED_KINDS = {LOCAL_MEMORY: "device", REMOTE_MEMORY: "pinned_host"}

# Fake virtual-address space: page-aligned, monotonically increasing. Gives the API the
# paper's void*-shaped surface while remaining a pure lookup key.
_PAGE = 4096


def _debug_check_enabled() -> bool:
    """EMUCXL_CHECK=1 runs the directory invariant after every planned
    coherence batch (sync and flush paths). Read per call so tests can toggle
    it with monkeypatch; CI's test job sets it for the whole suite."""
    return os.environ.get("EMUCXL_CHECK", "") not in ("", "0")


def _call_with_hints(fn, hints: Dict[str, object], *args):
    """Invoke a placement hook, passing each hint keyword only when the hook
    accepts it — older/third-party policies keep their narrower signatures
    (two positional args, or ``consistency=`` but no ``wc_capacity=``). A
    hook declaring ``**kwargs`` receives every hint."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        params = {}
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return fn(*args, **hints)
    accepted = {k: v for k, v in hints.items() if k in params}
    return fn(*args, **accepted)


class EmuCXLError(RuntimeError):
    pass


class OutOfTierMemory(EmuCXLError):
    def __init__(self, node: int, requested: int, free: int, host: Optional[int] = None):
        where = "local/HBM" if node == 0 else "remote/pool"
        at = f" on host {host}" if host is not None and node == 0 else ""
        super().__init__(
            f"tier {node} ({where}){at} cannot serve {requested} bytes ({free} free)"
        )
        self.node, self.requested, self.free, self.host = node, requested, free, host


class QuotaExceeded(EmuCXLError):
    """A host hit its pool-partition quota while the pool still had free bytes."""

    def __init__(self, host: int, requested: int, quota: int, used: int):
        super().__init__(
            f"host {host} pool quota exceeded: requested {requested} bytes with "
            f"{used}/{quota} already charged"
        )
        self.host, self.requested, self.quota, self.used = host, requested, quota, used


def _tier_kinds(device: torch.device) -> Dict[int, Optional[str]]:
    """The memory kind each tier really uses on `device`."""
    if device.type == "cuda":
        return dict(_PREFERRED_KINDS)
    return {LOCAL_MEMORY: "unpinned_host", REMOTE_MEMORY: "unpinned_host"}


@dataclasses.dataclass
class Allocation:
    """Registry record: the paper's metadata plus the pooled (host, port) placement."""

    address: int
    size: int
    node: int
    data: torch.Tensor       # 1-D uint8, on the tier's memory
    host: int = 0            # owning emulated host
    port: int = 0            # pool port backing a REMOTE allocation
    clock: int = 0           # LRU touch counter, maintained by the library
    # Coherent shared segments (core/coherence.py): the backing allocation and
    # every per-host attachment carry the segment; only the backing record pays
    # the pool charge and owns the data array.
    segment: Optional[SharedSegment] = None

    @property
    def nbytes(self) -> int:
        return self.size

    @property
    def is_attachment(self) -> bool:
        return (self.segment is not None
                and self.address != self.segment.backing_addr)


@dataclasses.dataclass
class _AccessPlan:
    """Costed plan for one data-plane operation, built by ``_plan_dma`` /
    ``_plan_copy`` and executed either synchronously (``_run_plan``) or as part
    of an async batch (``OpQueue.flush`` begins the routes itself)."""

    # Uncontended fallback components: (tier to charge, modeled seconds). A
    # coherent access may split across tiers — cached-copy DMA on LOCAL,
    # protocol messages on REMOTE.
    hw_charges: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    # Fabric-routed components: (link path, payload bytes). For a coherent
    # access this is the data DMA plus every protocol message.
    routes: List[Tuple[Tuple[str, ...], int]] = dataclasses.field(
        default_factory=list)

    @property
    def hw_time(self) -> float:
        return sum(t for _, t in self.hw_charges)


class EmuCXL:
    """A pooled disaggregated-memory manager with the paper's standardized API.

    One instance == one fabric domain: N emulated "hosts" (paper: one process, one
    host) sharing a remote pool. The module-level functions below delegate to a
    default instance for drop-in, C-style usage.
    """

    def __init__(self, hw: HardwareModel = V5E):
        self.hw = hw
        self._lock = threading.RLock()
        self._initialized = False
        self._allocs: Dict[int, Allocation] = {}
        self._next_addr = _PAGE
        self._clock = 0
        self.num_hosts = 1
        self.fabric: Optional[Fabric] = None
        self.placement: PlacementPolicy = StaticPlacement()
        self._local_capacity = 0
        self._used_local: Dict[int, int] = {0: 0}
        self._pool = SharedPool(0)
        self._segments: Dict[int, SharedSegment] = {}
        # Segment ids are per-instance (and reset by init()) so independent
        # libraries/sessions mint deterministic, non-leaking sids from 0.
        self._next_sid = 0
        # Protocol counters of destroyed segments — coherence_stats()["total"]
        # stays cumulative (like modeled_time) across segment lifecycles.
        self._retired_coherence = CoherenceStats()
        self._device: Optional[torch.device] = None
        self._memory_kinds: Dict[int, Optional[str]] = dict(_PREFERRED_KINDS)
        # Optional linearized event trace (repro_torch.core.trace.TraceRecorder):
        # attached via attach_tracer(), propagated to every live and future
        # segment, and threaded through the queue/engine layers.
        self.tracer = None
        # Plan-time batch-verifier results (repro_torch.core.verify), recorded by
        # OpQueue.flush when preflight != "off": the last batch's full
        # PreflightResult plus cumulative per-code counters, surfaced via
        # coherence_stats()["preflight"].
        self._preflight_last = None
        self._preflight_totals: Dict[str, int] = {
            "batches": 0, "must": 0, "may": 0}
        # Modeled elapsed DMA time per tier (seconds) — the Table III analogue on the
        # target HW; the CPU runtime cannot exhibit real HBM-vs-PCIe gaps.
        self.modeled_time = {LOCAL_MEMORY: 0.0, REMOTE_MEMORY: 0.0}

    # ------------------------------------------------------------------ lifecycle
    def init(
        self,
        local_capacity: Optional[int] = None,
        remote_capacity: Optional[int] = None,
        device="cuda",
        num_hosts: int = 1,
        fabric: Optional[Fabric] = None,
        host_quota=None,
        placement: Optional[PlacementPolicy] = None,
    ) -> None:
        """``emucxl_init``: open the (emulated) CXL device, size the tiers.

        `local_capacity` is per host; `remote_capacity` is the total shared pool.
        `fabric` (optional) routes cross-tier DMAs through contended links;
        `host_quota` partitions the pool (None, uniform int, or {host: bytes});
        `placement` picks the pool port backing each REMOTE allocation.
        `device` ("cuda" by default; None means the same) places LOCAL bytes on
        that device and REMOTE bytes in pinned host memory; "cpu" keeps both
        tiers in host memory. Asking for CUDA without a card raises.
        """
        with self._lock:
            if self._initialized:
                raise EmuCXLError("emucxl_init called twice without emucxl_exit")
            if num_hosts < 1:
                raise EmuCXLError(f"invalid num_hosts {num_hosts}")
            if fabric is not None and fabric.num_hosts < num_hosts:
                raise EmuCXLError(
                    f"fabric has {fabric.num_hosts} hosts, emucxl needs {num_hosts}"
                )
            self._device = resolve_device("cuda" if device is None else device)
            self._memory_kinds = _tier_kinds(self._device)
            self.num_hosts = num_hosts
            self.fabric = fabric
            if placement is not None:
                self.placement = placement
            self._local_capacity = (
                local_capacity if local_capacity is not None else self.hw.hbm_capacity
            )
            pool_capacity = (
                remote_capacity if remote_capacity is not None else self.hw.host_capacity
            )
            self._used_local = {h: 0 for h in range(num_hosts)}
            self._pool = SharedPool(pool_capacity, num_hosts, host_quota)
            self._next_sid = 0
            self._initialized = True

    def exit(self) -> None:
        """``emucxl_exit``: free all allocations, close the device."""
        with self._lock:
            self._require_init()
            self._allocs.clear()
            self._segments.clear()
            self._used_local = {h: 0 for h in range(self.num_hosts)}
            self._pool.reset()
            self._initialized = False

    def _require_init(self) -> None:
        if not self._initialized:
            raise EmuCXLError("emucxl not initialized (call emucxl_init first)")

    def _check_node(self, node: int) -> None:
        if node not in _VALID_NODES:
            raise EmuCXLError(f"invalid node {node}; 0=local, 1=remote")

    def _check_host(self, host: int) -> None:
        if not 0 <= host < self.num_hosts:
            raise EmuCXLError(f"invalid host {host} (instance has {self.num_hosts})")

    def _check_mobile(self, rec: Allocation) -> None:
        if rec.segment is not None:
            raise EmuCXLError(
                f"segment {rec.segment.sid} is pinned to pool port "
                f"{rec.segment.port}; shared mappings cannot migrate or resize"
            )

    def _resolve(self, address: Union[int, Allocation]) -> Allocation:
        if isinstance(address, Allocation):
            address = address.address
        rec = self._allocs.get(address)
        if rec is None:
            raise EmuCXLError(f"invalid address {address:#x} (not an emucxl allocation)")
        return rec

    def _touch(self, rec: Allocation) -> None:
        self._clock += 1
        rec.clock = self._clock

    def memory_kind(self, node: int) -> Optional[str]:
        """The memory kind tier `node` really uses in this instance."""
        self._check_node(node)
        return self._memory_kinds[node]

    def _new_buffer(self, size: int, node: int) -> torch.Tensor:
        """Zeroed bytes on tier `node`: LOCAL on the instance's device, REMOTE
        in host memory, page-locked when the device is a card."""
        if node == LOCAL_MEMORY:
            return torch.zeros((size,), dtype=torch.uint8, device=self._device)
        return torch.zeros((size,), dtype=torch.uint8,
                           pin_memory=self._device.type == "cuda")

    # ------------------------------------------------------------------ allocation
    def _select_port(self) -> int:
        if self.fabric is None:
            return 0
        port = self.placement.select_port(self.fabric)
        if not 0 <= port < self.fabric.pool_ports:
            raise EmuCXLError(f"placement returned invalid pool port {port}")
        return port

    def alloc(self, size: int, node: int, host: int = 0, *,
              _port: Optional[int] = None) -> int:
        """``emucxl_alloc``: allocate `size` bytes on tier `node` for `host`.

        The paper overloads mmap()'s offset field to smuggle the node id into the kernel
        backend; our equivalent side channel is the tier's torch device and pinning.
        REMOTE allocations are charged to `host`'s pool quota and pinned to a pool
        port chosen by the placement policy (`_port` overrides the policy — the
        shared-segment path places its backing explicitly).
        """
        with self._lock:
            self._require_init()
            self._check_node(node)
            self._check_host(host)
            if size <= 0:
                raise EmuCXLError(f"invalid allocation size {size}")
            port = 0
            if node == LOCAL_MEMORY:
                free = self._local_capacity - self._used_local[host]
                if size > free:
                    raise OutOfTierMemory(node, size, free, host)
                self._used_local[host] += size
            else:
                # port selection may raise; it must precede the charge
                port = self._select_port() if _port is None else _port
                if self.fabric is not None and not 0 <= port < self.fabric.pool_ports:
                    raise EmuCXLError(f"invalid pool port {port}")
                try:
                    self._pool.charge(host, size)
                except PoolQuotaError as e:
                    raise QuotaExceeded(e.host, e.requested, e.quota, e.used) from e
                except PoolCapacityError as e:
                    raise OutOfTierMemory(node, size, e.free) from e
            try:
                data = self._new_buffer(size, node)
            except Exception:
                # Modeled accounting passed but the real runtime refused the
                # buffer — roll the charge back so the tier isn't leaked.
                if node == LOCAL_MEMORY:
                    self._used_local[host] -= size
                else:
                    self._pool.release(host, size)
                raise
            addr = self._next_addr
            self._next_addr += -(-size // _PAGE) * _PAGE  # next page boundary
            rec = Allocation(address=addr, size=size, node=node, data=data,
                             host=host, port=port)
            self._touch(rec)
            self._allocs[addr] = rec
            self.modeled_time[node] += self.hw.tier_latency(node)
            return addr

    def free(self, address: Union[int, Allocation], size: Optional[int] = None) -> None:
        """``emucxl_free``: release the block. `size` is accepted for API fidelity and
        validated against the registry (the paper trusts the caller; we do not)."""
        with self._lock:
            rec = self._resolve(address)
            if size is not None and size != rec.size:
                raise EmuCXLError(
                    f"emucxl_free size mismatch: allocation is {rec.size} bytes, caller "
                    f"passed {size}"
                )
            if rec.is_attachment:
                # Freeing a mapping releases the mapping, not the shared bytes.
                self.detach(rec.address)
                return
            if rec.segment is not None and rec.segment.attachments:
                raise EmuCXLError(
                    f"segment {rec.segment.sid} backing cannot be freed with "
                    f"{len(rec.segment.attachments)} attachment(s) live"
                )
            if rec.segment is not None:
                self._segments.pop(rec.segment.sid, None)
                self._retired_coherence.merge(rec.segment.stats)
                self._release_segment_port(rec.segment)
                rec.segment.destroyed = True
            del self._allocs[rec.address]
            if rec.node == LOCAL_MEMORY:
                self._used_local[rec.host] -= rec.size
            else:
                self._pool.release(rec.host, rec.size)

    def resize(self, address: Union[int, Allocation], size: int) -> int:
        """``emucxl_resize``: allocate `size` on the same node, copy, free old, return new.

        The copy is an allocation-to-allocation move, so with a fabric attached it
        routes over the same links a ``migrate``/``memcpy`` between the two
        placements would use (pooled-block resizes show up in link occupancy);
        only without a fabric does it fall back to the uncontended hw constants.
        """
        with self._lock:
            rec = self._resolve(address)
            if rec.segment is not None:
                raise EmuCXLError(
                    "shared segments cannot be resized (fixed mapping geometry)"
                )
            new_addr = self.alloc(size, rec.node, rec.host)
            new_rec = self._allocs[new_addr]
            n = min(size, rec.size)
            new_rec.data[:n].copy_(rec.data[:n])
            if n > 0:
                self._run_plan(self._plan_copy(rec, new_rec, n))
            self.free(rec.address)
            return new_addr

    # ------------------------------------------------------------------ migration
    def _fabric_path(self, rec: Allocation, node: int, host: int,
                     port: int) -> Optional[Tuple[str, ...]]:
        """Fabric links a (rec -> node/host/port) move crosses; None if no data moves
        over the fabric (same placement, or a pure ownership transfer in the pool)."""
        if self.fabric is None:
            return None
        if rec.node == LOCAL_MEMORY and node == REMOTE_MEMORY:
            return self.fabric.pool_path(host, port)       # demote over owner's uplink
        if rec.node == REMOTE_MEMORY and node == LOCAL_MEMORY:
            return self.fabric.pool_path(host, rec.port)   # promote from backing port
        if rec.node == LOCAL_MEMORY and node == LOCAL_MEMORY and rec.host != host:
            return self.fabric.host_path(rec.host, host)
        return None  # REMOTE -> REMOTE: quota re-charge, data stays in the pool

    def migrate(self, address: Union[int, Allocation], node: int,
                host: Optional[int] = None) -> int:
        """``emucxl_migrate``: move the block to (`node`, `host`), return the new address.

        With a fabric attached the DMA routes through it synchronously: the modeled
        time reflects whatever else is in flight on the shared links at that moment.
        """
        with self._lock:
            rec = self._resolve(address)
            self._check_mobile(rec)
            self._check_node(node)
            target_host = rec.host if host is None else host
            self._check_host(target_host)
            if node == rec.node and target_host == rec.host:
                self._touch(rec)
                return rec.address
            new_addr = self.alloc(rec.size, node, target_host)
            new_rec = self._allocs[new_addr]
            path = self._fabric_path(rec, node, target_host, new_rec.port)
            if path is not None:
                self.modeled_time[REMOTE_MEMORY] += self.fabric.transfer(path, rec.size)
            elif node != rec.node or node == LOCAL_MEMORY:
                # No fabric: cross-tier DMA, or a host-to-host copy of local
                # memory (REMOTE->REMOTE host changes are metadata-only).
                self.modeled_time[REMOTE_MEMORY] += self.hw.migrate_time(rec.size)
            # Cross-tier DMA: copy into the new allocation's memory.
            new_rec.data.copy_(rec.data)
            self.free(rec.address)
            return new_addr

    def migrate_batch(
        self, moves: Sequence[Union[Tuple[int, int], Tuple[int, int, Optional[int]]]]
    ) -> Tuple[Dict[int, int], float]:
        """Concurrent ``emucxl_migrate``: all moves are in flight on the fabric at once.

        This is the multi-host hot path — N hosts demoting/promoting simultaneously
        contend for host uplinks and pool ports. Returns ({old_addr: new_addr},
        modeled makespan). Without a fabric, falls back to serial uncontended moves.
        """
        with self._lock:
            self._require_init()
            start_clock = self.fabric.clock if self.fabric is not None else 0.0
            staged: List[Tuple[Allocation, Allocation, int, Optional[Transfer]]] = []
            addr_map: Dict[int, int] = {}
            serial_time = 0.0
            try:
                for move in moves:
                    addr, node = move[0], move[1]
                    host = move[2] if len(move) > 2 else None
                    rec = self._resolve(addr)
                    self._check_mobile(rec)
                    self._check_node(node)
                    target_host = rec.host if host is None else host
                    self._check_host(target_host)
                    if node == rec.node and target_host == rec.host:
                        self._touch(rec)
                        addr_map[rec.address] = rec.address
                        continue
                    new_addr = self.alloc(rec.size, node, target_host)
                    new_rec = self._allocs[new_addr]
                    path = self._fabric_path(rec, node, target_host, new_rec.port)
                    transfer = None
                    if path is not None:
                        transfer = self.fabric.begin(path, rec.size)
                    elif node != rec.node or node == LOCAL_MEMORY:
                        serial_time += self.hw.migrate_time(rec.size)
                    staged.append((rec, new_rec, node, transfer))
                    addr_map[rec.address] = new_addr
            except Exception:
                # A mid-batch alloc failure (quota/capacity) must not leak the
                # moves staged so far: release their destination allocations and
                # deregister their in-flight fabric transfers, leaving sources
                # untouched.
                for _, new_rec, _, transfer in staged:
                    if transfer is not None:
                        self.fabric.cancel(transfer)
                    self.free(new_rec.address)
                raise
            makespan = (self.fabric.drain() - start_clock
                        if self.fabric is not None else serial_time)
            self.modeled_time[REMOTE_MEMORY] += makespan
            for rec, new_rec, _, _ in staged:
                new_rec.data.copy_(rec.data)
                self.free(rec.address)
            return addr_map, makespan

    # ------------------------------------------------------------------ introspection
    def is_local(self, address: Union[int, Allocation]) -> bool:
        with self._lock:
            return self._resolve(address).node == LOCAL_MEMORY

    def get_numa_node(self, address: Union[int, Allocation]) -> int:
        with self._lock:
            return self._resolve(address).node

    def get_host(self, address: Union[int, Allocation]) -> int:
        with self._lock:
            return self._resolve(address).host

    def get_size(self, address: Union[int, Allocation]) -> int:
        with self._lock:
            return self._resolve(address).size

    def get_segment(self, address: Union[int, Allocation]) -> Optional[SharedSegment]:
        """The shared segment an address maps (None for private allocations)."""
        with self._lock:
            return self._resolve(address).segment

    def stats(self, node: int, host: Optional[int] = None) -> int:
        """``emucxl_stats``: bytes allocated on `node` (optionally for one host)."""
        with self._lock:
            self._check_node(node)
            if node == LOCAL_MEMORY:
                if host is None:
                    return sum(self._used_local.values())
                self._check_host(host)
                return self._used_local[host]
            if host is None:
                return self._pool.used
            self._check_host(host)
            return self._pool.used_by_host[host]

    def capacity(self, node: int, host: Optional[int] = None) -> int:
        with self._lock:
            self._check_node(node)
            if node == LOCAL_MEMORY:
                return self._local_capacity if host is not None \
                    else self._local_capacity * self.num_hosts
            return self._pool.capacity

    def host_quota(self, host: int) -> Optional[int]:
        with self._lock:
            self._check_host(host)
            return self._pool.quota(host)

    def pool_stats(self) -> Dict[str, object]:
        """Shared-pool partition view: total + per-host usage and quotas."""
        with self._lock:
            return self._pool.stats()

    def fabric_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-link occupancy/utilization stats (empty without a fabric)."""
        with self._lock:
            return self.fabric.stats() if self.fabric is not None else {}

    def allocations(self) -> Dict[int, Allocation]:
        with self._lock:
            return dict(self._allocs)

    # ------------------------------------------------------------------ access core
    # ONE bounds/validation/accounting core shared by the sync calls below, the
    # async queue's flush planner (core/queue.py), and the coherent-segment
    # path. The tier-attribution rule — applied identically everywhere:
    #
    #   * fabric-routed transfers charge ``modeled_time[REMOTE_MEMORY]`` (the
    #     fabric engine's counter — same convention as ``migrate_batch`` and
    #     ``OpQueue.flush``), regardless of endpoint tiers;
    #   * un-routed cross-tier copies charge ``hw.migrate_time`` to REMOTE;
    #   * un-routed same-tier DMAs/copies charge ``hw.transfer_time`` to the
    #     accessed (destination) tier;
    #   * coherent-segment accesses charge the cached-copy DMA to LOCAL and all
    #     protocol messages (fetch/forward/invalidate/writeback) like any other
    #     pool crossing.
    def _validate_payload(self, flat: np.ndarray, n: int) -> None:
        """Shared sync/async check: the staging buffer must supply what the
        caller claims (a short buffer used to die with an opaque shape error
        on the sync path — or silently short-copy)."""
        if flat.size < n:
            raise EmuCXLError(
                f"write supplies {flat.size} bytes but claims size {n}"
            )

    def _storage_rec(self, rec: Allocation) -> Allocation:
        """The record owning `rec`'s bytes (the backing record for segment
        attachments — every attachment aliases the single pooled copy)."""
        if rec.segment is not None and rec.address != rec.segment.backing_addr:
            return self._allocs[rec.segment.backing_addr]
        return rec

    def _plan_dma(self, rec: Allocation, offset: int, n: int, write: bool,
                  journal: Optional[DirectoryJournal] = None) -> "_AccessPlan":
        """Plan a compute <-> tier DMA on one allocation: bounds, coherence
        protocol (for shared segments), fabric routes, fallback constants.

        `journal` (batch planning only) records every coherence mutation so a
        mid-batch failure can unwind transitions planned by earlier ops."""
        self._bounds(rec, offset, n)
        plan = _AccessPlan()
        if n <= 0:
            return plan
        if rec.segment is not None:
            seg = rec.segment
            planner = seg.plan_write if write else seg.plan_read
            self._route_msgs(
                plan, planner(self.fabric, rec.host, offset, n, journal))
            # The access itself hits the host's now-coherent cached copy.
            plan.hw_charges.append(
                (LOCAL_MEMORY, self.hw.transfer_time(n, LOCAL_MEMORY)))
            return plan
        if rec.node == REMOTE_MEMORY and self.fabric is not None:
            plan.routes.append((self.fabric.pool_path(rec.host, rec.port), n))
        else:
            plan.hw_charges.append((rec.node, self.hw.transfer_time(n, rec.node)))
        return plan

    def _route_msgs(self, plan: "_AccessPlan", msgs) -> None:
        """Attach coherence messages to a plan: fabric-routed when a path
        exists, otherwise costed with the uncontended pool-crossing constant
        (always a REMOTE charge — every message crosses the pool port)."""
        for msg in msgs:
            if msg.path:
                plan.routes.append((msg.path, msg.nbytes))
            else:
                plan.hw_charges.append(
                    (REMOTE_MEMORY, self.hw.migrate_time(msg.nbytes)))

    def _copy_path(self, srec: Allocation, drec: Allocation) -> Optional[Tuple[str, ...]]:
        """Fabric links a src -> dst copy crosses (None = stays off the fabric)."""
        if self.fabric is None:
            return None
        if srec.node == LOCAL_MEMORY and drec.node == LOCAL_MEMORY:
            if srec.host == drec.host:
                return None
            return self.fabric.host_path(srec.host, drec.host)
        if srec.node == LOCAL_MEMORY:
            return self.fabric.pool_path(srec.host, drec.port)
        if drec.node == LOCAL_MEMORY:
            return self.fabric.pool_path(drec.host, srec.port)
        if srec.port == drec.port:
            return (self.fabric.pool_link(srec.port),)
        return (self.fabric.pool_link(srec.port), self.fabric.pool_link(drec.port))

    def _plan_copy(self, srec: Allocation, drec: Allocation, n: int,
                   journal: Optional[DirectoryJournal] = None) -> "_AccessPlan":
        """Plan an allocation-to-allocation copy (memcpy/resize), including the
        coherence protocol when either side is a shared mapping."""
        self._bounds(srec, 0, n)
        self._bounds(drec, 0, n)
        plan = _AccessPlan()
        if n <= 0:
            return plan
        if srec.segment is not None or drec.segment is not None:
            # A copy touching a coherent mapping is its two DMA halves: each
            # side costs exactly what read()/write() of that side costs (cached
            # LOCAL access + protocol messages for the coherent side, ordinary
            # DMA for a private side). A write hit therefore crosses no link —
            # the protocol, not the payload, decides the fabric traffic.
            for half in (self._plan_dma(srec, 0, n, write=False, journal=journal),
                         self._plan_dma(drec, 0, n, write=True, journal=journal)):
                plan.hw_charges.extend(half.hw_charges)
                plan.routes.extend(half.routes)
            return plan
        path = self._copy_path(srec, drec)
        if path is not None:
            plan.routes.append((path, n))
        elif drec.node != srec.node:
            plan.hw_charges.append((REMOTE_MEMORY, self.hw.migrate_time(n)))
        else:
            plan.hw_charges.append((drec.node, self.hw.transfer_time(n, drec.node)))
        return plan

    def _plan_fence(self, rec: Allocation,
                    journal: Optional[DirectoryJournal] = None) -> "_AccessPlan":
        """Plan a release fence on one segment mapping: drain `rec.host`'s
        write-combining buffer into M-upgrades (invalidations/writebacks/RFO
        fetches), routed like any other coherence messages."""
        if rec.segment is None:
            raise EmuCXLError(
                f"address {rec.address:#x} is not a shared-segment mapping; "
                f"fence targets coherent attachments"
            )
        plan = _AccessPlan()
        self._route_msgs(
            plan, rec.segment.plan_fence(self.fabric, rec.host, journal))
        return plan

    def fence(self, address: Union[int, Allocation, None] = None) -> float:
        """``emucxl_fence``: publish write-combined stores (release semantics).

        With `address` (a segment mapping), fences that (segment, host) pair;
        with None, fences every pending (segment, host) pair in the instance.
        Returns the modeled seconds the fence's protocol traffic occupied —
        0.0 when nothing was pending (eager segments fence for free)."""
        with self._lock:
            self._require_init()
            plan = _AccessPlan()
            if address is not None:
                rec = self._resolve(address)
                plan = self._plan_fence(rec)
                self._touch(rec)
            else:
                for seg in self._segments.values():
                    for host in sorted(seg.wc):
                        self._route_msgs(
                            plan, seg.plan_fence(self.fabric, host))
            return self._run_plan(plan)

    def acquire(self, address: Union[int, Allocation, None] = None) -> float:
        """``emucxl_acquire``: the read-side half of release consistency.

        An acquire guarantees that every write published by a *peer's* release
        fence before this point is visible to subsequent reads on this
        mapping. In the synchronous world that guarantee already holds the
        moment ``fence`` returns — there are no in-flight releases for an
        acquire to wait on — so a sync acquire validates its target, orders
        program text, and charges nothing (returns 0.0). The interesting case
        is the async queue: an ``AcquireOp`` submitted in a batch blocks its
        (segment, host) stream until the peer release fences planned before it
        have drained their write-combining traffic (see ``OpQueue.flush``).

        With `address` (a shared-segment mapping), acquires on that (segment,
        host); with None, a full acquire over every attached segment. Raises
        on a private (non-segment) address, exactly like ``fence``."""
        with self._lock:
            self._require_init()
            if address is not None:
                rec = self._resolve(address)
                if rec.segment is None:
                    raise EmuCXLError(
                        f"address {rec.address:#x} is not a shared-segment "
                        f"mapping; acquire targets coherent attachments"
                    )
                # The happens-before edge: join every peer's published
                # release clock into this host's view. Free at runtime,
                # but required for later reads to be race-clean.
                rec.segment.plan_acquire(rec.host)
                self._touch(rec)
            else:
                for seg in self._segments.values():
                    for host in sorted(seg.attached_hosts):
                        seg.plan_acquire(host)
            return 0.0

    def _maybe_check(self) -> None:
        """EMUCXL_CHECK=1 debug mode: assert the directory invariant (single
        M/E owner, exclusivity) across all live segments."""
        if _debug_check_enabled():
            for seg in self._segments.values():
                seg.directory.check()

    def _run_plan(self, plan: "_AccessPlan") -> float:
        """Synchronously execute a plan's transfers and charge modeled time.

        All routed components begin together and drain as one span (an access's
        coherence messages and data DMA are concurrent on the fabric), charged
        to the REMOTE counter; the hw fallback charges the plan's tier. The
        async queue charges the identical amounts from flush() — that parity is
        tested, not assumed."""
        elapsed = 0.0
        if plan.routes:
            start = self.fabric.clock
            for path, nbytes in plan.routes:
                self.fabric.begin(path, nbytes)
            self.fabric.drain()
            span = self.fabric.clock - start
            self.modeled_time[REMOTE_MEMORY] += span
            elapsed += span
        for tier, t in plan.hw_charges:
            self.modeled_time[tier] += t
            elapsed += t
        self._maybe_check()
        return elapsed

    # ------------------------------------------------------------------ data movement
    def read(self, address: Union[int, Allocation], offset: int, buf_size: int) -> np.ndarray:
        """``emucxl_read``: DMA `buf_size` bytes at `offset` out of the allocation."""
        with self._lock:
            rec = self._resolve(address)
            plan = self._plan_dma(rec, offset, buf_size, write=False)
            self._touch(rec)
            self._run_plan(plan)
            store = self._storage_rec(rec)
            # A copy, never a view: later writes must not change what was read.
            return store.data[offset : offset + buf_size].to(
                "cpu", copy=True).numpy()

    def write(self, buf: np.ndarray, offset: int, address: Union[int, Allocation],
              buf_size: Optional[int] = None) -> bool:
        """``emucxl_write``: DMA bytes from `buf` into the allocation at `offset`."""
        with self._lock:
            rec = self._resolve(address)
            flat = np.asarray(buf, dtype=np.uint8).reshape(-1)
            n = buf_size if buf_size is not None else flat.size
            self._validate_payload(flat, n)
            plan = self._plan_dma(rec, offset, n, write=True)
            store = self._storage_rec(rec)
            store.data[offset : offset + n].copy_(torch.tensor(flat[:n]))
            self._touch(rec)
            self._run_plan(plan)
            return True

    def memset(self, address: Union[int, Allocation], value: int, size: int) -> int:
        """``emucxl_memset``: fill `size` bytes with `value` (paper: 0 or -1)."""
        with self._lock:
            rec = self._resolve(address)
            plan = self._plan_dma(rec, 0, size, write=True)
            store = self._storage_rec(rec)
            store.data[:size].fill_(value & 0xFF)
            self._touch(rec)
            self._run_plan(plan)
            return rec.address

    def memcpy(self, dst: Union[int, Allocation], src: Union[int, Allocation],
               size: int) -> int:
        with self._lock:
            drec, srec = self._resolve(dst), self._resolve(src)
            # A copy plans two DMA halves; if the write-half's race check
            # raises after the read-half already moved directory state, the
            # journal unwinds the half-planned transitions (the single-plan
            # sync ops need no journal — their checks precede any mutation).
            journal = DirectoryJournal() if any(
                r.segment is not None and r.segment.detector is not None
                for r in (srec, drec)) else None
            try:
                plan = self._plan_copy(srec, drec, size, journal)
            except Exception:
                if journal is not None:
                    journal.rollback()
                raise
            sstore, dstore = self._storage_rec(srec), self._storage_rec(drec)
            dstore.data[:size].copy_(sstore.data[:size])
            self._touch(drec)
            self._touch(srec)
            self._run_plan(plan)
            return drec.address

    def memmove(self, dst, src, size: int) -> int:
        """Identical to memcpy (distinct allocations never overlap) — see module docs."""
        return self.memcpy(dst, src, size)

    # ------------------------------------------------------------------ shared segments
    def share(self, size: int, host: int = 0, page_bytes: int = _PAGE,
              writers: Optional[Sequence[int]] = None,
              consistency: str = EAGER,
              wc_capacity: Optional[int] = DEFAULT_WC_CAPACITY,
              race_detect: Optional[str] = None,
              home: Optional[object] = None
              ) -> SharedSegment:
        """Create a hardware-coherent shared segment of `size` bytes.

        One pooled allocation backs the segment (charged to `host`'s quota —
        the *only* charge no matter how many hosts attach); its pool port comes
        from the placement policy, which may use the `writers` hint, the
        consistency mode, and `wc_capacity` to co-locate the segment's port
        away from other write-heavy segments (``SharingAwarePlacement`` weighs
        ``consistency="release"`` segments lighter the deeper their
        write-combining buffer — combining defuses their invalidation storms).
        `wc_capacity` bounds the per-host write-combining buffer in pages
        (default ``DEFAULT_WC_CAPACITY``; None = unbounded; ignored by eager
        segments, which never buffer): a full buffer force-drains its LRU
        pending page through the normal upgrade protocol. Returns the
        ``SharedSegment``; call ``attach`` to map it for a host, and — for
        release segments — ``fence`` to publish write-combined stores.

        `race_detect` arms the happens-before race detector (core/race.py) on
        release segments: ``"warn"`` records conflicts into
        ``stats.races``/``coherence_stats()["races"]``, ``"raise"`` raises
        ``RaceError`` at the conflicting access, ``"off"`` disables it. The
        default ``None`` defers to the environment — ``EMUCXL_CHECK=race``
        means ``"raise"``; an explicit value always wins over the env.

        `home` optionally shards the segment's directory across pool ports: a
        ``DirectoryHomePolicy`` (core/policy.py — e.g. ``StripedHome``) maps
        each page to the pool port *homing* its directory entry, and every
        protocol message for that page is charged over the fabric route to
        its home instead of the segment's backing port. Default ``None``
        keeps the whole directory on the backing port.
        """
        with self._lock:
            self._require_init()
            self._check_host(host)
            if page_bytes <= 0:
                # Validated before anything is charged — a failed share must
                # not leak a pool charge or placement-policy state.
                raise EmuCXLError(f"invalid segment page_bytes {page_bytes}")
            if consistency not in _CONSISTENCY_MODES:
                raise EmuCXLError(
                    f"unknown consistency {consistency!r}; options: "
                    f"{list(_CONSISTENCY_MODES)}"
                )
            if wc_capacity is not None and wc_capacity < 1:
                raise EmuCXLError(
                    f"invalid wc_capacity {wc_capacity}; need >= 1 page per "
                    f"host (or None for an unbounded buffer)"
                )
            if race_detect is not None and race_detect not in RACE_MODES:
                raise EmuCXLError(
                    f"unknown race_detect {race_detect!r}; options: "
                    f"{list(RACE_MODES)}"
                )
            writer_hosts = list(writers) if writers is not None else [host]
            for w in writer_hosts:
                self._check_host(w)
            hints = {"consistency": consistency, "wc_capacity": wc_capacity}
            port = None
            weight = 0
            picker = (getattr(self.placement, "select_port_for_segment", None)
                      if self.fabric is not None else None)
            if picker is not None:
                port = _call_with_hints(
                    picker, hints, self.fabric, writer_hosts)
                # the policy just charged this weight to the port; pay it back
                # on any failure below (and on destroy)
                weigher = getattr(self.placement, "segment_weight",
                                  lambda w: 1)
                weight = _call_with_hints(weigher, hints, writer_hosts)
            backing_addr = None
            try:
                if port is not None and not 0 <= port < self.fabric.pool_ports:
                    raise EmuCXLError(
                        f"placement returned invalid pool port {port}")
                backing_addr = self.alloc(size, REMOTE_MEMORY, host, _port=port)
                seg = SharedSegment(size, page_bytes, backing_addr, host,
                                    self._allocs[backing_addr].port,
                                    sid=self._next_sid, consistency=consistency,
                                    wc_capacity=wc_capacity,
                                    race_detect=race_detect, home=home)
            except Exception:
                # A failed share must not leak: pay the policy weight back AND
                # release the backing charge if the alloc had already landed.
                if backing_addr is not None:
                    self.free(backing_addr)
                releaser = getattr(self.placement, "release_segment_port", None)
                if releaser is not None and weight:
                    releaser(port, weight)
                raise
            self._next_sid += 1
            backing = self._allocs[backing_addr]
            seg.placement_weight = weight
            seg.tracer = self.tracer
            backing.segment = seg
            self._segments[seg.sid] = seg
            return seg

    def attach(self, segment: SharedSegment, host: int = 0) -> int:
        """Map `segment` into `host`'s address space; returns the mapping's
        address. The mapping aliases the pooled bytes — no new pool charge —
        and all reads/writes through it run the coherence protocol."""
        with self._lock:
            self._require_init()
            self._check_host(host)
            if segment.destroyed or segment.sid not in self._segments:
                raise EmuCXLError(f"segment {segment.sid} has been destroyed")
            backing = self._allocs[segment.backing_addr]
            addr = self._next_addr
            self._next_addr += -(-segment.size // _PAGE) * _PAGE
            rec = Allocation(address=addr, size=segment.size, node=REMOTE_MEMORY,
                             data=backing.data, host=host, port=segment.port,
                             segment=segment)
            self._touch(rec)
            self._allocs[addr] = rec
            segment.attachments.add(addr)
            segment.attached_hosts[host] = segment.attached_hosts.get(host, 0) + 1
            # Mapping setup is a metadata op: one remote-latency floor, no DMA.
            self.modeled_time[REMOTE_MEMORY] += self.hw.tier_latency(REMOTE_MEMORY)
            return addr

    def detach(self, address: Union[int, Allocation]) -> None:
        """Unmap a segment attachment. The host's last detach flushes it out of
        the directory (dirty pages write back over the fabric)."""
        with self._lock:
            rec = self._resolve(address)
            if not rec.is_attachment:
                raise EmuCXLError(
                    f"address {rec.address:#x} is not a segment attachment"
                )
            seg = rec.segment
            seg.attachments.discard(rec.address)
            remaining = seg.attached_hosts.get(rec.host, 1) - 1
            if remaining <= 0:
                seg.attached_hosts.pop(rec.host, None)
                plan = _AccessPlan()
                self._route_msgs(plan, seg.plan_detach(self.fabric, rec.host))
                self._run_plan(plan)
            else:
                seg.attached_hosts[rec.host] = remaining
            del self._allocs[rec.address]

    def _release_segment_port(self, seg: SharedSegment) -> None:
        """Pay a destroyed segment's writer weight back to the placement policy
        so future segments are placed against live load, not history."""
        releaser = getattr(self.placement, "release_segment_port", None)
        if releaser is not None and seg.placement_weight:
            releaser(seg.port, seg.placement_weight)
            seg.placement_weight = 0

    def destroy_segment(self, segment: SharedSegment) -> None:
        """Release a segment's pooled backing. All attachments must be detached
        first (freeing the bytes under a live mapping would un-model CXL)."""
        with self._lock:
            self.free(segment.backing_addr)

    def segments(self) -> Dict[int, SharedSegment]:
        with self._lock:
            return dict(self._segments)

    def attach_tracer(self, tracer, transfers: bool = False) -> None:
        """Attach a ``TraceRecorder`` (repro_torch.core.trace) — or ``None`` to
        detach — capturing a linearized event trace of every coherence plan,
        queue flush, and engine job. Propagates to all live segments;
        segments shared later inherit it at creation.

        ``transfers=True`` additionally propagates the recorder to the fabric,
        which then emits per-transfer ``transfer-begin`` / ``transfer-complete``
        (resolved route, bytes, port-queue wait) and ``transfer-drop`` events.
        Off by default: every sync DMA becomes two extra events, which changes
        the trace's linearized shape for tooling that replays plan-level
        events only."""
        with self._lock:
            self.tracer = tracer
            for seg in self._segments.values():
                seg.tracer = tracer
            if self.fabric is not None:
                self.fabric.tracer = tracer if transfers else None

    def _record_preflight(self, result) -> None:
        """Fold one flush's ``PreflightResult`` into the running totals
        (meta-state only: never part of the journaled protocol state)."""
        with self._lock:
            self._preflight_last = result
            totals = self._preflight_totals
            totals["batches"] += 1
            totals["must"] += result.must_count
            totals["may"] += result.may_count
            for d in result.diagnostics:
                totals[d.code] = totals.get(d.code, 0) + 1

    def coherence_stats(self) -> Dict[str, object]:
        """Fleet-wide + per-segment protocol counters (the coherence analogue
        of ``fabric_stats``)."""
        with self._lock:
            total = total_stats(self._segments.values())
            total.merge(self._retired_coherence)
            return {
                "total": total.as_dict(),
                "segments": {sid: seg.describe()
                             for sid, seg in self._segments.items()},
                # Conflicts recorded by race_detect="warn" detectors, in
                # detection order, deduped — each entry carries a "count" of
                # how many times the identical (page, sites, edge) conflict
                # recurred (strict mode raises instead of recording).
                "races": [d
                          for seg in self._segments.values()
                          if seg.detector is not None
                          for d in seg.detector.report()],
                # Plan-time verifier findings (repro_torch.core.verify): the last
                # preflighted batch in full, plus cumulative counters.
                "preflight": {
                    "last": (self._preflight_last.as_dict()
                             if self._preflight_last is not None else None),
                    "totals": dict(self._preflight_totals),
                },
            }

    # ------------------------------------------------------------------ tensor views
    def alloc_array(self, shape, dtype, node: int, host: int = 0) -> int:
        """Framework convenience: allocate bytes sized for `shape`/`dtype` on `node`."""
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        addr = self.alloc(max(nbytes, 1), node, host)
        return addr

    def read_array(self, address, shape, dtype) -> np.ndarray:
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        raw = self.read(address, 0, nbytes)
        return raw.view(np.dtype(dtype)).reshape(shape)

    def write_array(self, array, address) -> bool:
        raw = np.ascontiguousarray(array).view(np.uint8).reshape(-1)
        return self.write(raw, 0, address)

    def _bounds(self, rec: Allocation, offset: int, n: int) -> None:
        if offset < 0 or n < 0 or offset + n > rec.size:
            raise EmuCXLError(
                f"out-of-bounds access [{offset}, {offset + n}) on {rec.size}-byte block"
            )


# --------------------------------------------------------------------- C-style facade
# The paper-fidelity v1 surface, reimplemented as a thin shim over a default v2
# session (core/api.py). Addresses stay ints for drop-in compatibility, but every
# one is backed by a generation-counted handle, so the facade now raises a clear
# EmuCXLError on use-after-free / double-free / stale-after-resize instead of
# silently treating a dead address as garbage (or, worse, as a neighbour).
_default = EmuCXL()


def default_instance() -> EmuCXL:
    """The process-default library instance the v1 facade (and middleware
    defaults) operate on. v2 code should construct ``CXLSession``s instead."""
    return _default


class _V1Facade:
    """Address-keyed view of the default session.

    ``_bufs`` maps each *current* address to its Buffer; ``_retired`` holds a
    compact tombstone per address invalidated by free/migrate/resize so errors
    can say what happened to it. Tombstones are O(addresses ever retired) —
    addresses are never recycled, and the emulator deliberately trades that
    bounded-per-op memory for precise use-after-free diagnostics; everything
    else (the Buffer, its handle-table slot) is released on free.
    """

    def __init__(self):
        self.session = None
        self._bufs = {}
        self._retired = {}   # old address -> (reason, replacement address)

    # -- lifecycle ---------------------------------------------------------
    def init(self, local_capacity=None, remote_capacity=None, device="cuda",
             num_hosts=1, fabric=None, host_quota=None, placement=None) -> None:
        from repro_torch.core.api import CXLSession

        # Adopting _default keeps default_instance() users (middleware defaults,
        # the paper's EmuQueue) on the same fabric domain; EmuCXL.init itself
        # rejects double initialization.
        session = CXLSession(
            local_capacity, remote_capacity, device=device, num_hosts=num_hosts,
            fabric=fabric, host_quota=host_quota, placement=placement,
            lib=_default,
        )
        self.session = session
        self._bufs.clear()
        self._retired.clear()

    def exit(self) -> None:
        session, self.session = self.session, None
        self._bufs.clear()
        self._retired.clear()
        if session is None and not _default._initialized:
            _default.exit()  # raises the canonical "not initialized" error
            return
        try:
            if session is not None:
                session.close()
        finally:
            # Adopted/wrapped sessions don't own the lib's lifecycle, and the
            # legacy direct-init pattern has no session at all — v1's exit
            # always closes the default instance regardless.
            if _default._initialized:
                _default.exit()

    def _require_session(self):
        if self.session is None:
            if _default._initialized:
                # Legacy interop: default_instance().init(...) followed by
                # emucxl_* calls. Adopt the already-open instance into a
                # session so the facade works on it (without owning it — but
                # emucxl_exit still closes the default instance, see exit()).
                from repro_torch.core.api import CXLSession

                self.session = CXLSession.wrap(_default)
                return self.session
            raise EmuCXLError("emucxl not initialized (call emucxl_init first)")
        return self.session

    # -- address book ------------------------------------------------------
    def lookup(self, address):
        """Address -> Buffer, with precise staleness diagnostics.

        Addresses allocated *directly* on the default instance (legacy
        ``default_instance().alloc`` callers) are adopted into the session's
        handle table on first facade use, so mixing the two styles keeps
        working — drop-in compatibility includes that pattern."""
        if isinstance(address, Allocation):
            address = address.address
        session = self._require_session()
        buf = self._bufs.get(address)
        if buf is not None:
            return buf
        if address in session.lib._allocs:
            buf = session._register(address)
            self._bufs[address] = buf
            return buf
        stale = self._retired.get(address)
        if stale is not None:
            reason, replacement = stale
            if reason == "free":
                raise EmuCXLError(f"use-after-free: address {address:#x} was freed")
            raise EmuCXLError(
                f"stale address {address:#x}: superseded by {reason} "
                f"(current address {replacement:#x})"
            )
        raise EmuCXLError(f"invalid address {address:#x} (not an emucxl allocation)")

    def was_freed(self, address) -> bool:
        if isinstance(address, Allocation):
            address = address.address
        stale = self._retired.get(address)
        return stale is not None and stale[0] == "free"

    def register(self, buf) -> int:
        address = buf.address
        self._bufs[address] = buf
        return address

    def rebind(self, old_address: int, buf, reason: str) -> int:
        """Record that `old_address`'s buffer now lives at a new address.

        Idempotent: a batch listing the same address twice (chained migrates of
        one buffer) rebinds cleanly to the final address both times."""
        new_address = buf.address
        if new_address != old_address:
            self._bufs.pop(old_address, None)
            self._retired[old_address] = (reason, new_address)
            self._bufs[new_address] = buf
        return new_address

_facade = _V1Facade()


def default_session():
    """The v2 session behind the v1 facade (None before ``emucxl_init``)."""
    return _facade.session


def emucxl_init(local_capacity=None, remote_capacity=None, device="cuda",
                num_hosts: int = 1, fabric=None, host_quota=None,
                placement=None) -> None:
    _facade.init(local_capacity, remote_capacity, device, num_hosts, fabric,
                 host_quota, placement)


def emucxl_exit() -> None:
    _facade.exit()


def emucxl_alloc(size: int, node: int, host: int = 0) -> int:
    return _facade.register(_facade._require_session().alloc(size, node, host))


def emucxl_free(address, size=None) -> None:
    if _facade.was_freed(address):
        addr = address.address if isinstance(address, Allocation) else address
        raise EmuCXLError(f"double free of address {addr:#x}")
    buf = _facade.lookup(address)
    # One authoritative size-mismatch check, on the session path.
    _facade._require_session().free(buf, size)
    addr = address.address if isinstance(address, Allocation) else address
    del _facade._bufs[addr]
    _facade._retired[addr] = ("free", addr)


def emucxl_resize(address, size: int) -> int:
    buf = _facade.lookup(address)
    old_address = buf.address
    return _facade.rebind(old_address, buf.resize(size), "resize")


def emucxl_migrate(address, node: int, host: Optional[int] = None) -> int:
    buf = _facade.lookup(address)
    old_address = buf.address
    return _facade.rebind(old_address, buf.migrate(node, host), "migrate")


def emucxl_migrate_batch(moves) -> Tuple[Dict[int, int], float]:
    """Concurrent moves of [(addr, node[, host]), ...] — now routed through the
    v2 async queue; returns ({old_addr: new_addr}, modeled makespan) as before.

    All addresses are resolved up front and the batch itself delegates to
    ``CXLSession.migrate_batch`` (one copy of the all-or-nothing staging)."""
    session = _facade._require_session()
    staged = []
    v2_moves = []
    for move in moves:
        address, node = move[0], move[1]
        host = move[2] if len(move) > 2 else None
        buf = _facade.lookup(address)
        staged.append((buf.address, buf))
        v2_moves.append((buf, node, host))
    makespan = session.migrate_batch(v2_moves)
    addr_map = {}
    for old_address, buf in staged:
        addr_map[old_address] = _facade.rebind(old_address, buf, "migrate")
    return addr_map, makespan


def emucxl_is_local(address) -> bool:
    return _facade.lookup(address).is_local


def emucxl_get_numa_node(address) -> int:
    return _facade.lookup(address).node


def emucxl_get_host(address) -> int:
    return _facade.lookup(address).host


def emucxl_get_size(address) -> int:
    return _facade.lookup(address).size


def emucxl_stats(node: int, host: Optional[int] = None) -> int:
    return _facade._require_session().stats(node, host)


def emucxl_pool_stats() -> Dict[str, object]:
    return _facade._require_session().pool_stats()


def emucxl_fabric_stats() -> Dict[str, Dict[str, float]]:
    return _facade._require_session().fabric_stats()


def emucxl_read(address, offset: int, buf_size: int) -> np.ndarray:
    return _facade.lookup(address).read(offset, buf_size)


def emucxl_write(buf, offset: int, address, buf_size=None) -> bool:
    _facade.lookup(address).write(buf, offset, buf_size)
    return True


def emucxl_memset(address, value: int, size: int) -> int:
    return _facade.lookup(address).memset(value, size).address


def emucxl_memcpy(dst, src, size: int) -> int:
    session = _facade._require_session()
    return session.memcpy(_facade.lookup(dst), _facade.lookup(src), size).address


def emucxl_memmove(dst, src, size: int) -> int:
    return emucxl_memcpy(dst, src, size)


def emucxl_fence(address=None) -> float:
    """Release fence (v1 spelling): publish write-combined stores.

    With `address` (a shared-segment mapping), fences that mapping's (segment,
    host); with no argument, fences everything pending in the default
    instance. Returns the modeled seconds of protocol traffic the fence
    emitted (0.0 when nothing was pending)."""
    session = _facade._require_session()
    if address is None:
        return session.fence()
    return session.fence(_facade.lookup(address))


def emucxl_acquire(address=None) -> float:
    """Acquire fence (v1 spelling): the read-side pair of ``emucxl_fence``.

    Guarantees later reads through `address` (or any mapping, with no
    argument) observe every write a peer's release fence published before
    this point. Synchronous execution already provides that ordering, so the
    call validates its target and returns 0.0 — the modeled wait only becomes
    nonzero under the async queue's ``AcquireOp``, where in-flight releases
    exist to wait on."""
    session = _facade._require_session()
    if address is None:
        return session.acquire()
    return session.acquire(_facade.lookup(address))
