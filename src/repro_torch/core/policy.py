"""Placement / promotion policies for pooled disaggregated memory (paper §IV-B).

Policy1 — optimistic: a remote hit promotes the object to the local tier (caching for
subsequent access), possibly demoting the local LRU victim.
Policy2 — conservative: remote hits are served in place; nothing moves.

The paper evaluates these on its KV-store middleware (Table IV); here the same policy
objects also drive the serving-time paged KV-cache manager, so the comparison carries
over to a real workload (hot KV pages in HBM, cold pages in host memory).

Beyond the paper, the multi-host fabric (core/fabric.py) adds a *congestion* axis:
``CongestionAwarePlacement`` spreads REMOTE allocations across pool ports by live link
occupancy, and ``CongestionAwarePromotion`` suppresses optimistic promotion while the
owner's uplink is busy. Both degrade to their static counterparts on an idle fabric,
so single-host behavior is unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Hashable, Optional, Protocol


class Tier(enum.IntEnum):
    LOCAL = 0
    REMOTE = 1


class PromotionPolicy(Protocol):
    """Decides whether a remote hit should be promoted to the local tier."""

    name: str

    def promote_on_hit(self, key: Hashable) -> bool: ...


@dataclasses.dataclass(frozen=True)
class Policy1:
    """Optimistic promotion (paper Policy1): every remote hit moves the object local."""

    name: str = "policy1-optimistic"

    def promote_on_hit(self, key: Hashable) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Policy2:
    """Conservative (paper Policy2): serve remote hits in place, never move."""

    name: str = "policy2-conservative"

    def promote_on_hit(self, key: Hashable) -> bool:
        return False


@dataclasses.dataclass
class AccessStats:
    """Hit accounting used to reproduce the paper's Table IV ("% local")."""

    local_hits: int = 0
    remote_hits: int = 0
    misses: int = 0

    @property
    def total(self) -> int:
        return self.local_hits + self.remote_hits + self.misses

    @property
    def percent_local(self) -> float:
        hits = self.local_hits + self.remote_hits
        return 100.0 * self.local_hits / hits if hits else 0.0

    def reset(self) -> None:
        self.local_hits = self.remote_hits = self.misses = 0


# ---------------------------------------------------------------- fabric-aware layer
class PlacementPolicy(Protocol):
    """Picks the pool port backing a new REMOTE allocation."""

    name: str

    def select_port(self, fabric) -> int: ...


@dataclasses.dataclass(frozen=True)
class StaticPlacement:
    """Naive placement: every pooled allocation lands on one fixed port."""

    port: int = 0
    name: str = "static"

    def select_port(self, fabric) -> int:
        return self.port


@dataclasses.dataclass(frozen=True)
class CongestionAwarePlacement:
    """Pick the pool port with the fewest in-flight transfers on its link.

    Falls back to the static port when no fabric is attached or the fabric is idle
    (zero in-flight transfers) — identical to ``StaticPlacement`` until load appears.
    """

    fallback_port: int = 0
    name: str = "congestion-aware"

    def select_port(self, fabric) -> int:
        if fabric is None or fabric.idle():
            return self.fallback_port
        return fabric.least_loaded_port()


@dataclasses.dataclass
class SharingAwarePlacement:
    """Placement for coherent shared segments: keep write-heavy segments apart.

    Every coherence message a segment emits (fetch, back-invalidation, dirty
    writeback) crosses the segment's pool port, so two heavily-written segments
    sharing one port serialize each other's invalidation storms. This policy
    tracks, per port, the writer-host weight of segments already placed there
    and assigns each new segment the port with the least accumulated writer
    weight (ties: live link occupancy, then lowest index). Write-combining
    segments (``consistency="release"``) charge half weight: their upgrades
    batch at fences, so their invalidation pressure on the port is a fraction
    of an eager segment's. Plain allocations fall back to congestion-aware
    behavior so the policy is a drop-in ``placement=`` for ``EmuCXL.init`` /
    ``CXLSession``.
    """

    fallback_port: int = 0
    name: str = "sharing-aware"

    def __post_init__(self):
        self._port_writer_weight: dict = {}

    def select_port(self, fabric) -> int:
        if fabric is None or fabric.idle():
            return self.fallback_port
        return fabric.least_loaded_port()

    @staticmethod
    def segment_weight(writer_hosts, consistency: str = "eager",
                       wc_capacity: Optional[int] = None) -> int:
        """The load a segment charges its port — ONE formula, used both when
        charging (select) and when releasing (destroy/failed share). Release
        segments count their writers at half weight (rounded up): fences batch
        their invalidation traffic. A bounded write-combining buffer scales
        that discount back toward eager weight — at ``wc_capacity=1`` nearly
        every write force-drains immediately, so the segment's invalidation
        pressure IS eager pressure; deep buffers (or None = unbounded) earn
        the full half-weight discount."""
        writers = max(len(set(writer_hosts)), 1)
        if consistency != "release":
            return writers
        half = max((writers + 1) // 2, 1)
        if wc_capacity is None:
            return half
        return half + (writers - half) // wc_capacity

    def select_port_for_segment(self, fabric, writer_hosts,
                                consistency: str = "eager",
                                wc_capacity: Optional[int] = None) -> int:
        weight = self.segment_weight(writer_hosts, consistency, wc_capacity)
        port = min(
            range(fabric.pool_ports),
            key=lambda j: (self._port_writer_weight.get(j, 0),
                           fabric.links[fabric.pool_link(j)].occupancy, j),
        )
        self._port_writer_weight[port] = (
            self._port_writer_weight.get(port, 0) + weight
        )
        return port

    def release_segment_port(self, port: int, weight: int) -> None:
        """Segment destroyed: stop counting its writers against the port."""
        remaining = self._port_writer_weight.get(port, 0) - weight
        if remaining > 0:
            self._port_writer_weight[port] = remaining
        else:
            self._port_writer_weight.pop(port, None)


# ------------------------------------------------------- directory home nodes
class DirectoryHomePolicy(Protocol):
    """Assigns each coherent page a *home* pool port for its directory entry.

    Every directory message a page generates — RFO fetch, invalidation,
    dirty writeback, fence drain — is charged over the fabric route to that
    page's home port (``SharedSegment.home_port``). Without a policy all of a
    segment's pages home on its backing port, which makes that one port the
    directory-bandwidth bottleneck for the whole segment; a sharding policy
    spreads the protocol load across the topology's ports.
    """

    name: str

    def home_port(self, sid: int, page: int, pool_ports: int) -> int: ...


@dataclasses.dataclass(frozen=True)
class PinnedHome:
    """Every page of every segment homes on one fixed port — the
    all-on-one-port baseline the sharding benchmarks compare against."""

    port: int = 0
    name: str = "pinned-home"

    def home_port(self, sid: int, page: int, pool_ports: int) -> int:
        if not 0 <= self.port < pool_ports:
            raise ValueError(
                f"pinned home port {self.port} outside 0..{pool_ports - 1}")
        return self.port


@dataclasses.dataclass(frozen=True)
class StripedHome:
    """Shard the directory round-robin: `stride` consecutive pages per port.

    The segment id offsets the stripe so independent segments don't all start
    hammering port 0 — the same page of two segments lands on different homes.
    """

    stride: int = 1
    name: str = "striped-home"

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"invalid stride {self.stride}; need >= 1")

    def home_port(self, sid: int, page: int, pool_ports: int) -> int:
        return (page // self.stride + sid) % pool_ports


@dataclasses.dataclass
class CongestionAwarePromotion:
    """Wrap a promotion policy with a live-occupancy gate on the owner's uplink.

    While `watch_link` (typically the owning host's fabric uplink) carries more than
    `max_occupancy` in-flight transfers, remote hits are served in place (Policy2
    behavior) instead of paying a promotion DMA on a contended link. On an idle
    fabric this is exactly `base`.

    Scope: the gate reads *instantaneous* occupancy, so it only engages while
    overlapping traffic is in flight (``Fabric.begin`` without drain — i.e. other
    hosts' concurrent bursts, as in ``EmuCXL.migrate_batch``). A single host
    issuing purely synchronous DMAs drains each one before the next decision and
    will always see its own link idle; that degenerate case is `base` by design.
    """

    base: PromotionPolicy = dataclasses.field(default_factory=Policy1)
    fabric: Optional[object] = None
    watch_link: Optional[str] = None
    max_occupancy: int = 0
    name: str = "congestion-aware-promotion"

    def bind(self, fabric, watch_link: Optional[str] = None) -> "CongestionAwarePromotion":
        self.fabric = fabric
        self.watch_link = watch_link
        return self

    def promote_on_hit(self, key: Hashable) -> bool:
        if self.fabric is None or self.fabric.idle():
            return self.base.promote_on_hit(key)
        occupancy = (
            self.fabric.link_occupancy(self.watch_link)
            if self.watch_link is not None
            else self.fabric.in_flight()
        )
        if occupancy > self.max_occupancy:
            return False
        return self.base.promote_on_hit(key)


@dataclasses.dataclass(frozen=True)
class WriteBackPolicy:
    """Demotion batching for dirty pages (beyond-paper: used by the KV-cache manager).

    batch_pages > 1 coalesces demotions into fewer, larger host DMAs — the TPU analogue
    of write-combining on the CXL link.
    """

    batch_pages: int = 1


def make_policy(name: str) -> PromotionPolicy:
    key = name.lower()
    if key in ("congestion", "congestion-aware", "congestion-aware-promotion"):
        # Unbound: callers attach the fabric + watch link via .bind().
        return CongestionAwarePromotion(base=Policy1())
    table = {
        "policy1": Policy1(),
        "policy1-optimistic": Policy1(),
        "policy2": Policy2(),
        "policy2-conservative": Policy2(),
    }
    if key not in table:
        options = [*sorted(table), "congestion-aware"]
        raise ValueError(f"unknown policy {name!r}; options: {options}")
    return table[key]
