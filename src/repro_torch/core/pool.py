"""Tier-pool accounting — the bookkeeping layer middleware and the backend build on.

The paper's middleware (KV store, slab allocator) tracks which objects sit in the bounded
local tier and which have been demoted to the large remote tier. ``LRUTier`` is that
bookkeeping, factored out so both the paper-faithful KV store and the serving-time paged
KV-cache manager share one implementation. ``SharedPool`` extends the remote tier to the
CXL-3.0 pooled picture: one capacity shared by N hosts, each charged against an optional
per-host quota (the fabric-manager partitioning CXL-ClusterSim models at cluster scale).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, Iterable, List, Optional, Tuple


class PoolCapacityError(RuntimeError):
    """The shared pool itself is out of bytes (translated to OutOfTierMemory)."""

    def __init__(self, requested: int, free: int):
        super().__init__(f"shared pool cannot serve {requested} bytes ({free} free)")
        self.requested, self.free = requested, free


class PoolQuotaError(RuntimeError):
    """A host hit its partition quota while the pool still had free bytes."""

    def __init__(self, host: int, requested: int, quota: int, used: int):
        super().__init__(
            f"host {host} quota exceeded: {requested} bytes requested, "
            f"{used}/{quota} already charged"
        )
        self.host, self.requested, self.quota, self.used = host, requested, quota, used


class SharedPool:
    """Byte accounting for one memory pool shared by `num_hosts` emulated hosts.

    `host_quota` is either None (no partitioning — any host may fill the pool),
    one int applied uniformly, or a {host: bytes} mapping. Quotas partition the
    *right to allocate*, not the bytes themselves: the sum of quotas may exceed
    capacity (over-subscription, the usual fabric-manager setup).
    """

    def __init__(self, capacity: int, num_hosts: int = 1, host_quota=None):
        if capacity < 0 or num_hosts < 1:
            raise ValueError("capacity must be >= 0 and num_hosts >= 1")
        self.capacity = capacity
        self.num_hosts = num_hosts
        if host_quota is None:
            self._quota: Optional[Dict[int, int]] = None
        elif isinstance(host_quota, dict):
            self._quota = {int(h): int(q) for h, q in host_quota.items()}
        else:
            self._quota = {h: int(host_quota) for h in range(num_hosts)}
        self.used = 0
        self.used_by_host: Dict[int, int] = {h: 0 for h in range(num_hosts)}

    def quota(self, host: int) -> Optional[int]:
        if self._quota is None:
            return None
        return self._quota.get(host, 0)

    @property
    def free(self) -> int:
        return self.capacity - self.used

    def host_free(self, host: int) -> int:
        """Bytes this host may still allocate (min of pool free and quota headroom)."""
        q = self.quota(host)
        if q is None:
            return self.free
        return min(self.free, q - self.used_by_host[host])

    def charge(self, host: int, nbytes: int) -> None:
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"invalid host {host} (pool has {self.num_hosts})")
        if nbytes < 0:
            raise ValueError("nbytes must be >= 0")
        q = self.quota(host)
        if q is not None and self.used_by_host[host] + nbytes > q:
            raise PoolQuotaError(host, nbytes, q, self.used_by_host[host])
        if self.used + nbytes > self.capacity:
            raise PoolCapacityError(nbytes, self.free)
        self.used += nbytes
        self.used_by_host[host] += nbytes

    def release(self, host: int, nbytes: int) -> None:
        self.used -= nbytes
        self.used_by_host[host] -= nbytes

    def reset(self) -> None:
        self.used = 0
        self.used_by_host = {h: 0 for h in range(self.num_hosts)}

    def stats(self) -> Dict[str, object]:
        """Partition view: total + per-host usage/quota/headroom — the payload
        behind ``emucxl_pool_stats`` and ``CXLSession.pool_stats``."""
        return {
            "capacity": self.capacity,
            "used": self.used,
            "free": self.free,
            "per_host": {
                h: {
                    "used": self.used_by_host[h],
                    "quota": self.quota(h),
                    "headroom": self.host_free(h),
                }
                for h in range(self.num_hosts)
            },
        }


class LRUTier:
    """A bounded tier holding (key -> cost) with least-recently-used eviction.

    `capacity` is in arbitrary cost units (object count if every add uses cost=1,
    bytes if costs are sizes) — the paper's KV store bounds object *count*, the paged
    KV manager bounds *bytes*.
    """

    def __init__(self, capacity: float, name: str = "tier"):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self.name = name
        self._items: "OrderedDict[Hashable, float]" = OrderedDict()
        self._used = 0.0

    def __contains__(self, key: Hashable) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)

    @property
    def used(self) -> float:
        return self._used

    @property
    def free(self) -> float:
        return self.capacity - self._used

    def keys(self) -> Iterable[Hashable]:
        return self._items.keys()

    def touch(self, key: Hashable) -> None:
        """Mark `key` most-recently-used."""
        self._items.move_to_end(key)

    def add(self, key: Hashable, cost: float = 1.0) -> List[Hashable]:
        """Insert `key`; returns the LRU keys evicted to make room (possibly empty).

        The caller owns acting on evictions (e.g. migrating the objects to the remote
        tier) — this class only decides *what* leaves.
        """
        if key in self._items:
            raise KeyError(f"{key!r} already in {self.name}")
        if cost > self.capacity:
            raise ValueError(f"cost {cost} exceeds tier capacity {self.capacity}")
        evicted: List[Hashable] = []
        while self._used + cost > self.capacity:
            old_key, old_cost = self._items.popitem(last=False)
            self._used -= old_cost
            evicted.append(old_key)
        self._items[key] = cost
        self._used += cost
        return evicted

    def remove(self, key: Hashable) -> float:
        cost = self._items.pop(key)
        self._used -= cost
        return cost

    def lru_key(self) -> Optional[Hashable]:
        return next(iter(self._items), None)

    def as_ordered(self) -> List[Tuple[Hashable, float]]:
        return list(self._items.items())
