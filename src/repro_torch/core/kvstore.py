"""Key-value store middleware over the emucxl API (paper §IV-B, Listings 2-4).

Semantics follow the paper exactly:
  * PUT inserts the object in the *local* tier at the MRU position; if the local tier
    exceeds its bound, the LRU object is migrated to the remote tier (assumed large).
  * GET searches local, then remote. A remote hit is handled by the configured policy —
    Policy1 promotes (optimistic caching), Policy2 leaves it remote.
  * DELETE frees the object from whichever tier holds it.

Objects are real emucxl allocations (bytes in the device or host memory space), not
Python dict entries — every migration is an actual cross-memory-space DMA.

v2: objects are held as generation-counted ``Buffer`` handles from a ``CXLSession``,
so tier moves need no address re-threading (the handle survives ``migrate``) and a
deleted object's storage cannot be silently aliased. The promotion policy defaults
to the session's injected ``promotion`` policy; constructors still accept a bare
``EmuCXL`` (or None for the process default) for v1 interop.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core import emucxl as ecxl
from repro_torch.core.api import CXLSession, as_session
from repro_torch.core.handle import Buffer
from repro_torch.core.policy import AccessStats, PromotionPolicy
from repro_torch.core.pool import LRUTier


class KVStore:
    def __init__(
        self,
        lib=None,
        local_capacity_objects: int = 300,
        policy: Optional[PromotionPolicy] = None,
    ):
        self.session: CXLSession = as_session(lib)
        self.local = LRUTier(local_capacity_objects, name="kv-local")
        self.policy = policy if policy is not None else self.session.promotion
        self.stats = AccessStats()
        self._buf: Dict[str, Buffer] = {}   # key -> session buffer handle
        self._size: Dict[str, int] = {}     # key -> payload bytes

    @property
    def lib(self) -> ecxl.EmuCXL:
        return self.session.lib

    # ------------------------------------------------------------------ operations
    def put(self, key: str, value: bytes) -> None:
        """Paper Listing 2: allocate local, MRU-insert, LRU-demote on overflow."""
        if key in self._buf:
            self.delete(key)
        buf = self.session.alloc(max(len(value), 1), ecxl.LOCAL_MEMORY)
        buf.write(np.frombuffer(value, np.uint8))
        self._buf[key] = buf
        self._size[key] = len(value)
        for victim in self.local.add(key):
            self._demote(victim)

    def get(self, key: str) -> Optional[bytes]:
        """Paper Listing 3: local search, remote search, policy on remote hit."""
        buf = self._buf.get(key)
        if buf is None:
            self.stats.misses += 1
            return None
        if buf.is_local:
            self.stats.local_hits += 1
            self.local.touch(key)
        else:
            self.stats.remote_hits += 1
            if self.policy.promote_on_hit(key):
                self._promote(key)
        return self._read(key)

    def delete(self, key: str) -> bool:
        """Paper Listing 4."""
        buf = self._buf.get(key)
        if buf is None:
            return False
        if buf.is_local:
            self.local.remove(key)
        buf.free()
        del self._buf[key], self._size[key]
        return True

    # ------------------------------------------------------------------ tier moves
    def _demote(self, key: str) -> None:
        self._buf[key].migrate(ecxl.REMOTE_MEMORY)

    def _promote(self, key: str) -> None:
        self._buf[key].migrate(ecxl.LOCAL_MEMORY)
        for victim in self.local.add(key):
            self._demote(victim)

    def _read(self, key: str) -> bytes:
        return self._buf[key].read(0, self._size[key]).tobytes()

    # ------------------------------------------------------------------ introspection
    def tier_of(self, key: str) -> Optional[int]:
        buf = self._buf.get(key)
        return None if buf is None else buf.node

    def local_count(self) -> int:
        return len(self.local)

    def remote_count(self) -> int:
        return sum(1 for b in self._buf.values() if not b.is_local)

    def __len__(self) -> int:
        return len(self._buf)
