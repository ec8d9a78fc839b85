"""Slab-allocator middleware over emucxl (paper §IV-B "future work" — implemented here).

A slab is one emucxl allocation (page-aligned, virtually contiguous) carved into
equal-sized chunks with a free list and a refcount — constant-time alloc/free, minimal
internal fragmentation, easy whole-slab reclamation, exactly the Bonwick design the
paper sketches. Slabs live on either tier and can be migrated wholesale, which is what
makes this the natural backing store for paged KV caches (serving/kv_manager.py): one
KV page == one chunk, hot slabs in HBM, cold slabs demoted to host memory.

v2: each slab's backing storage is a generation-counted ``Buffer`` handle from a
``CXLSession`` (core/api.py) rather than a raw address — ``migrate_slab`` no longer
re-threads addresses (the handle survives the move), and a reclaimed slab's storage
cannot be silently aliased. Constructors still accept a bare ``EmuCXL`` (or None for
the process default) for v1 interop; it is wrapped in a session transparently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import emucxl as ecxl
from repro_torch.core.api import CXLSession, as_session
from repro_torch.core.handle import Buffer

PAGE_BYTES = 4096


@dataclasses.dataclass
class SlabPtr:
    """An opaque pointer into slab storage: (slab id, chunk index)."""

    slab_id: int
    chunk: int
    size_class: int


@dataclasses.dataclass
class _Slab:
    slab_id: int
    buf: Buffer                  # session handle to the backing allocation
    node: int
    chunk_size: int
    chunks: int
    free_list: List[int]
    refcount: int = 0            # allocated chunks

    @property
    def full(self) -> bool:
        return not self.free_list

    @property
    def empty(self) -> bool:
        return self.refcount == 0


class SlabAllocator:
    """Size-class slab allocation over two memory tiers.

    size classes are powers of two from `min_chunk` to `max_chunk`; each slab holds
    `slab_pages` pages. alloc/free are O(1); tier migration moves whole slabs.
    """

    def __init__(
        self,
        lib=None,
        min_chunk: int = 64,
        max_chunk: int = 64 * 1024,
        slab_pages: int = 16,
        host: int = 0,
    ):
        if min_chunk & (min_chunk - 1) or max_chunk & (max_chunk - 1):
            raise ValueError("chunk bounds must be powers of two")
        self.session: CXLSession = as_session(lib)
        self.host = host  # emulated host charged for this allocator's slabs
        self.min_chunk, self.max_chunk = min_chunk, max_chunk
        self.slab_bytes = slab_pages * PAGE_BYTES
        self._slabs: Dict[int, _Slab] = {}
        self._next_id = 0
        # per (size_class, node): slab ids with free chunks
        self._partial: Dict[Tuple[int, int], List[int]] = {}

    @property
    def lib(self) -> ecxl.EmuCXL:
        """v1 interop: the modeled library under this allocator's session."""
        return self.session.lib

    @lib.setter
    def lib(self, value) -> None:
        if self._slabs:
            raise ecxl.EmuCXLError(
                f"cannot rebind SlabAllocator to a new backend with "
                f"{len(self._slabs)} live slab(s) on the old one"
            )
        self.session = as_session(value)

    # ------------------------------------------------------------------ size classes
    def size_class(self, size: int) -> int:
        if size <= 0 or size > self.max_chunk:
            raise ValueError(f"size {size} outside slab range (..{self.max_chunk}]")
        c = self.min_chunk
        while c < size:
            c <<= 1
        return c

    # ------------------------------------------------------------------ alloc / free
    def alloc(self, size: int, node: int) -> SlabPtr:
        cls = self.size_class(size)
        bucket = self._partial.setdefault((cls, node), [])
        while bucket and self._slabs[bucket[-1]].full:
            bucket.pop()
        if not bucket:
            bucket.append(self._grow(cls, node))
        slab = self._slabs[bucket[-1]]
        chunk = slab.free_list.pop()
        slab.refcount += 1
        if slab.full:
            bucket.pop()
        return SlabPtr(slab.slab_id, chunk, cls)

    def free(self, ptr: SlabPtr) -> None:
        slab = self._slabs.get(ptr.slab_id)
        if slab is None:
            raise ecxl.EmuCXLError(
                f"free on reclaimed/unknown slab {ptr.slab_id} (double free?)"
            )
        if ptr.chunk in slab.free_list:
            raise ecxl.EmuCXLError(f"double free of chunk {ptr.chunk} in slab {ptr.slab_id}")
        was_full = slab.full
        slab.free_list.append(ptr.chunk)
        slab.refcount -= 1
        if was_full:
            self._partial.setdefault((slab.chunk_size, slab.node), []).append(slab.slab_id)
        if slab.empty:
            self._reclaim(slab)

    def _grow(self, cls: int, node: int) -> int:
        chunks = max(self.slab_bytes // cls, 1)
        buf = self.session.alloc(chunks * cls, node, self.host)
        sid = self._next_id
        self._next_id += 1
        self._slabs[sid] = _Slab(
            slab_id=sid, buf=buf, node=node, chunk_size=cls, chunks=chunks,
            free_list=list(range(chunks - 1, -1, -1)),
        )
        return sid

    def _reclaim(self, slab: _Slab) -> None:
        """Empty slabs return their pages to the tier (easy reclamation property)."""
        slab.buf.free()
        bucket = self._partial.get((slab.chunk_size, slab.node), [])
        if slab.slab_id in bucket:
            bucket.remove(slab.slab_id)
        del self._slabs[slab.slab_id]

    # ------------------------------------------------------------------ data access
    def write(self, ptr: SlabPtr, payload) -> None:
        if len(payload) > ptr.size_class:
            raise ecxl.EmuCXLError("payload exceeds chunk size class")
        slab = self._slabs[ptr.slab_id]
        slab.buf.write(payload, ptr.chunk * slab.chunk_size, len(payload))

    def read(self, ptr: SlabPtr, size: int):
        slab = self._slabs[ptr.slab_id]
        if size > slab.chunk_size:
            raise ecxl.EmuCXLError("read exceeds chunk size class")
        return slab.buf.read(ptr.chunk * slab.chunk_size, size)

    # ------------------------------------------------------------------ tier moves
    def migrate_slab(self, slab_id: int, node: int) -> None:
        """Whole-slab tier migration (one large DMA instead of per-object copies).

        The Buffer handle survives the move — no address re-threading."""
        slab = self._slabs[slab_id]
        if slab.node == node:
            return
        old_key = (slab.chunk_size, slab.node)
        slab.buf.migrate(node)
        if slab.slab_id in self._partial.get(old_key, []):
            self._partial[old_key].remove(slab.slab_id)
            self._partial.setdefault((slab.chunk_size, node), []).append(slab.slab_id)
        slab.node = node

    def node_of(self, ptr: SlabPtr) -> int:
        return self._slabs[ptr.slab_id].node

    # ------------------------------------------------------------------ stats
    def fragmentation(self, node: int) -> float:
        """Internal fragmentation: 1 - (live chunk bytes / slab bytes) on `node`."""
        total = live = 0
        for s in self._slabs.values():
            if s.node != node:
                continue
            total += s.chunks * s.chunk_size
            live += s.refcount * s.chunk_size
        return 1.0 - live / total if total else 0.0

    def slab_count(self, node: Optional[int] = None) -> int:
        if node is None:
            return len(self._slabs)
        return sum(1 for s in self._slabs.values() if s.node == node)
