"""Generation-counted buffer handles — the v2 answer to v1's raw `int` addresses.

The paper's Table II API (and our v1 facade) hands out integer virtual addresses.
Those are unsafe in exactly the ways C pointers are: a freed address can be passed
back in (use-after-free), freed twice (double free), or kept across a ``resize``
that invalidated it (stale pointer). v1 can only say "invalid address".

v2 never exposes addresses. ``CXLSession`` (core/api.py) returns ``Buffer`` handles:
an index into a per-session ``HandleTable`` slot plus the slot's *generation* at
issue time. Every dereference checks both; a mismatch or a retired slot raises
``StaleHandleError`` naming what actually happened (freed / resized / recycled)
instead of silently aliasing whatever lives at the reused slot now.

Two invalidation models coexist deliberately:
  * ``free`` and ``resize`` retire the slot — old handles fail loudly;
  * ``migrate`` *updates the slot's address in place* — handles survive tier and
    host moves, which is the main ergonomic win over v1 (no address re-threading).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.emucxl import EmuCXLError


class StaleHandleError(EmuCXLError):
    """A handle whose slot generation no longer matches: use-after-free, double
    free, use of a resized-away buffer, or a handle from a recycled slot."""

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason  # "freed" | "resized" | "recycled"


@dataclasses.dataclass
class _Slot:
    generation: int
    address: Optional[int] = None      # None once retired
    last_address: int = 0              # kept for error messages after retirement
    retired: Optional[str] = None      # None while live, else the retirement reason


class HandleTable:
    """Slot table mapping (index, generation) -> emucxl address.

    Freed slots go on a free list and are recycled with a bumped generation, so
    a handle minted before the recycle can never resolve to the new occupant.

    Tombstones (``_history``) are kept per retired generation forever — O(total
    retires) memory, a deliberate trade: the emulator favors precise
    use-after-free diagnostics over reclaiming a few dozen bytes per free.
    """

    def __init__(self):
        self._slots: List[_Slot] = []
        self._free: List[int] = []
        # (index, generation) -> (reason, last address): tombstones survive slot
        # recycling so a very old handle still gets the precise diagnosis.
        self._history: dict = {}

    def __len__(self) -> int:
        return sum(1 for s in self._slots if s.retired is None)

    def insert(self, address: int) -> Tuple[int, int]:
        """Register a live address; returns the (slot index, generation) pair."""
        if self._free:
            index = self._free.pop()
            slot = self._slots[index]
            slot.generation += 1
            slot.address = address
            slot.last_address = address
            slot.retired = None
        else:
            index = len(self._slots)
            self._slots.append(_Slot(generation=0, address=address,
                                     last_address=address))
        return index, self._slots[index].generation

    def _raise_stale(self, index: int, generation: int, action: str,
                     reason: str, last_address: int) -> None:
        kind = f"stale handle ({reason}):"
        if reason == "freed":
            kind = "double free of" if action == "free" else "use-after-free:"
        raise StaleHandleError(
            f"{kind} buffer handle {index}:{generation} "
            f"(last address {last_address:#x}) was {reason}", reason,
        )

    def _checked(self, index: int, generation: int, action: str) -> _Slot:
        if not 0 <= index < len(self._slots):
            raise StaleHandleError(
                f"invalid buffer handle {index}:{generation} (never issued by this "
                f"session)", "recycled",
            )
        slot = self._slots[index]
        if slot.generation != generation:
            tomb = self._history.get((index, generation))
            if tomb is not None:
                self._raise_stale(index, generation, action, *tomb)
            raise StaleHandleError(
                f"stale buffer handle {index}:{generation}: its slot was recycled "
                f"(now generation {slot.generation}) — the original buffer at "
                f"{slot.last_address:#x} no longer exists", "recycled",
            )
        if slot.retired is not None:
            self._raise_stale(index, generation, action, slot.retired,
                              slot.last_address)
        return slot

    def resolve(self, index: int, generation: int) -> int:
        """Current address behind a handle; raises StaleHandleError otherwise."""
        return self._checked(index, generation, "use").address

    def update_address(self, index: int, generation: int, address: int) -> None:
        """Re-point a live handle after a migrate (handle identity is preserved)."""
        slot = self._checked(index, generation, "use")
        slot.address = address
        slot.last_address = address

    def retire(self, index: int, generation: int, reason: str) -> int:
        """Invalidate a handle (free/resize); returns the address it held.

        Retiring an already-retired handle raises — this is the double-free check.
        """
        slot = self._checked(index, generation, "free" if reason == "freed" else "use")
        address = slot.address
        slot.address = None
        slot.retired = reason
        self._history[(index, generation)] = (reason, slot.last_address)
        self._free.append(index)
        return address


class Buffer:
    """A typed, generation-counted v2 handle to one emucxl allocation.

    All data-movement methods delegate to the owning session's ``EmuCXL`` after a
    handle-validity check, so modeled-time and fabric accounting are identical to
    the v1 calls they replace. ``migrate``/``resize`` return a Buffer for chaining:
    ``migrate`` returns *the same* handle (it survives the move), ``resize``
    returns a fresh one and retires this one.
    """

    __slots__ = ("_session", "_index", "_generation")

    def __init__(self, session, index: int, generation: int):
        self._session = session
        self._index = index
        self._generation = generation

    # -------------------------------------------------------------- plumbing
    @property
    def session(self):
        return self._session

    @property
    def handle(self) -> Tuple[int, int]:
        return self._index, self._generation

    @property
    def address(self) -> int:
        """The current backing address (for introspection/interop — may change
        across ``migrate``; do not store it, store the Buffer)."""
        return self._resolve()

    def _resolve(self) -> int:
        # A closed session's handles are dead even when the session merely
        # wrapped a longer-lived EmuCXL (close() frees nothing it doesn't own,
        # but the session contract still ends here). Resolution takes the lib's
        # RLock so table reads never race a concurrent retire/recycle.
        with self._session.lib._lock:
            self._session._check_open()
            return self._session._table.resolve(self._index, self._generation)

    def _lib(self):
        return self._session.lib

    @property
    def valid(self) -> bool:
        try:
            self._resolve()
            return True
        except EmuCXLError:
            return False

    # -------------------------------------------------------------- metadata
    @property
    def size(self) -> int:
        return self._lib().get_size(self._resolve())

    @property
    def node(self) -> int:
        return self._lib().get_numa_node(self._resolve())

    @property
    def host(self) -> int:
        return self._lib().get_host(self._resolve())

    @property
    def is_local(self) -> bool:
        return self._lib().is_local(self._resolve())

    @property
    def segment(self):
        """The coherent SharedSegment this buffer maps (None if private)."""
        return self._lib().get_segment(self._resolve())

    @property
    def is_shared(self) -> bool:
        return self.segment is not None

    # -------------------------------------------------------------- data plane
    def read(self, offset: int = 0, size: Optional[int] = None) -> np.ndarray:
        n = self.size - offset if size is None else size
        return self._lib().read(self._resolve(), offset, n)

    def write(self, data, offset: int = 0, size: Optional[int] = None) -> "Buffer":
        self._lib().write(data, offset, self._resolve(), size)
        return self

    def memset(self, value: int, size: Optional[int] = None) -> "Buffer":
        n = self.size if size is None else size
        self._lib().memset(self._resolve(), value, n)
        return self

    def view(self, shape, dtype) -> np.ndarray:
        """Read the buffer (prefix) as a typed array of the given shape."""
        return self._lib().read_array(self._resolve(), shape, dtype)

    def write_array(self, array) -> "Buffer":
        self._lib().write_array(array, self._resolve())
        return self

    # -------------------------------------------------------------- lifecycle
    def migrate(self, node: int, host: Optional[int] = None) -> "Buffer":
        """Move to (node, host). The handle stays valid — only the backing
        address changes, which the table absorbs. The move and the table
        update are one critical section: a concurrent reader must never
        resolve the freed old address."""
        with self._session.lib._lock:
            new_addr = self._lib().migrate(self._resolve(), node, host)
            self._session._table.update_address(self._index, self._generation,
                                                new_addr)
        return self

    def resize(self, size: int) -> "Buffer":
        """realloc-style: returns a NEW handle; this handle becomes stale."""
        return self._session.resize(self, size)

    def free(self) -> None:
        self._session.free(self)

    def detach(self) -> None:
        """Unmap a shared-segment attachment (see ``CXLSession.detach``)."""
        self._session.detach(self)

    def fence(self) -> float:
        """Release fence on this attachment's segment for this host (see
        ``CXLSession.fence``); returns the modeled fence time."""
        return self._session.fence(self)

    def acquire(self) -> float:
        """Acquire fence on this attachment's segment for this host (see
        ``CXLSession.acquire``); returns the modeled wait (0.0 sync)."""
        return self._session.acquire(self)

    def __repr__(self) -> str:
        try:
            return (f"Buffer(handle={self._index}:{self._generation}, "
                    f"addr={self._resolve():#x}, size={self.size}, "
                    f"node={self.node}, host={self.host})")
        except EmuCXLError as e:
            return f"Buffer(handle={self._index}:{self._generation}, stale: {e})"
