"""Two-tier paged KV-cache manager — the paper's middleware, productionized.

Mapping from the paper (§IV-B) to serving:
  * object        -> a KV page (page_size tokens x K heads x head_dim x 2 (k,v))
  * local tier    -> slots in the HBM-resident page pool (what paged_attention reads)
  * remote tier   -> page-sized chunks handed out by the slab allocator (core/slab.py)
                     over emucxl REMOTE memory — real cross-memory-space DMAs
  * PUT           -> page allocation during prefill/decode (hot, MRU)
  * LRU demotion  -> sequence preemption / cold prefixes swap to the remote tier
  * GET+Policy1   -> swap-in promotes pages back to HBM (optimistic reuse)
  * GET+Policy2   -> read-through for one-shot access (conservative)

Hit statistics reproduce the paper's Table IV "% local" accounting on real serving
traffic (benchmarks/policy_table.py runs the paper's original object workload; the
engine runs this one).

The port of ``repro/serving/kv_manager.py``: the hot pools are torch tensors on
the pool's device (the card by default) and are updated in place; a page
crosses to the cold tier as bytes, one contiguous device->host copy per page.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import emucxl as ecxl
from repro_torch.core.api import CXLSession, as_session
from repro_torch.core.policy import (
    AccessStats,
    CongestionAwarePromotion,
    PromotionPolicy,
)
from repro_torch.core.pool import LRUTier
from repro_torch.core.slab import SlabAllocator, SlabPtr
from repro_torch.device import resolve_device


def _page_payload(k_pool: torch.Tensor, v_pool: torch.Tensor, slot: int) -> np.ndarray:
    """One page's bytes, K then V, each in (L, page, K, hd) order: stacked into
    one contiguous tensor on the pool's device, then one copy to the host."""
    kv = torch.stack([k_pool[:, slot], v_pool[:, slot]])
    return kv.view(torch.uint8).reshape(-1).cpu().numpy()


def _load_page(k_pool: torch.Tensor, v_pool: torch.Tensor, slot: int,
               raw: np.ndarray) -> None:
    """Inverse of ``_page_payload``: write a page's bytes into hot `slot`."""
    kv = torch.from_numpy(np.ascontiguousarray(raw)).to(k_pool.device)
    kv = kv.view(k_pool.dtype).view(2, *k_pool[:, slot].shape)
    k_pool[:, slot].copy_(kv[0])
    v_pool[:, slot].copy_(kv[1])


class SharedPrefixKV:
    """One coherent segment holding the paged KV of a common prompt prefix.

    The serving scenario CXL coherence unlocks: N hosts serve prompts that
    share a long common prefix (system prompt, few-shot header). Without
    sharing, every host keeps its own cold copy of the prefix KV — N copies in
    the pool. With this class, ONE host publishes the prefix pages into a
    ``SharedSegment`` and every host imports them through its own coherent
    mapping: the pool holds one copy, imports are directory read-misses (page
    fetches that contend on the fabric), repeat imports are cache hits, and a
    prefix *update* back-invalidates every host that imported it —
    benchmarks/coherence_bench.py measures all three effects.

    Coherence granularity is one KV page (all layers' K and V for `page_size`
    tokens), so invalidations track exactly the pages an update touches.

    The segment uses release consistency by default: ``publish`` writes every
    prefix page into the host's write-combining buffer and emits the whole
    upgrade — RFO fetches, and on re-publish the back-invalidations to every
    importer — under ONE fence, so the fabric sees one overlapped protocol
    burst instead of a per-page invalidation storm. Pass
    ``consistency="eager"`` to publish page-at-a-time (the pre-fence model).
    """

    def __init__(self, session: CXLSession, num_layers: int, num_pages: int,
                 page_size: int, kv_heads: int, head_dim: int,
                 dtype=torch.float32, home_host: int = 0,
                 consistency: str = "release", home=None):
        self.L, self.page, self.K, self.hd = num_layers, page_size, kv_heads, head_dim
        self.dtype = dtype
        self.num_pages = num_pages
        self.page_bytes = int(2 * num_layers * page_size * kv_heads * head_dim
                              * dtype.itemsize)
        self.prefix_tokens = num_pages * page_size
        self.session = session
        self.home_host = home_host
        # `home` (a DirectoryHomePolicy, e.g. StripedHome) shards the prefix
        # directory across pool ports, so a wide prefix's import/invalidation
        # traffic isn't all charged down one port's uplink.
        self.segment = session.share(
            num_pages * self.page_bytes, host=home_host,
            page_bytes=self.page_bytes, writers=[home_host],
            consistency=consistency, home=home,
        )
        self._maps: Dict[int, object] = {}     # host -> attachment Buffer
        self.token_ids: Optional[List[int]] = None   # set by publish()
        self.publishes = 0
        self.updates = 0

    def matches(self, prompt) -> bool:
        """Whether `prompt` starts with the *published* prefix: the segment
        must have been published, and the leading tokens must equal the
        publisher's token ids (importing KV for different tokens would attend
        to the wrong content — silently wrong logits)."""
        if self.publishes == 0 or len(prompt) < self.prefix_tokens:
            return False
        if self.token_ids is None:
            return True                # publisher vouched without token ids
        return list(prompt[: self.prefix_tokens]) == self.token_ids

    def _geometry(self) -> Tuple[int, int, int, int]:
        return self.L, self.page, self.K, self.hd

    def attach(self, host: int):
        """This host's coherent mapping of the prefix (created on first use)."""
        if host not in self._maps:
            self._maps[host] = self.session.attach(self.segment, host)
        return self._maps[host]

    def publish(self, pool: "PagedKVPool", seq_id: int,
                token_ids=None) -> None:
        """Write the prefix pages from `pool`'s hot slots into the segment
        (coherent writes by the publishing host — the single pooled copy).
        `token_ids` (the prefix's tokens) lets ``matches`` verify prompts
        against the published content before importing."""
        if token_ids is not None and len(token_ids) != self.prefix_tokens:
            raise ecxl.EmuCXLError(
                f"prefix covers {self.prefix_tokens} tokens, publisher supplied "
                f"{len(token_ids)} token ids"
            )
        buf = self.attach(pool.host)
        for p in range(self.num_pages):
            ref = pool._ref(seq_id, p)
            if ref.hot_slot is None:
                raise ecxl.EmuCXLError(
                    f"prefix page {p} of seq {seq_id} is not hot; promote before "
                    f"publishing"
                )
            buf.write(_page_payload(pool.k_pool, pool.v_pool, ref.hot_slot),
                      offset=p * self.page_bytes)
        # One release fence publishes every page: the upgrades (and, on a
        # re-publish, the back-invalidations to all importers) overlap in a
        # single fabric burst. No-op for an eager segment.
        buf.fence()
        if token_ids is not None:
            self.token_ids = [int(t) for t in token_ids]
        self.publishes += 1

    def update(self, payload: np.ndarray, page_idx: int,
               host: Optional[int] = None) -> None:
        """Rewrite one prefix page (e.g. a refreshed system prompt): a coherent
        write that back-invalidates every host caching the page."""
        host = self.home_host if host is None else host
        flat = np.asarray(payload, np.uint8).reshape(-1)
        if flat.size != self.page_bytes:
            raise ecxl.EmuCXLError(
                f"prefix page update must supply {self.page_bytes} bytes, got "
                f"{flat.size}"
            )
        buf = self.attach(host)
        buf.write(flat, offset=page_idx * self.page_bytes)
        buf.fence()     # publish: back-invalidates every host caching the page
        self.updates += 1

    def read_page(self, host: int, page_idx: int) -> np.ndarray:
        """Coherent read of one prefix page through `host`'s mapping.

        The acquire pairs with the publisher's release fence — the
        happens-before edge that entitles this host to the published bytes
        (free at runtime; without it the race detector rightly flags the
        read as unsynchronized)."""
        buf = self.attach(host)
        buf.acquire()
        return buf.read(page_idx * self.page_bytes, self.page_bytes)

    def close(self) -> None:
        """Detach every mapping and release the pooled backing."""
        for buf in self._maps.values():
            buf.detach()
        self._maps.clear()
        self.session.destroy(self.segment)


@dataclasses.dataclass
class PageRef:
    """Where one logical page currently lives."""

    seq_id: int
    layer_page: int          # flat (layer, page_index) id within the sequence
    hot_slot: Optional[int] = None
    cold_ptr: Optional[SlabPtr] = None

    @property
    def is_local(self) -> bool:
        return self.hot_slot is not None


class _SeqPages:
    """One sequence's held pages: their ``PageRef``s by page index, and its
    block-table row, the hot slot at each page index (0: cold or not held)."""

    __slots__ = ("refs", "slots")

    def __init__(self):
        self.refs: Dict[int, PageRef] = {}
        self.slots = np.zeros((16,), np.int32)

    def place(self, page_idx: int, slot: int) -> None:
        if page_idx >= len(self.slots):
            grown = np.zeros((max(2 * len(self.slots), page_idx + 1),), np.int32)
            grown[: len(self.slots)] = self.slots
            self.slots = grown
        self.slots[page_idx] = slot


class PagedKVPool:
    """Hot (HBM) page pool + cold (emucxl remote) spill, with promotion policies."""

    _NO_PAGES = _SeqPages()      # what a sequence that holds no page reads; never written

    def __init__(
        self,
        num_layers: int,
        num_slots: int,
        page_size: int,
        kv_heads: int,
        head_dim: int,
        dtype=torch.float32,
        lib: Optional[ecxl.EmuCXL] = None,
        policy: Optional[PromotionPolicy] = None,
        host: int = 0,
        session: Optional[CXLSession] = None,
        device="cuda",
    ):
        self.L, self.page, self.K, self.hd = num_layers, page_size, kv_heads, head_dim
        self.num_slots = num_slots
        self.dtype = dtype
        # hot pool: (L, slots, page, K, hd) x {k, v}, on the card by default
        self.device = resolve_device(device)
        shape = (num_layers, num_slots, page_size, kv_heads, head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        # v2: the cold tier is a session; `lib` (an EmuCXL or None) is the v1
        # interop spelling and gets wrapped.
        self.session = as_session(session if session is not None else lib)
        # Multi-host pooling: this engine's cold pages live in the shared pool,
        # charged to `host`'s quota, and their DMAs ride `host`'s fabric uplink.
        self.host = host
        self.slab = SlabAllocator(self.session, min_chunk=64,
                                  max_chunk=self._page_bytes_pow2(), slab_pages=16,
                                  host=host)
        # Promotion policy is injected — explicitly, or from the session default.
        if policy is None:
            policy = self.session.promotion
            if isinstance(policy, CongestionAwarePromotion):
                # The session default is shared; bind() mutates, and each pool
                # must watch its OWN host uplink — so bind a per-pool copy.
                policy = dataclasses.replace(policy, fabric=None, watch_link=None)
        if (isinstance(policy, CongestionAwarePromotion)
                and policy.fabric is None and self.session.fabric is not None):
            policy.bind(self.session.fabric, self.session.fabric.host_link(host))
        self.policy = policy
        self.stats = AccessStats()
        self.lru = LRUTier(float(num_slots), name="kv-hot")
        # Every held page, by sequence, and only sequences that hold one: a
        # table, a residency or a sequence's release reads its own pages.
        self._seqs: Dict[int, _SeqPages] = {}
        self.shared_prefix: Optional[SharedPrefixKV] = None
        self.prefix_imports = 0

    @property
    def lib(self) -> ecxl.EmuCXL:
        """v1 interop: the modeled library under this pool's session."""
        return self.session.lib

    @lib.setter
    def lib(self, value) -> None:
        if self._seqs:
            raise ecxl.EmuCXLError(
                f"cannot rebind PagedKVPool to a new backend with "
                f"{sum(len(s.refs) for s in self._seqs.values())} live page(s) on the old one"
            )
        self.slab.lib = value       # raises first if the slab holds live storage
        self.session = self.slab.session

    # ------------------------------------------------------------------ sizes
    def _page_bytes(self) -> int:
        return int(2 * self.L * self.page * self.K * self.hd
                   * self.dtype.itemsize)

    def _page_bytes_pow2(self) -> int:
        b = self._page_bytes()
        c = 64
        while c < b:
            c <<= 1
        return c

    def free_slots(self) -> int:
        return len(self._free)

    def _ref(self, seq_id: int, page_idx: int) -> PageRef:
        """The held page (seq, page_idx); KeyError((seq, page_idx)) if none."""
        ref = self._seqs.get(seq_id, self._NO_PAGES).refs.get(page_idx)
        if ref is None:
            raise KeyError((seq_id, page_idx))
        return ref

    # ------------------------------------------------------------------ alloc
    def alloc_page(self, seq_id: int, page_idx: int) -> int:
        """Allocate one hot page (all layers) for (seq, page_idx). PUT semantics."""
        key = (seq_id, page_idx)
        seq = self._seqs.get(seq_id, self._NO_PAGES)
        if page_idx in seq.refs:
            raise ecxl.EmuCXLError(f"page {key} already allocated")
        if page_idx < 0:
            raise ecxl.EmuCXLError(f"page {key}: a page index is at least 0")
        if not self._free:
            raise ecxl.OutOfTierMemory(0, self._page_bytes(), 0)
        slot = self._free.pop()
        if seq is self._NO_PAGES:
            seq = self._seqs[seq_id] = _SeqPages()
        seq.refs[page_idx] = PageRef(seq_id, page_idx, hot_slot=slot)
        seq.place(page_idx, slot)
        self.lru.add(key)
        return slot

    def free_page(self, seq_id: int, page_idx: int) -> None:
        ref = self._ref(seq_id, page_idx)
        seq = self._seqs[seq_id]
        del seq.refs[page_idx]
        if seq.refs:
            seq.slots[page_idx] = 0
        else:
            del self._seqs[seq_id]
        if ref.hot_slot is not None:
            self._free.append(ref.hot_slot)
            self.lru.remove((seq_id, page_idx))
        if ref.cold_ptr is not None:
            self.slab.free(ref.cold_ptr)

    def free_sequence(self, seq_id: int) -> None:
        for page_idx in list(self._seqs.get(seq_id, self._NO_PAGES).refs):
            self.free_page(seq_id, page_idx)

    # ------------------------------------------------------------------ shared prefix
    def attach_shared_prefix(self, shared: SharedPrefixKV) -> None:
        """Bind this pool (= this host's engine) to a common-prefix segment."""
        if shared._geometry() != (self.L, self.page, self.K, self.hd):
            raise ecxl.EmuCXLError(
                f"shared prefix geometry {shared._geometry()} does not match "
                f"pool geometry {(self.L, self.page, self.K, self.hd)}"
            )
        self.shared_prefix = shared
        shared.attach(self.host)    # map now so import cost is pure protocol

    def import_prefix(self, seq_id: int) -> int:
        """Materialize the shared prefix pages into this host's hot pool.

        Each page is a coherent read through this host's mapping: the first
        import misses (page fetches over the fabric, a dirty-read forward if
        the publisher still holds M), later imports hit the host's cached copy
        — the modeled economics the coherence benchmark measures. Returns the
        number of pages imported."""
        shared = self.shared_prefix
        if shared is None:
            raise ecxl.EmuCXLError("no shared prefix attached to this pool")
        for p in range(shared.num_pages):
            slot = self.alloc_page(seq_id, p)
            _load_page(self.k_pool, self.v_pool, slot,
                       shared.read_page(self.host, p))
        self.prefix_imports += 1
        return shared.num_pages

    # ------------------------------------------------------------------ tiering
    def demote(self, seq_id: int, page_idx: int) -> None:
        """Hot -> cold: DMA the page's bytes into a slab chunk on the remote tier."""
        ref = self._ref(seq_id, page_idx)
        if ref.hot_slot is None:
            return
        with spans.span("kv.demote"):
            slot = ref.hot_slot
            payload = _page_payload(self.k_pool, self.v_pool, slot)
            ref.cold_ptr = self.slab.alloc(len(payload), ecxl.REMOTE_MEMORY)
            self.slab.write(ref.cold_ptr, payload)
            ref.hot_slot = None
            self._seqs[seq_id].slots[page_idx] = 0
            self._free.append(slot)
            self.lru.remove((seq_id, page_idx))
            spans.count("kv_d2h_bytes", len(payload))

    def promote(self, seq_id: int, page_idx: int) -> int:
        """Cold -> hot (Policy1 path). Returns the new hot slot."""
        ref = self._ref(seq_id, page_idx)
        assert ref.cold_ptr is not None
        with spans.span("kv.promote"):
            nbytes = self._page_bytes()
            if not self._free:
                victim = self.lru.lru_key()
                if victim is None:
                    raise ecxl.OutOfTierMemory(0, nbytes, 0)
                self.demote(*victim)
            slot = self._free.pop()
            _load_page(self.k_pool, self.v_pool, slot, self.slab.read(ref.cold_ptr, nbytes))
            self.slab.free(ref.cold_ptr)
            ref.cold_ptr = None
            ref.hot_slot = slot
            self._seqs[seq_id].place(page_idx, slot)
            self.lru.add((seq_id, page_idx))
            spans.count("kv_h2d_bytes", nbytes)
        return slot

    def touch(self, seq_id: int, page_idx: int) -> Optional[int]:
        """GET semantics: record hit tier, apply the promotion policy."""
        ref = self._seqs.get(seq_id, self._NO_PAGES).refs.get(page_idx)
        if ref is None:
            self.stats.misses += 1
            return None
        if ref.is_local:
            self.stats.local_hits += 1
            self.lru.touch((ref.seq_id, ref.layer_page))
            return ref.hot_slot
        self.stats.remote_hits += 1
        if self.policy.promote_on_hit((seq_id, page_idx)):
            return self.promote(seq_id, page_idx)
        return None

    # ------------------------------------------------------------------ queries
    def hot_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Block table of hot slots for a sequence (-0 for unused; engine
        guarantees residency of all pages of RUNNING sequences)."""
        return self.hot_tables([seq_id], max_pages)[0]

    def hot_tables(self, seq_ids, max_pages: int) -> np.ndarray:
        """The block tables of a batch, one ``hot_table`` row a sequence, each
        copied from the sequence's own row; counts the pages the rows hold as
        ``entries``."""
        tables = np.zeros((len(seq_ids), max_pages), np.int32)
        entries = 0
        for row, seq_id in zip(tables, seq_ids):
            seq = self._seqs.get(seq_id)
            if seq is not None:
                n = min(max_pages, len(seq.slots))
                row[:n] = seq.slots[:n]
                entries += len(seq.refs)
        spans.count("entries", entries)
        return tables

    def residency(self, seq_id: int) -> Tuple[int, int]:
        seq = self._seqs.get(seq_id, self._NO_PAGES)
        hot = sum(1 for r in seq.refs.values() if r.is_local)
        return hot, len(seq.refs) - hot

    def write_token(self, seq_id: int, layer_kv: Tuple[torch.Tensor, torch.Tensor],
                    position: int) -> None:
        """Write one token's K/V (L, K, hd) into the owning hot page."""
        page_idx, offset = divmod(position, self.page)
        ref = self._ref(seq_id, page_idx)
        if ref.hot_slot is None:
            self.promote(seq_id, page_idx)
        slot = ref.hot_slot
        k_new, v_new = layer_kv
        self.k_pool[:, slot, offset] = k_new.to(self.dtype)
        self.v_pool[:, slot, offset] = v_new.to(self.dtype)
        self.lru.touch((seq_id, page_idx))
