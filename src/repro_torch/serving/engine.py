"""Serving engine: continuous batching over the two-tier paged KV cache.

Request lifecycle: queued -> prefill -> running -> finished, with PREEMPTION when
the hot page pool runs dry: the LRU running sequence's pages are demoted to the
remote tier (the paper's KV-store demotion), and promoted back (Policy1) when
re-admitted — the paper's middleware semantics driving a real serving loop.

Decode is batched across running sequences via paged_decode_step; prefill runs
token-by-token through the same path (adequate at smoke scale; a chunked-prefill
fast path is an optimization hook, not a correctness need).

The port of ``repro/serving/engine.py``: pools and parameters live on the
engine's device (the card by default); each step copies the batch's block
tables, lengths and tokens to the device and the B sampled token ids back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import CXLSession
from repro_torch.core.policy import PromotionPolicy
from repro_torch.models import transformer as tf
from repro_torch.serving.kv_manager import PagedKVPool, SharedPrefixKV
from repro_torch.serving.paged_decode import paged_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"        # queued | running | preempted | finished
    position: int = 0            # tokens materialized in the cache
    # Policy2 (conservative) marks re-admitted requests read-through: their pages
    # are promoted only for the duration of each step and demoted right after —
    # the serving analogue of "serve the GET from remote without moving it".
    read_through: bool = False


class ServingEngine:
    def __init__(
        self,
        params,
        cfg: ArchConfig,
        num_slots: int = 64,
        page_size: int = 16,
        max_batch: int = 4,
        max_pages_per_seq: int = 16,
        policy: Optional[PromotionPolicy] = None,
        opts: tf.ModelOptions = tf.ModelOptions(moe_impl="dense"),
        host: int = 0,
        session: Optional[CXLSession] = None,
        shared_prefix: Optional[SharedPrefixKV] = None,
        device="cuda",
    ):
        self.params, self.cfg, self.opts = params, cfg, opts
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages = max_pages_per_seq
        # The cold tier (and the default promotion policy, when `policy` is None)
        # comes from the injected v2 session; None keeps v1's process default.
        self.pool = PagedKVPool(
            cfg.num_layers, num_slots, page_size, cfg.num_kv_heads,
            cfg.resolved_head_dim, dtype=torch.float32, policy=policy, host=host,
            session=session, device=device,
        )
        self.device = self.pool.device
        # Coherent common-prefix sharing: when set, every admitted prompt that
        # covers the prefix imports its KV pages from the shared segment (one
        # pooled copy fleet-wide) instead of prefilling them.
        if shared_prefix is not None:
            self.pool.attach_shared_prefix(shared_prefix)
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.preemptions = 0
        self.decode_batches = 0      # paged_decode_step calls (one per decode step)

    # ------------------------------------------------------------------ API
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, list(prompt), max_new_tokens)
        return rid

    def run(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        steps = 0
        while steps < max_steps and any(
            r.state != "finished" for r in self.requests.values()
        ):
            self.step()
            steps += 1
        return {r.rid: r.generated for r in self.requests.values()}

    # ------------------------------------------------------------------ loop
    def step(self) -> None:
        self._admit()
        running = [r for r in self.requests.values() if r.state == "running"]
        if not running:
            return
        batch = running[: self.max_batch]
        self._decode_batch(batch)

    def _pages_needed(self, r: Request) -> int:
        total = len(r.prompt) + r.max_new_tokens
        return -(-total // self.page_size)

    def _admit(self) -> None:
        for r in sorted(self.requests.values(), key=lambda x: x.rid):
            if r.state not in ("queued", "preempted"):
                continue
            need = self._pages_needed(r)
            if r.state == "preempted":
                while self.pool.free_slots() < need and self._evict_someone(r):
                    pass
                if self.pool.free_slots() < need:
                    continue
                # policy decides how re-admitted pages behave: Policy1 promotes
                # them persistently; Policy2 keeps them read-through (demoted
                # again after every step — conservative, no placement change).
                r.read_through = not self.pool.policy.promote_on_hit((r.rid, 0))
                for p in range(need):
                    if self.pool.touch(r.rid, p) is None:
                        self.pool.promote(r.rid, p)
                r.state = "running"
                continue
            if self.pool.free_slots() < need and not self._evict_someone(r):
                continue
            if self.pool.free_slots() < need:
                continue
            shared = self.pool.shared_prefix
            if (shared is not None and shared.prefix_tokens > 0
                    and shared.matches(r.prompt)):
                # The prompt STARTS WITH the published prefix: import its KV
                # pages from the coherent segment, skip prefilling those tokens.
                imported = self.pool.import_prefix(r.rid)
                for p in range(imported, need):
                    self.pool.alloc_page(r.rid, p)
                r.position = shared.prefix_tokens
            else:
                for p in range(need):
                    self.pool.alloc_page(r.rid, p)
            r.state = "running"

    def _evict_someone(self, beneficiary: Request) -> bool:
        """Preempt the LRU running request (demote all its pages)."""
        running = [r for r in self.requests.values()
                   if r.state == "running" and r.rid != beneficiary.rid]
        if not running:
            return False
        victim = running[0]
        for p in range(self._pages_needed(victim)):
            self.pool.demote(victim.rid, p)
        victim.state = "preempted"
        self.preemptions += 1
        return True

    # ------------------------------------------------------------------ decode
    def _decode_batch(self, batch: List[Request]) -> None:
        tables = np.stack(
            [self.pool.hot_table(r.rid, self.max_pages) for r in batch]
        )
        lengths = np.array([r.position for r in batch], np.int32)
        tokens = np.array(
            [[self._next_input(r)] for r in batch], np.int32
        )
        for r in batch:
            for p in range(r.position // self.page_size + 1):
                self.pool.touch(r.rid, p)
        dev = self.device
        logits, self.pool.k_pool, self.pool.v_pool = paged_decode_step(
            self.params, self.cfg, self.pool.k_pool, self.pool.v_pool,
            torch.from_numpy(tables).to(dev), torch.from_numpy(lengths).to(dev),
            torch.from_numpy(tokens).to(dev), self.opts,
        )
        self.decode_batches += 1
        # argmax on the device; one host copy of the B token ids
        next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, r in enumerate(batch):
            r.position += 1
            if r.position >= len(r.prompt):
                r.generated.append(int(next_tokens[i]))
                if (len(r.generated) >= r.max_new_tokens
                        or r.position >= self.max_pages * self.page_size - 1):
                    r.state = "finished"
                    self.pool.free_sequence(r.rid)
            if r.state == "running" and r.read_through:
                # Policy2: give the hot slots back immediately (next step re-DMAs)
                for p in range(self._pages_needed(r)):
                    self.pool.demote(r.rid, p)
                r.state = "preempted"

    def _next_input(self, r: Request) -> int:
        if r.position < len(r.prompt):
            return r.prompt[r.position]
        return r.generated[-1]

    # ------------------------------------------------------------------ stats
    def tier_stats(self):
        return {
            "local_hits": self.pool.stats.local_hits,
            "remote_hits": self.pool.stats.remote_hits,
            "percent_local": self.pool.stats.percent_local,
            "preemptions": self.preemptions,
            "remote_bytes": self.pool.session.stats(1),
            "prefix_imports": self.pool.prefix_imports,
        }
