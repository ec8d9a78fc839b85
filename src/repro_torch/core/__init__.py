"""repro_torch.core — emucxl-style two-tier disaggregated memory on PyTorch.

Two API generations share one modeled backend:
  * **v2 (preferred)**: ``CXLSession`` + generation-counted ``Buffer`` handles +
    the async op queue (``submit``/``flush`` with Read/Write/Migrate/Memcpy/Memset
    ops) and constructor-injected policies — see ``core/api.py``.
  * **v1 (paper fidelity)**: the Table II ``emucxl_*`` free functions, now a thin
    shim over a default session (raw ints remain the currency, but stale
    addresses raise instead of aliasing).

Plus the middleware the paper demonstrates (KV store, slab allocator,
direct-access queue) and the training/serving integration helpers (offload).
LOCAL bytes live in CUDA device memory and REMOTE bytes in pinned host memory
(both on the CPU when the caller asks for ``device="cpu"``).

Exports resolve lazily (PEP 562): ``from repro_torch.core import CXLSession`` pulls
in the torch-backed modules, but ``import repro_torch.core.mc`` (the stdlib-only
model checker) or ``import repro_torch.core.trace`` does not: neither loads torch
nor numpy.
"""

import importlib
from typing import Dict

# Public name -> owning submodule. The attribute is imported (and cached in
# this module's globals) on first access.
_EXPORTS: Dict[str, str] = {
    # v2 session API
    "CXLSession": "api", "as_session": "api",
    "Buffer": "handle", "HandleTable": "handle", "StaleHandleError": "handle",
    # v1 + backend
    "LOCAL_MEMORY": "emucxl", "REMOTE_MEMORY": "emucxl",
    "Allocation": "emucxl", "EmuCXL": "emucxl", "EmuCXLError": "emucxl",
    "OutOfTierMemory": "emucxl", "QuotaExceeded": "emucxl",
    "default_instance": "emucxl", "default_session": "emucxl",
    "emucxl_acquire": "emucxl", "emucxl_alloc": "emucxl",
    "emucxl_exit": "emucxl", "emucxl_fabric_stats": "emucxl",
    "emucxl_fence": "emucxl", "emucxl_free": "emucxl",
    "emucxl_get_host": "emucxl", "emucxl_get_numa_node": "emucxl",
    "emucxl_get_size": "emucxl", "emucxl_init": "emucxl",
    "emucxl_is_local": "emucxl", "emucxl_memcpy": "emucxl",
    "emucxl_memmove": "emucxl", "emucxl_memset": "emucxl",
    "emucxl_migrate": "emucxl", "emucxl_migrate_batch": "emucxl",
    "emucxl_pool_stats": "emucxl", "emucxl_read": "emucxl",
    "emucxl_resize": "emucxl", "emucxl_stats": "emucxl",
    "emucxl_write": "emucxl",
    # discrete-event engine + fabric + topology
    "SimulationEngine": "engine", "Job": "engine", "EngineError": "engine",
    "Fabric": "fabric", "FabricError": "fabric", "Link": "fabric",
    "Transfer": "fabric",
    "Topology": "topology", "TopologyError": "topology",
    "single_switch": "topology", "spine_leaf": "topology",
    # hardware model + middleware
    "V5E": "hw", "HardwareModel": "hw",
    "KVStore": "kvstore",
    "AccessStats": "policy", "CongestionAwarePlacement": "policy",
    "CongestionAwarePromotion": "policy", "Policy1": "policy",
    "Policy2": "policy", "StaticPlacement": "policy", "Tier": "policy",
    "make_policy": "policy",
    "DirectoryHomePolicy": "policy", "PinnedHome": "policy",
    "StripedHome": "policy",
    "LRUTier": "pool", "SharedPool": "pool",
    "SlabAllocator": "slab", "SlabPtr": "slab",
    # async op queue
    "EmuQueue": "queue", "OpQueue": "queue", "Ticket": "queue",
    "ReadOp": "queue", "WriteOp": "queue", "MigrateOp": "queue",
    "MemcpyOp": "queue", "MemsetOp": "queue", "FenceOp": "queue",
    "AcquireOp": "queue",
    # happens-before race detection (core/race.py)
    "RaceDetector": "race", "RaceError": "race", "RaceReport": "race",
    # linearized event traces (core/trace.py, stdlib-only)
    "TraceEvent": "trace", "TraceRecorder": "trace",
    # plan-time symbolic batch verifier (core/verify.py, stdlib-only)
    "Diagnostic": "verify", "OpDesc": "verify", "PoolView": "verify",
    "PreflightError": "verify", "PreflightResult": "verify",
    "SegmentView": "verify", "fresh_segment_view": "verify",
    "resolve_preflight_mode": "verify", "verify_batch": "verify",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    modname = _EXPORTS.get(name)
    if modname is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{modname}"), name)
    globals()[name] = value     # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
