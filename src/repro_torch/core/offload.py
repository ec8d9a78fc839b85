"""Tier-placement helpers wiring the emucxl model into training and serving.

The port of ``repro/core/offload.py``. It expresses the paper's local/remote
split in PyTorch terms:
  * persistent state (optimizer moments, fp32 master params, cold KV pages)
    placed in the REMOTE tier lives in page-locked host memory, which on the
    H100 sits behind PCIe, the stand-in for CXL.mem (``optim/adamw.py``);
  * a remat policy sends the tensors a checkpointed layer saves for its
    backward, the layer's input (the reference's ``"residual"``), to that
    tier between forward and backward, and fetches them for the recompute.

Memory spaces: a CUDA device has two (device memory and pinned host
memory); a CPU run has one, ordinary host memory, which the emulator reports
as ``"unpinned_host"`` (ROADMAP C.6). ``resolve_memory_kind`` answers so, and
the **OffloadManifest** records the intended host residency either way, as
the reference's does on backends that cannot place memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import leaves as tree_leaves, tree_map

HOST = "pinned_host"
DEVICE = "device"
UNPINNED_HOST = "unpinned_host"


def backend_supports_memory_spaces(device="cuda") -> bool:
    """True when `device` has a host tier apart from its own memory: a CUDA
    device on a machine that has one."""
    return torch.device(device).type == "cuda" and torch.cuda.is_available()


def resolve_memory_kind(kind: str, device="cuda") -> str:
    """The memory `kind` really takes on `device`: host placement on a CPU run
    is ordinary host memory."""
    if kind == HOST and not backend_supports_memory_spaces(device):
        return UNPINNED_HOST
    return kind


def with_memory_kind(sharding, kind: str):
    """Clone a ``NamedSharding`` onto the given memory tier (layout-preserving),
    as the memory kind resolves on its mesh's device type."""
    device = getattr(sharding.mesh, "device_type", "cuda")
    return dataclasses.replace(sharding, memory_kind=resolve_memory_kind(kind, device))


def _tier_tree(shardings: Any, kind: str) -> Any:
    # None is an empty subtree, as ``jax.tree.map`` sees it
    return tree_map(lambda s: None if s is None else with_memory_kind(s, kind), shardings)


def host_sharding_tree(shardings: Any) -> Any:
    """Map a tree of shardings to the remote (host) tier."""
    return _tier_tree(shardings, HOST)


def device_sharding_tree(shardings: Any) -> Any:
    return _tier_tree(shardings, DEVICE)


def to_tier(t: torch.Tensor, kind: str, device="cuda") -> torch.Tensor:
    """A copy of `t` in tier `kind`: on `device` for ``"device"``; in host
    memory for ``"pinned_host"``, page-locked where `device` is a card."""
    if kind == DEVICE:
        return t.to(device)
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=backend_supports_memory_spaces(device))
    return out.copy_(t)


@dataclasses.dataclass
class OffloadEntry:
    name: str
    nbytes: int
    direction: str  # "resident" (host-held, fetched+written back each step) or "oneway"


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return 0


@dataclasses.dataclass
class OffloadManifest:
    """Ledger of intended remote-tier residency, independent of backend support.

    The roofline's host-DMA term is ``2 * resident_bytes / host_link_bandwidth`` per
    step (fetch + write-back).
    """

    entries: List[OffloadEntry] = dataclasses.field(default_factory=list)

    def add_tree(self, name: str, tree: Any, direction: str = "resident") -> None:
        nbytes = sum(_nbytes(leaf) for leaf in tree_leaves(tree))
        if nbytes:
            self.entries.append(OffloadEntry(name, nbytes, direction))

    @property
    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self.entries if e.direction == "resident")

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.entries)

    def dma_bytes_per_step(self) -> int:
        """Host-link traffic per train step: resident state crosses twice."""
        return 2 * self.resident_bytes + sum(
            e.nbytes for e in self.entries if e.direction == "oneway"
        )

    def summary(self) -> Dict[str, int]:
        return {e.name: e.nbytes for e in self.entries}

    def stage(self, session, host: int = 0) -> Dict[str, Any]:
        """Materialize the manifest in a v2 ``CXLSession`` (see stage_manifest)."""
        return stage_manifest(self, session, host)


def stage_manifest(manifest: OffloadManifest, session, host: int = 0) -> Dict[str, Any]:
    """Back every manifest entry with a remote-tier v2 session allocation.

    Each intended host-resident tensor becomes a generation-counted ``Buffer``
    in the session's shared pool, charged to `host`'s quota and placed by the
    session's placement policy — so offload pressure from a training/serving
    job shows up in ``pool_stats`` and (with a fabric) link occupancy,
    alongside every other consumer. Returns {entry name: Buffer}.
    """
    from repro_torch.core.emucxl import REMOTE_MEMORY

    return {
        e.name: session.alloc(e.nbytes, REMOTE_MEMORY, host)
        for e in manifest.entries
        if e.nbytes > 0
    }


class OffloadPolicy(torch.autograd.graph.saved_tensors_hooks):
    """The saved tensors of the regions it wraps go to host memory.

    Used as a context manager around a per-layer non-reentrant checkpoint,
    it sees exactly what the checkpoint keeps for its recompute, the layer's
    input (the ops inside the layer save through the checkpoint's own
    hooks). Pack copies a tensor into host memory, page-locked on a card;
    unpack fetches it back to its device for the recompute.
    ``OffloadPolicy.total_bytes`` counts the bytes every policy sent to the
    host, for callers that never see the policy (``forward`` makes one per
    call)."""

    total_bytes = 0

    def __init__(self, pin: bool):
        self.pin = pin
        super().__init__(self._pack, self._unpack)

    def _pack(self, t: torch.Tensor):
        OffloadPolicy.total_bytes += t.numel() * t.element_size()
        if t.device.type == "cpu" and not self.pin:
            return t.device, t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pin)
        host.copy_(t, non_blocking=self.pin)
        return t.device, host

    @staticmethod
    def _unpack(packed):
        device, host = packed
        return host.to(device, non_blocking=True)


def offload_checkpoint_policy(names: Sequence[str], device="cuda") -> Optional[OffloadPolicy]:
    """Remat policy: checkpointed layers' saved inputs, the reference's
    ``"residual"``, go to the host tier. Only ``"residual"`` names a saved
    tensor in the models, as in the reference; without it the policy keeps
    everything on the device (None, plain remat)."""
    if "residual" not in names:
        return None
    return OffloadPolicy(pin=backend_supports_memory_spaces(device))


def remat(fn: Callable, *, policy: Optional[OffloadPolicy] = None):
    """Per-call activation checkpointing (``torch.utils.checkpoint``, not
    reentrant): `fn`'s activations are recomputed in the backward, and its
    inputs are kept, in the tier `policy` names (the device when None)."""

    def wrapped(*args):
        if policy is None:
            return checkpoint(fn, *args, use_reentrant=False)
        with policy:
            return checkpoint(fn, *args, use_reentrant=False)

    return wrapped
