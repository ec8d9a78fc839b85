"""Hardware model for the target platform (TPU v5e) and the emulated CXL-style host tier.

The paper emulates the CXL remote tier with a CPU-less NUMA node; the analogous remote
tier on a TPU host is pinned host DRAM behind the PCIe/CXL link. All roofline math and
the latency cost model read from this single source of truth.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-chip hardware constants for roofline and tier-latency modeling."""

    name: str = "tpu_v5e"
    # Compute / memory roofline terms (per chip).
    peak_flops_bf16: float = 197e12      # FLOP/s
    hbm_bandwidth: float = 819e9         # B/s, local tier ("node 0")
    hbm_capacity: int = 16 * 2**30       # bytes
    # Interconnect between chips (ICI). ~50 GB/s per link per direction.
    ici_link_bandwidth: float = 50e9     # B/s/link
    ici_links_per_chip: int = 4          # 2D torus, 2 axes x 2 directions
    # Host tier ("node 1") — the emulated CXL.mem pool behind PCIe.
    host_link_bandwidth: float = 32e9    # B/s (PCIe5 x16-class, matches CXL.mem spec rates)
    host_capacity: int = 512 * 2**30     # bytes of pooled DRAM per host
    # CXL-3.0-style fabric terms (core/fabric.py): each pool device hangs off the
    # switch on its own port; the switch adds latency but fabric ports are the
    # bandwidth bottleneck.
    pool_port_bandwidth: float = 32e9    # B/s per switch<->pool-device port
    switch_latency: float = 250e-9       # per-traversal switch latency
    # Latency floors (seconds). remote_access_latency mirrors the paper's NUMA-hop /
    # CXL.mem extra latency class (~150-250ns load; DMA setup is larger).
    local_access_latency: float = 100e-9
    remote_access_latency: float = 700e-9
    ici_hop_latency: float = 1e-6

    def tier_bandwidth(self, node: int) -> float:
        return self.hbm_bandwidth if node == 0 else self.host_link_bandwidth

    def tier_latency(self, node: int) -> float:
        return self.local_access_latency if node == 0 else self.remote_access_latency

    def transfer_time(self, nbytes: int, node: int) -> float:
        """Modeled time to stream `nbytes` from tier `node` into the compute engine."""
        return self.tier_latency(node) + nbytes / self.tier_bandwidth(node)

    def migrate_time(self, nbytes: int) -> float:
        """Modeled tier-to-tier migration time (bounded by the host link)."""
        return self.remote_access_latency + nbytes / self.host_link_bandwidth


V5E = HardwareModel()

# Chips per pod slice used throughout the launch configs.
SINGLE_POD_CHIPS = 256
MULTI_POD_CHIPS = 512
