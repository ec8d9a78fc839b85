"""Hardware model for the target platform (TPU v5e) and the emulated CXL-style host tier.

The port adds ``H100``, the card it runs on, beside ``V5E`` (ROADMAP A.12).

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

# The port's card, NVIDIA H100 SXM5 80GB, offered beside V5E (which stays the
# default everywhere, so modeled statistics equal the reference's). Figures
# from NVIDIA's H100 Tensor Core GPU data sheet unless noted; the emulator's
# latency floors and pooled-DRAM terms keep V5E's values.
H100 = HardwareModel(
    name="h100_sxm",
    peak_flops_bf16=989e12,        # data sheet: BF16 Tensor Core, dense (1979 sparse)
    hbm_bandwidth=3.35e12,         # data sheet: HBM3, 3.35 TB/s
    hbm_capacity=80 * 2**30,       # data sheet: 80 GB HBM3
    # NVLink 4 in place of ICI: 900 GB/s per GPU over 18 links (data sheet),
    # i.e. 25 GB/s per link per direction
    ici_link_bandwidth=25e9,
    ici_links_per_chip=18,
    host_link_bandwidth=64e9,      # data sheet: PCIe Gen5 x16, 128 GB/s both ways
)

# Chips per pod slice used throughout the launch configs.
SINGLE_POD_CHIPS = 256
MULTI_POD_CHIPS = 512
