"""Fabric topology builder + routing: the graph under ``core/fabric.py``.

Pre-refactor, the fabric *was* its topology: one implicit switch, host uplinks
``host{i}``, pool ports ``pool{j}``, every path at most two links. Datacenter
CXL is not that (CXL-DMSim, arXiv:2411.02282): multi-tier switching, routing
choice, and queue occupancy dominate modeled behavior at cluster scale. This
module factors the graph out so the fluid-flow contention model in
``core/fabric.py`` runs unchanged over *any* shape:

``Topology``
    An undirected graph of **nodes** (host endpoints, pool-device endpoints,
    switches) joined by named **links** (``LinkSpec``: bandwidth/latency plus
    the per-port queue bound the fabric enforces). Build one with the
    ``single_switch``/``spine_leaf`` constructors or grow a custom adjacency
    via ``add_switch``/``add_host``/``add_pool_port``/``add_trunk``.

Routing
    ``route(src, dst)`` resolves a shortest path (hop count) between two
    nodes as an ordered tuple of link names. Equal-cost multipath is
    deterministic: the candidate paths are enumerated in lexicographic order
    and one is picked by a CRC32 hash of the ``(src, dst)`` flow pair — the
    same flow always takes the same spine, different flows spread, and no
    run-to-run nondeterminism (``PYTHONHASHSEED`` never enters). Builders
    accept ``ecmp=False`` to pin every tie to the first candidate instead
    (the degenerate "single spine" routing the benchmarks compare against).

The default ``single_switch`` graph reproduces the legacy fabric exactly —
same link names, same two-link paths, same one-switch latency — so a
``Fabric()`` constructed without a topology is bit-identical to the
pre-refactor one (property-tested in ``tests/test_topology_equivalence.py``).

Stdlib-only by design, like ``core/trace.py``/``core/mc.py``: the topology
layer must import on a bare interpreter.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

# The topology builder mints link names, as the reference module does.
# emucxl: allow-link-name


class TopologyError(RuntimeError):
    pass


#: Link kinds; the fabric resolves ``bandwidth=None`` per kind (host uplinks
#: default to ``hw.host_link_bandwidth``, pool ports and inter-switch trunks
#: to ``hw.pool_port_bandwidth``).
HOST, POOL, TRUNK = "host", "pool", "trunk"


def host_node(host: int) -> str:
    return f"host:{host}"


def pool_node(port: int) -> str:
    return f"pool:{port}"


def switch_node(name: str) -> str:
    return f"switch:{name}"


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One named edge of the topology graph.

    ``bandwidth``/``latency`` of ``None`` defer to the fabric's defaults for
    the link ``kind``. ``queue_capacity`` bounds how many transfers may *flow*
    on the link concurrently (None = unbounded, the legacy behavior);
    ``queue_depth`` bounds the FIFO of admitted-but-waiting transfers — the
    fabric is lossless (credit-based, like CXL), so an arrival beyond the
    depth still queues but is counted as a would-be ``drop``.
    """

    name: str
    a: str                                   # node id (host:/pool:/switch:)
    b: str
    kind: str = TRUNK
    bandwidth: Optional[float] = None
    latency: Optional[float] = None
    queue_capacity: Optional[int] = None
    queue_depth: Optional[int] = None


def _ecmp_hash(src: str, dst: str) -> int:
    """Deterministic flow hash: stable across processes and platforms."""
    return zlib.crc32(f"{src}->{dst}".encode())


def switch_hops(path: Tuple[str, ...]) -> int:
    """Switch traversals along a resolved path.

    Consecutive links always meet inside a switch, so a k-link endpoint-to-
    endpoint path crosses k-1 switches; the degenerate single-link path (a
    host talking to itself) still goes up to its switch and back, hence the
    floor of one — which is also exactly the legacy single-switch charge.
    """
    return max(len(path) - 1, 1)


class Topology:
    """A named fabric graph plus its router (see the module docstring)."""

    def __init__(self, name: str = "custom", ecmp: bool = True):
        self.name = name
        self.ecmp = ecmp
        self.links: Dict[str, LinkSpec] = {}       # insertion order matters:
        self._adj: Dict[str, List[str]] = {}       # it is the fabric's stats order
        self._switches: List[str] = []
        self._host_links: List[str] = []           # index == host id
        self._pool_links: List[str] = []           # index == pool port
        self._route_cache: Dict[Tuple[str, str], Tuple[str, ...]] = {}

    # ------------------------------------------------------------------ builder
    def add_switch(self, name: str) -> str:
        if name in self._switches:
            raise TopologyError(f"duplicate switch {name!r}")
        self._switches.append(name)
        self._adj.setdefault(switch_node(name), [])
        return name

    def add_link(self, spec: LinkSpec) -> str:
        if spec.name in self.links:
            raise TopologyError(f"duplicate link {spec.name!r}")
        if spec.a == spec.b:
            raise TopologyError(f"link {spec.name!r} is a self-loop")
        if spec.queue_capacity is not None and spec.queue_capacity < 1:
            raise TopologyError(
                f"link {spec.name!r}: queue_capacity must be >= 1 (or None)")
        if spec.queue_depth is not None and spec.queue_depth < 1:
            raise TopologyError(
                f"link {spec.name!r}: queue_depth must be >= 1 (or None)")
        self.links[spec.name] = spec
        self._adj.setdefault(spec.a, []).append(spec.name)
        self._adj.setdefault(spec.b, []).append(spec.name)
        self._route_cache.clear()
        return spec.name

    def _check_switch(self, switch: str) -> None:
        if switch not in self._switches:
            raise TopologyError(f"unknown switch {switch!r} "
                                f"(have {self._switches})")

    def add_host(self, switch: str, **link_kw) -> int:
        """Attach a new host endpoint to `switch`; returns the host id."""
        self._check_switch(switch)
        host = len(self._host_links)
        name = f"host{host}"
        self.add_link(LinkSpec(name, host_node(host), switch_node(switch),
                               kind=HOST, **link_kw))
        self._host_links.append(name)
        return host

    def add_pool_port(self, switch: str, **link_kw) -> int:
        """Attach a new pool-device port to `switch`; returns the port id."""
        self._check_switch(switch)
        port = len(self._pool_links)
        name = f"pool{port}"
        self.add_link(LinkSpec(name, pool_node(port), switch_node(switch),
                               kind=POOL, **link_kw))
        self._pool_links.append(name)
        return port

    def add_trunk(self, switch_a: str, switch_b: str, **link_kw) -> str:
        """Join two switches; the link is named ``{switch_a}-{switch_b}``."""
        self._check_switch(switch_a)
        self._check_switch(switch_b)
        return self.add_link(LinkSpec(
            f"{switch_a}-{switch_b}", switch_node(switch_a),
            switch_node(switch_b), kind=TRUNK, **link_kw))

    # ------------------------------------------------------------------ queries
    @property
    def num_hosts(self) -> int:
        return len(self._host_links)

    @property
    def pool_ports(self) -> int:
        return len(self._pool_links)

    @property
    def switches(self) -> Tuple[str, ...]:
        return tuple(self._switches)

    def host_link(self, host: int) -> str:
        """The host's uplink (its attachment link name)."""
        if not 0 <= host < self.num_hosts:
            raise TopologyError(f"invalid host {host} (have {self.num_hosts})")
        return self._host_links[host]

    def pool_link(self, port: int) -> str:
        """The pool port's attachment link name."""
        if not 0 <= port < self.pool_ports:
            raise TopologyError(f"invalid port {port} (have {self.pool_ports})")
        return self._pool_links[port]

    def validate(self) -> "Topology":
        """Check the graph is usable: endpoints present and fully connected."""
        if self.num_hosts < 1 or self.pool_ports < 1:
            raise TopologyError("need >= 1 host and >= 1 pool port")
        # Connectivity from host 0 reaches every endpoint.
        seen = {host_node(0)}
        frontier = deque(seen)
        while frontier:
            node = frontier.popleft()
            for link in self._adj.get(node, ()):
                spec = self.links[link]
                peer = spec.b if spec.a == node else spec.a
                if peer not in seen:
                    seen.add(peer)
                    frontier.append(peer)
        endpoints = ([host_node(i) for i in range(self.num_hosts)]
                     + [pool_node(j) for j in range(self.pool_ports)])
        unreachable = [n for n in endpoints if n not in seen]
        if unreachable:
            raise TopologyError(f"topology {self.name!r} is disconnected: "
                                f"{unreachable} unreachable from host 0")
        return self

    # ------------------------------------------------------------------ routing
    def _shortest_paths(self, src: str, dst: str) -> List[Tuple[str, ...]]:
        """Every minimum-hop link path src -> dst, lexicographically sorted."""
        if src not in self._adj or dst not in self._adj:
            missing = src if src not in self._adj else dst
            raise TopologyError(f"unknown node {missing!r}")
        dist = {src: 0}
        frontier = deque([src])
        while frontier:
            node = frontier.popleft()
            for link in self._adj[node]:
                spec = self.links[link]
                peer = spec.b if spec.a == node else spec.a
                if peer not in dist:
                    dist[peer] = dist[node] + 1
                    frontier.append(peer)
        if dst not in dist:
            raise TopologyError(f"no route {src!r} -> {dst!r}")
        paths: List[Tuple[str, ...]] = []

        def walk(node: str, acc: List[str]) -> None:
            if node == dst:
                paths.append(tuple(acc))
                return
            for link in self._adj[node]:
                spec = self.links[link]
                peer = spec.b if spec.a == node else spec.a
                if dist.get(peer) == dist[node] + 1:
                    acc.append(link)
                    walk(peer, acc)
                    acc.pop()

        walk(src, [])
        paths.sort()
        return paths

    def route(self, src: str, dst: str) -> Tuple[str, ...]:
        """Resolve the (deterministic) link path for the ``src -> dst`` flow.

        ``src == dst`` for an endpoint is the up-and-back degenerate path:
        just the endpoint's attachment link (the legacy same-host path).
        """
        key = (src, dst)
        cached = self._route_cache.get(key)
        if cached is not None:
            return cached
        if src == dst:
            attached = self._adj.get(src, ())
            if len(attached) != 1:
                raise TopologyError(
                    f"{src!r} is not a single-attachment endpoint")
            path: Tuple[str, ...] = (attached[0],)
        else:
            paths = self._shortest_paths(src, dst)
            pick = _ecmp_hash(src, dst) % len(paths) if self.ecmp else 0
            path = paths[pick]
        self._route_cache[key] = path
        return path

    def equal_cost_paths(self, src: str, dst: str) -> List[Tuple[str, ...]]:
        """All ECMP candidates for a flow (introspection / tests / benches)."""
        return self._shortest_paths(src, dst)

    def __repr__(self) -> str:
        return (f"Topology({self.name!r}, hosts={self.num_hosts}, "
                f"pool_ports={self.pool_ports}, "
                f"switches={len(self._switches)}, links={len(self.links)})")


# ---------------------------------------------------------------- constructors
def single_switch(num_hosts: int = 1, pool_ports: int = 1, *,
                  host_bandwidth: Optional[float] = None,
                  pool_port_bandwidth: Optional[float] = None,
                  link_latency: Optional[float] = None,
                  queue_capacity: Optional[int] = None,
                  queue_depth: Optional[int] = None) -> Topology:
    """The legacy shape: every host and pool port on one switch.

    With the default unbounded queues this is bit-identical to the
    pre-refactor fabric — same link names, paths, and latency charges.
    """
    if num_hosts < 1 or pool_ports < 1:
        raise TopologyError("need >= 1 host and >= 1 pool port")
    topo = Topology(name="single-switch")
    sw = topo.add_switch("switch0")
    for _ in range(num_hosts):
        topo.add_host(sw, bandwidth=host_bandwidth, latency=link_latency,
                      queue_capacity=queue_capacity, queue_depth=queue_depth)
    for _ in range(pool_ports):
        topo.add_pool_port(sw, bandwidth=pool_port_bandwidth,
                           latency=link_latency,
                           queue_capacity=queue_capacity,
                           queue_depth=queue_depth)
    return topo


def spine_leaf(leaves: int = 2, spines: int = 2, *,
               hosts_per_leaf: int = 1, pool_ports_per_leaf: int = 1,
               host_bandwidth: Optional[float] = None,
               pool_port_bandwidth: Optional[float] = None,
               trunk_bandwidth: Optional[float] = None,
               link_latency: Optional[float] = None,
               queue_capacity: Optional[int] = None,
               queue_depth: Optional[int] = None,
               ecmp: bool = True) -> Topology:
    """Two-tier Clos: hosts and pool devices hang off leaves, every leaf
    trunks to every spine. Host ``i`` lands on leaf ``i // hosts_per_leaf``;
    pool port ``j`` on leaf ``j // pool_ports_per_leaf``. Same-leaf traffic
    never crosses a trunk; cross-leaf flows pick a spine by the deterministic
    ECMP hash (or always the first spine with ``ecmp=False``)."""
    if leaves < 1 or spines < 1:
        raise TopologyError("need >= 1 leaf and >= 1 spine")
    if hosts_per_leaf < 1 or pool_ports_per_leaf < 1:
        raise TopologyError("need >= 1 host and >= 1 pool port per leaf")
    topo = Topology(name=f"spine-leaf-{leaves}x{spines}", ecmp=ecmp)
    leaf_names = [topo.add_switch(f"leaf{i}") for i in range(leaves)]
    spine_names = [topo.add_switch(f"spine{s}") for s in range(spines)]
    for leaf in leaf_names:
        for _ in range(hosts_per_leaf):
            topo.add_host(leaf, bandwidth=host_bandwidth,
                          latency=link_latency, queue_capacity=queue_capacity,
                          queue_depth=queue_depth)
    for leaf in leaf_names:
        for _ in range(pool_ports_per_leaf):
            topo.add_pool_port(leaf, bandwidth=pool_port_bandwidth,
                               latency=link_latency,
                               queue_capacity=queue_capacity,
                               queue_depth=queue_depth)
    for leaf in leaf_names:
        for spine in spine_names:
            topo.add_trunk(leaf, spine, bandwidth=trunk_bandwidth,
                           latency=link_latency,
                           queue_capacity=queue_capacity,
                           queue_depth=queue_depth)
    return topo
