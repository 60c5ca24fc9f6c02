"""Topology-aware network simulation for the cost model.

The PyTorch counterpart of flexflow_tpu/search/network.py (reference:
src/runtime/network.cc connection matrices and weighted-ECMP
shortest-path routing, and the EnhancedMachineModel's per-device comm
links with congestion, simulator.h:212-376). Transfers route over a
torus of the devices of one node hop by hop, per-link load is tracked,
and a congestion factor applies: the search can tell neighbour-hop
collectives from long-haul reshards, which the flat MachineModel
cannot. The model, its formulas and its defaults are the JAX package's
(`--machine-model-version 1`, or `topology_dims` in a machine file).

On an H100 node the default topology is a ring of `workers_per_node`
devices, as in the JAX package. An NVSwitch connects any two GPUs of a
DGX H100 in one hop, so this model prices a multi-hop ring collective
the switch does not have: the port keeps the JAX package's model and
has no switch topology.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from .machine_model import MachineModel


@dataclasses.dataclass
class TorusTopology:
    """Device coordinates on a torus (e.g. (4, 8)), row-major."""

    dims: Tuple[int, ...]  # e.g. (4, 8)

    def __post_init__(self):
        # memo tables: the search asks for the same <=32x32 chip pairs
        # hundreds of thousands of times per candidate
        self._nbr_cache: Dict[int, List[int]] = {}
        self._path_cache: Dict[Tuple[int, int], List[int]] = {}

    @property
    def num_chips(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def coords(self, chip: int) -> Tuple[int, ...]:
        c = []
        for d in reversed(self.dims):
            c.append(chip % d)
            chip //= d
        return tuple(reversed(c))

    def chip(self, coords: Sequence[int]) -> int:
        idx = 0
        for c, d in zip(coords, self.dims):
            idx = idx * d + (c % d)
        return idx

    def neighbors(self, chip: int) -> List[int]:
        hit = self._nbr_cache.get(chip)
        if hit is not None:
            return hit
        cs = list(self.coords(chip))
        out = []
        for axis, d in enumerate(self.dims):
            if d == 1:
                continue
            for delta in (-1, 1):
                n = list(cs)
                n[axis] = (n[axis] + delta) % d
                out.append(self.chip(n))
        out = sorted(set(out))
        self._nbr_cache[chip] = out
        return out

    def hop_distance(self, a: int, b: int) -> int:
        """Manhattan distance on the torus (wraparound links)."""
        ca, cb = self.coords(a), self.coords(b)
        dist = 0
        for x, y, d in zip(ca, cb, self.dims):
            delta = abs(x - y)
            dist += min(delta, d - delta)
        return dist

    def shortest_path(self, a: int, b: int) -> List[int]:
        """Dijkstra over unit-cost torus links (reference:
        WeightedShortestPathRoutingStrategy, simulator.h:172-399).
        Memoized: only num_chips^2 pairs exist, and one 32-worker
        Inception DP evaluation asks ~10k times."""
        hit = self._path_cache.get((a, b))
        if hit is not None:
            return hit
        if a == b:
            self._path_cache[(a, b)] = [a]
            return [a]
        dist = {a: 0}
        prev: Dict[int, int] = {}
        pq = [(0, a)]
        while pq:
            d, u = heapq.heappop(pq)
            if u == b:
                break
            if d > dist.get(u, 1 << 30):
                continue
            for v in self.neighbors(u):
                nd = d + 1
                if nd < dist.get(v, 1 << 30):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))
        path = [b]
        while path[-1] != a:
            path.append(prev[path[-1]])
        out = list(reversed(path))
        self._path_cache[(a, b)] = out
        return out


@dataclasses.dataclass
class TopologyAwareMachineModel(MachineModel):
    """MachineModel whose transfers inside a node route over a torus of
    its devices with per-link congestion, and whose traffic between nodes
    rides the flat node network (reference: EnhancedMachineModel's
    per-device comm links + congestion, machine_model.cc; NominalCommDevice
    path expansion, network.cc).

    The names are the JAX package's: a node is a "slice", the links
    inside it are "ICI" (`ici_*`: NVLink on a GPU node) and the network
    between nodes is "DCN" (`dcn_*`). `topology` describes ONE node's
    torus (device ids within a node are row-major torus coordinates). A
    multi-hop or cross-node collective therefore costs MORE than a
    neighbour-ring one of the same byte count, which is what lets the
    search prefer contiguous placements (the flat model cannot tell them
    apart)."""

    topology: Optional[TorusTopology] = None
    congestion_factor: float = 0.15  # extra latency fraction per active flow

    def __post_init__(self):
        if self.topology is None:
            self.topology = TorusTopology(dims=(self.workers_per_node,))
        assert self.topology.num_chips == self.workers_per_node, (
            "topology describes ONE slice: dims must multiply to "
            "workers_per_node"
        )
        self._link_load: Dict[Tuple[int, int], int] = {}

    @property
    def hierarchical(self) -> bool:
        return True

    def reset_congestion(self):
        self._link_load.clear()

    def _local(self, device_id: int) -> int:
        return device_id % self.workers_per_node

    def _hops(self, a: int, b: int) -> Optional[int]:
        """ICI hop distance, or None when a and b sit on different slices
        (DCN, not hop-countable)."""
        if self.node_of(a) != self.node_of(b):
            return None
        return self.topology.hop_distance(self._local(a), self._local(b))

    def xfer_cost(self, num_bytes: float, src: int, dst: int) -> float:
        """Stateless point-to-point estimate: hops on the slice torus,
        DCN across slices. Congestion is modelled for CONCURRENT flow
        sets via concurrent_flows_cost — accumulating load across
        independent cost queries would make search costs order-dependent
        (mutually exclusive candidate placements don't share links)."""
        if src == dst or num_bytes <= 0:
            return 0.0
        if self.node_of(src) != self.node_of(dst):
            # DCN: slice egress + ingress, no per-hop ICI model
            return self.dcn_latency + num_bytes / self.dcn_bandwidth
        path = self.topology.shortest_path(self._local(src), self._local(dst))
        hops = len(path) - 1
        # per-hop store-and-forward is pipelined: one BW term + per-hop latency
        return hops * self.ici_latency + num_bytes / self.ici_bandwidth

    def concurrent_flows_cost(self, flows) -> float:
        """Finish time of a SET of simultaneous transfers
        [(bytes, src, dst), ...] with per-link contention: each ICI link's
        service rate divides among the flows routed over it (reference:
        EnhancedMachineModel's congestion over shared comm devices,
        machine_model.cc). The slowest flow bounds the set."""
        self.reset_congestion()
        paths = []
        for num_bytes, src, dst in flows:
            if src == dst or num_bytes <= 0:
                paths.append(None)
                continue
            if self.node_of(src) != self.node_of(dst):
                paths.append("dcn")
                continue
            p = self.topology.shortest_path(self._local(src),
                                            self._local(dst))
            paths.append(p)
            for u, v in zip(p, p[1:]):
                key = (min(u, v), max(u, v))
                self._link_load[key] = self._link_load.get(key, 0) + 1
        worst = 0.0
        for (num_bytes, src, dst), p in zip(flows, paths):
            if p is None:
                continue
            if p == "dcn":
                worst = max(
                    worst, self.dcn_latency + num_bytes / self.dcn_bandwidth
                )
                continue
            load = max(
                self._link_load[(min(u, v), max(u, v))]
                for u, v in zip(p, p[1:])
            )
            t = (len(p) - 1) * self.ici_latency + num_bytes * (
                1.0 + self.congestion_factor * (load - 1)
            ) * load / self.ici_bandwidth
            worst = max(worst, t)
        return worst

    def ring_hop_factor(self, ids) -> Tuple[float, bool]:
        """(max ICI hops between ring neighbors, crosses_dcn) for a ring
        over `ids` in order. Public: the collective costs below scale by
        it, and the FFA504 topology lint (analysis/perf.py) reports it
        for non-contiguous rings."""
        ids = list(ids)
        n = len(ids)
        max_hops, crosses = 1, False
        for i in range(n):
            h = self._hops(ids[i], ids[(i + 1) % n])
            if h is None:
                crosses = True
            else:
                max_hops = max(max_hops, max(1, h))
        return float(max_hops), crosses

    # internal alias kept for call sites/tests predating the public name
    _ring_hop_factor = ring_hop_factor

    def allreduce_cost(self, num_bytes: float, device_ids) -> float:
        """Ring allreduce: neighbor links when the group is a contiguous
        torus ring, multi-hop (slower) otherwise; groups spanning slices
        decompose hierarchically — intra-slice reduce-scatter, DCN ring
        across slices, intra-slice all-gather (the hierarchical
        all-reduce of a two-level network)."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        slices = {}
        for d in ids:
            slices.setdefault(self.node_of(d), []).append(d)
        if len(slices) > 1:
            per_slice = max(len(v) for v in slices.values())
            s = len(slices)
            intra = 0.0
            if per_slice > 1:
                biggest = max(slices.values(), key=len)
                intra = self.allreduce_cost(num_bytes, biggest)
            dcn = (2 * (s - 1) / s * (num_bytes / max(1, per_slice))
                   / self.dcn_bandwidth + 2 * (s - 1) * self.dcn_latency)
            return intra + dcn
        max_hops, _ = self._ring_hop_factor(ids)
        per_step = num_bytes / n / self.ici_bandwidth * max_hops
        lat = 2 * (n - 1) * self.ici_latency * max_hops
        return 2 * (n - 1) * per_step + lat

    def replicate_cost(self, num_bytes: float, device_ids) -> float:
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        max_hops, crosses = self._ring_hop_factor(ids)
        t = (n - 1) * num_bytes / self.ici_bandwidth * max_hops
        if crosses:
            t += self.dcn_latency + num_bytes / self.dcn_bandwidth
        return t

    def all_to_all_cost(self, num_bytes: float, device_ids) -> float:
        """All-to-all: every pair exchanges; on a torus the bisection
        constrains it — scale by the group's mean pair hop distance;
        cross-slice shares ride DCN."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        hop_sum, pairs, dcn_pairs = 0.0, 0, 0
        for i in range(n):
            for j in range(i + 1, n):
                h = self._hops(ids[i], ids[j])
                if h is None:
                    dcn_pairs += 1
                else:
                    hop_sum += max(1, h)
                    pairs += 1
        mean_hops = (hop_sum / pairs) if pairs else 1.0
        t = num_bytes * (n - 1) / n / self.ici_bandwidth * mean_hops
        if dcn_pairs:
            frac = dcn_pairs / (pairs + dcn_pairs)
            t += num_bytes * frac / self.dcn_bandwidth + self.dcn_latency
        return t

    def reshard_cost(self, num_bytes: float, device_ids) -> float:
        ids = list(device_ids)
        if len(ids) <= 1 or num_bytes <= 0:
            return 0.0
        max_hops, crosses = self._ring_hop_factor(ids)
        t = num_bytes / self.ici_bandwidth * max_hops
        if crosses:
            t += self.dcn_latency + num_bytes / self.dcn_bandwidth
        return t
