"""Machine models for the strategy-search cost estimator.

The PyTorch counterpart of flexflow_tpu/search/machine_model.py
(reference: src/runtime/machine_model.cc SimpleMachineModel, flat
intra/inter-node bandwidths; simulator.h:212-376). The classes, their
defaults and the key = value file format are the JAX package's, so
`MachineModel()` and `parse_machine_config` read the same in both
packages; the parser accepts the GPU-era and the TPU-era key spellings.
The field names keep the JAX package's words: `ici_*` is the link
between devices of one node (NVLink on a GPU node), `dcn_*` the network
between nodes, `TPUChipSpec` the per-device peaks.

The defaults describe the JAX package's chip. The port's compile() does
not use them: without a machine file it builds `h100_machine`, the
H100's published numbers (`H100_SPEC`). The topology-aware model
(`--machine-model-version 1`, or `topology_dims` in a machine file) is
search/network.py's TopologyAwareMachineModel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class TPUChipSpec:
    """Per-device peak numbers. The defaults are the JAX package's (its
    chip's public spec), kept so both packages' MachineModel() agree.

    mxu_lanes / mxu_sublanes: the tile quanta the cost model pads a
    shard's matmul extents to (search/cost_model.py op_padded_flops).
    The defaults are the JAX package's systolic-array tile; a spec of
    1 and 1 prices the roofline without tile padding."""

    peak_flops_bf16: float = 197e12
    peak_flops_f32: float = 49e12
    hbm_bandwidth: float = 819e9  # bytes/s
    hbm_capacity: int = 16 * 1024**3
    vmem_capacity: int = 128 * 1024**2
    mxu_lanes: int = 128
    mxu_sublanes: int = 8


# The H100 SXM's published numbers (NVIDIA data sheet, dense, 700 W):
# 989e12 FLOP/s bf16 on the tensor cores, 3.35e12 B/s HBM3, 80 GB, and
# 50 MiB of L2 in the slot the JAX package gives its on-chip vector
# memory. f32 is priced at the CUDA cores' 67e12 FLOP/s: the port leaves
# TF32 off, so an f32 product does not run on the tensor cores. No tile
# rule has been measured for the card, so both quanta are 1: the
# roofline is priced unpadded, and the measured mode gives the real
# times.
H100_SPEC = TPUChipSpec(
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bandwidth=3.35e12,
    hbm_capacity=80 * 10**9,
    vmem_capacity=50 * 1024**2,
    mxu_lanes=1,
    mxu_sublanes=1,
)
# NVLink 4 on an H100 SXM node: 450e9 B/s each direction; between
# nodes, one 400 Gb/s NIC a GPU: 50e9 B/s
H100_NVLINK_BANDWIDTH = 450e9
H100_NODE_BANDWIDTH = 50e9


@dataclasses.dataclass
class MachineModel:
    """The machine the search optimizes for (reference: SimpleMachineModel,
    machine_model.cc). `num_nodes` = hosts/slices, `workers_per_node` =
    chips per host. Bandwidths in bytes/s, latencies in seconds."""

    num_nodes: int = 1
    workers_per_node: int = 8
    chip: TPUChipSpec = dataclasses.field(default_factory=TPUChipSpec)
    # the link between devices of one node (the JAX package's ICI)
    ici_bandwidth: float = 90e9
    ici_latency: float = 1e-6
    # the network between nodes (the JAX package's DCN)
    dcn_bandwidth: float = 25e9
    dcn_latency: float = 10e-6
    # effective utilization factors for analytic costs (the JAX
    # package's untuned constants; no fit for the card ships)
    mxu_efficiency: float = 0.55
    hbm_efficiency: float = 0.8

    @property
    def num_workers(self) -> int:
        return self.num_nodes * self.workers_per_node

    @property
    def hierarchical(self) -> bool:
        """True when this machine prices collectives over an ICI/DCN
        hierarchy (TopologyAwareMachineModel). The flat model prices
        every group at flat-mesh bandwidths — a cross-slice ring under
        it is mispriced by construction, which is exactly what the
        FFA504 lint (analysis/perf.py) flags."""
        return False

    def node_of(self, device_id: int) -> int:
        return device_id // self.workers_per_node

    def link_bandwidth(self, src: int, dst: int) -> float:
        """Flat two-level model (reference: SimpleMachineModel's
        inter/intra-node bandwidths)."""
        if src == dst:
            return self.chip.hbm_bandwidth * self.hbm_efficiency
        if self.node_of(src) == self.node_of(dst):
            return self.ici_bandwidth
        return self.dcn_bandwidth

    def link_latency(self, src: int, dst: int) -> float:
        if src == dst:
            return 0.0
        if self.node_of(src) == self.node_of(dst):
            return self.ici_latency
        return self.dcn_latency

    def xfer_cost(self, num_bytes: float, src: int, dst: int) -> float:
        """Point-to-point transfer time (seconds)."""
        if src == dst or num_bytes <= 0:
            return 0.0
        return self.link_latency(src, dst) + num_bytes / self.link_bandwidth(src, dst)

    def allreduce_cost(self, num_bytes: float, device_ids) -> float:
        """Ring allreduce over the given devices: 2(n-1)/n · bytes / BW on
        the slowest link in the ring (the XLA psum the optimizer/Reduction
        collectives compile to; replaces the reference's NCCL allreduce
        cost, optimizer_kernel.cu:88)."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        slowest = min(
            self.link_bandwidth(ids[i], ids[(i + 1) % n]) for i in range(n)
        )
        max_lat = max(self.link_latency(ids[i], ids[(i + 1) % n]) for i in range(n))
        return 2 * (n - 1) / n * num_bytes / slowest + 2 * (n - 1) * max_lat

    # collective costs the parallel-op nodes price against (overridden by
    # the topology model with hop/DCN-aware versions — reference:
    # EnhancedMachineModel's per-link comm devices, machine_model.cc)
    def replicate_cost(self, num_bytes: float, device_ids) -> float:
        """Broadcast one copy to every device in the group."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        return (n - 1) * num_bytes / self.ici_bandwidth

    def all_to_all_cost(self, num_bytes: float, device_ids) -> float:
        """Each device exchanges its (n-1)/n share with every peer."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        return num_bytes * (n - 1) / n / self.ici_bandwidth

    def reshard_cost(self, num_bytes: float, device_ids) -> float:
        """Repartition/Combine: one pass of the tensor over the group."""
        ids = list(device_ids)
        if len(ids) <= 1 or num_bytes <= 0:
            return 0.0
        return num_bytes / self.ici_bandwidth

    def all_gather_cost(self, num_bytes: float, device_ids) -> float:
        """Ring all-gather of a `num_bytes` buffer sharded over the group:
        each device receives (n-1)/n of the full buffer over n-1 ring
        steps (the FSDP weight-gather-on-use collective,
        parallel/weight_sharding.py). The latency term matters: it is
        what keeps half an all-reduce from pricing CHEAPER than the full
        all-reduce at small sizes (allreduce_cost carries 2(n-1) hops)."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        return (num_bytes * (n - 1) / n / self.ici_bandwidth
                + (n - 1) * self.ici_latency)

    def reduce_scatter_cost(self, num_bytes: float, device_ids) -> float:
        """Ring reduce-scatter of a `num_bytes` buffer onto per-device
        shards: (n-1)/n of the buffer crosses the wire over n-1 ring
        steps (half an all-reduce — the FSDP gradient collective)."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        return (num_bytes * (n - 1) / n / self.ici_bandwidth
                + (n - 1) * self.ici_latency)

    def latency_bound_collective_cost(self, kind: str, num_bytes: float,
                                      device_ids) -> float:
        """Collective pricing for the DECODE cost objective
        (search/cost_model.py CostObjective.DECODE): a single-token decode
        step moves KB-sized activation messages, so the ring's hop latency
        — which the bandwidth-oriented replicate/all_to_all/reshard costs
        deliberately omit (it is noise at training-step message sizes) —
        dominates the wire time. Prices the same bandwidth term as the
        training methods PLUS (n-1) hops of the slowest link's latency
        (allreduce pays its usual 2(n-1) hops), so tiny messages cost
        ~hops·latency and large ones converge to the training price. Kept
        as a separate method so adding latency here can never perturb a
        training-objective search."""
        ids = list(device_ids)
        n = len(ids)
        if n <= 1 or num_bytes <= 0:
            return 0.0
        if kind == "allreduce":
            # already carries its 2(n-1)·max_lat hop term
            return self.allreduce_cost(num_bytes, ids)
        bw_cost = {
            "all_gather": self.all_gather_cost,
            "reduce_scatter": self.reduce_scatter_cost,
            "replicate": self.replicate_cost,
            "all_to_all": self.all_to_all_cost,
            "reshard": self.reshard_cost,
        }[kind](num_bytes, ids)
        max_lat = max(
            self.link_latency(ids[i], ids[(i + 1) % n]) for i in range(n)
        )
        if kind in ("all_gather", "reduce_scatter"):
            # those formulas carry (n-1)·ici_latency; upgrade to the
            # slowest link in the actual group (DCN-crossing rings)
            return bw_cost + (n - 1) * max(0.0, max_lat - self.ici_latency)
        return bw_cost + (n - 1) * max_lat

    def exposed_comm_time(self, comm_s: float, hideable_compute_s: float,
                          efficiency: float = 1.0) -> float:
        """Comm time left on the critical path when a collective may run
        concurrently with `hideable_compute_s` of independent compute
        (the overlap-discount seam, search/cost_model.py): the compute
        and comm channels progress in parallel, so only
        max(0, comm - efficiency * compute) is exposed. `efficiency` is
        the calibrated fraction of the compute window the copy engines
        actually fill (1.0 = perfect overlap). Never negative, and never
        bigger than the additive cost — the two invariants the discount
        unit tests pin down."""
        if comm_s <= 0.0:
            return 0.0
        eff = min(max(efficiency, 0.0), 1.0)
        return max(0.0, comm_s - eff * max(0.0, hideable_compute_s))

    def compute_cost(
        self, flops: float, mem_bytes: float, dtype_is_bf16: bool = True,
        *, mxu_eff: Optional[float] = None, hbm_eff: Optional[float] = None,
    ) -> float:
        """Roofline: max of the matmul-unit time and the HBM time (the
        analytic stand-in for the reference's on-device microbenchmarks,
        simulator.cc measure_operator_cost; search/measure.py times ops on
        the device instead when the config asks for it).
        mxu_eff/hbm_eff override the model's global efficiency constants
        (the per-op-class calibration fit, search/cost_model.py)."""
        peak = (
            self.chip.peak_flops_bf16 if dtype_is_bf16 else self.chip.peak_flops_f32
        )
        # `is None`, not truthiness: a calibrated efficiency of 0.0 from a
        # hand-edited file must be rejected upstream, never silently
        # replaced by the global constant
        if mxu_eff is None:
            mxu_eff = self.mxu_efficiency
        if hbm_eff is None:
            hbm_eff = self.hbm_efficiency
        t_flops = flops / (peak * mxu_eff)
        t_mem = mem_bytes / (self.chip.hbm_bandwidth * hbm_eff)
        return max(t_flops, t_mem)


def for_device_count(n: int, like: Optional[MachineModel] = None) -> MachineModel:
    """Re-target a machine model at `n` live devices (the elastic
    re-search entry, runtime/elastic.py): keep `like`'s per-chip and
    link constants — those describe the hardware, which didn't change —
    but re-factor the topology so nodes × workers covers exactly the
    surviving device count. Prefers keeping `like`'s workers_per_node
    when it still divides n (a whole host dropped); otherwise falls back
    to the largest divisor of n that fits (the pod lost part of a host,
    or n is not a multiple of the old host size)."""
    base = like if like is not None else MachineModel()
    n = max(1, int(n))
    wpn = base.workers_per_node
    if wpn > n or n % wpn != 0:
        wpn = max(d for d in range(1, min(wpn, n) + 1) if n % d == 0)
    kwargs = {"num_nodes": n // wpn, "workers_per_node": wpn}
    if getattr(base, "topology", None) is not None \
            and wpn != base.workers_per_node:
        # a torus of the OLD node shape can't describe the shrunk node;
        # degrade to a 1-D ring of the surviving devices (replace() re-runs
        # __post_init__, which asserts topology matches workers_per_node)
        from .network import TorusTopology

        kwargs["topology"] = TorusTopology(dims=(wpn,))
    return dataclasses.replace(base, **kwargs)


def parse_machine_config(path: str) -> MachineModel:
    """Parse a key = value machine description file (same shape as the
    reference's machine_config_example; accepts both GPU-era and TPU-era
    key spellings). Keys not in the file keep MachineModel()'s values.

    Topology keys select the EnhancedMachineModel analog
    (TopologyAwareMachineModel, search/network.py: per-link hops on a
    torus of one node's devices, the node network across nodes,
    congestion):
      topology_dims = 4x8         # the torus of ONE node
      machine_model_version = 1   # same switch as --machine-model-version
      congestion_factor = 0.15
      ici_latency / dcn_latency   # seconds
    """
    kv: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            kv[k.strip().lower()] = v.strip()

    def get_f(keys, default):
        for k in keys:
            if k in kv:
                return float(kv[k])
        return default

    def get_i(keys, default):
        return int(get_f(keys, default))

    m = MachineModel()
    m.num_nodes = get_i(["num_nodes"], m.num_nodes)
    m.workers_per_node = get_i(
        ["num_gpus_per_node", "num_chips_per_node", "workers_per_node"],
        m.workers_per_node,
    )
    # reference uses MB/s-ish units in its config; ours are bytes/s. Accept
    # plain numbers as bytes/s.
    m.ici_bandwidth = get_f(
        ["ici_bandwidth", "intra_node_bandwidth", "nvlink_bandwidth"],
        m.ici_bandwidth,
    )
    m.dcn_bandwidth = get_f(
        ["dcn_bandwidth", "inter_node_bandwidth", "nic_bandwidth"],
        m.dcn_bandwidth,
    )
    m.ici_latency = get_f(["ici_latency"], m.ici_latency)
    m.dcn_latency = get_f(["dcn_latency"], m.dcn_latency)
    m.chip.peak_flops_bf16 = get_f(["peak_flops_bf16"], m.chip.peak_flops_bf16)
    m.chip.hbm_bandwidth = get_f(["hbm_bandwidth"], m.chip.hbm_bandwidth)
    m.chip.hbm_capacity = get_i(["hbm_capacity", "device_mem"], m.chip.hbm_capacity)

    version = get_i(["machine_model_version"], 0)
    topo_str = kv.get("topology_dims", "")
    if version >= 1 or topo_str:
        from .network import TopologyAwareMachineModel, TorusTopology

        dims = (tuple(int(d) for d in topo_str.replace("x", " ").split())
                if topo_str else (m.workers_per_node,))
        return TopologyAwareMachineModel(
            num_nodes=m.num_nodes,
            workers_per_node=m.workers_per_node,
            chip=m.chip,
            ici_bandwidth=m.ici_bandwidth,
            ici_latency=m.ici_latency,
            dcn_bandwidth=m.dcn_bandwidth,
            dcn_latency=m.dcn_latency,
            topology=TorusTopology(dims=dims),
            congestion_factor=get_f(["congestion_factor"], 0.15),
        )
    return m


def h100_machine(num_nodes: int = 1, workers_per_node: int = 1
                 ) -> MachineModel:
    """The machine compile() searches for when no machine file is given:
    H100s with their published numbers, NVLink within a node."""
    return MachineModel(
        num_nodes=num_nodes, workers_per_node=workers_per_node,
        chip=dataclasses.replace(H100_SPEC),
        ici_bandwidth=H100_NVLINK_BANDWIDTH,
        dcn_bandwidth=H100_NODE_BANDWIDTH)
