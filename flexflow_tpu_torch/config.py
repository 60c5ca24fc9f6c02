"""Runtime configuration.

The PyTorch counterpart of flexflow_tpu/config.py, with every field of
the JAX package's under its name and default. The port runs one process
per device: with a torch.distributed process group up
(runtime/distributed.py) `workersPerNode` defaults to the processes on
this host (LOCAL_WORLD_SIZE, else the world size) and `numNodes` to the
world size over that, as the JAX package's read jax.local_device_count
and jax.process_count; without a group both default to 1.

The dataclass has slots, so a field the port does not read cannot be
set: `cfg.unported = 1` raises AttributeError instead of being ignored.
Nine fields of the JAX package's config are left out so for this reason:
neither package reads them and no script of the repo sets them
(`computationMode`, `enable_sample_parallel`,
`enable_inplace_optimizations`, `base_optimize_threshold`,
`enable_control_replication`, `python_data_loader_type`,
`simulator_segment_size`, `simulator_max_num_segments`,
`enable_propagation`).

`device` names where a compiled model lives: "cuda" (the default, the
first card) or "cuda:N", and "cpu" only when the caller asks for it. A
config that asks for a card on a machine without one raises at
construction: the port never continues on the CPU by itself. The
default is the process's default device (`default_device`), "cuda"
unless a script runner set another (`set_default_device`; run.py's
--device): a config or script that names a device keeps it.

Like the JAX package's, a config reads the reference's command-line
flags (`parse_args`, model.cc:3556 spellings) from sys.argv[1:] when it
is made. Every flag of the JAX package's sets its field as there;
anything else is skipped, as the reference passes unknown flags on to
Legion. Four fields are read by neither package's runtime and are kept
so the reference's flags parse to the same config: `weight_decay`
(`--wd`; the optimizers take their own), `cpusPerNode` (`-ll:cpu`),
`import_strategy_file` (`--import`) and `iterations` (`--iterations`).
The reference's accessors (`workers_per_node`, `get_batch_size`, ...)
read the fields as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional

import torch

from .ff_types import FFIterationConfig  # noqa: F401

# the device an FFConfig names when its caller names none
_DEFAULT_DEVICE = "cuda"


def default_device() -> str:
    """The device a new FFConfig (and the Keras frontend's config)
    names by default: "cuda" unless `set_default_device` changed it."""
    return _DEFAULT_DEVICE


def set_default_device(name: str) -> None:
    """Make `name` ("cuda", "cuda:N" or "cpu") the process's default
    device. It is not resolved here: a config that takes it resolves it,
    and raises there when it names a card this machine lacks."""
    global _DEFAULT_DEVICE
    try:
        kind = torch.device(name).type
    except RuntimeError:
        kind = None
    if kind not in ("cuda", "cpu"):
        raise ValueError(
            f"device {name!r}: expected 'cuda', 'cuda:N' or 'cpu'")
    _DEFAULT_DEVICE = name


def resolve_device(name: str) -> torch.device:
    """The torch device a config names. Raises when it names a card and
    this process sees none."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"device {name!r}: expected 'cuda', 'cuda:N' or 'cpu'")
    return dev


@dataclasses.dataclass(slots=True)
class FFConfig:
    """Global run configuration (reference: config.h:92-160)."""

    # fit()'s default number of passes over the data
    epochs: int = 1
    batch_size: int = 64
    # devices a node (a host): one process each. 0 = the local processes
    # of the process group, else the visible cards. Default: the local
    # processes of the group when one is up, else 1
    workersPerNode: int = 1
    # nodes (hosts); numNodes x workersPerNode must equal the world size
    # of the process group (1 without one). Default: the world size over
    # workersPerNode when a group is up, else 1
    numNodes: int = 1
    # CPU workers a node (reference -ll:cpu); read by neither package
    cpusPerNode: int = 1
    # the reference config's weight decay (--wd); the optimizers take
    # their own, as in the JAX package
    weight_decay: float = 0.0001
    # a strategy file named by --import; read by neither package's
    # compile (runtime/strategy_io.py loads one by its path)
    import_strategy_file: str = ""
    # the reference's iteration count (--iterations); fit() runs epochs
    iterations: int = 1
    # the manual strategy's degrees (no search), the JAX package's
    # fields: the data degree fills the devices the others leave. Each
    # executes on the mesh executor: tensor parallelism (Megatron-style
    # weight sharding over the "model" axis), sequence parallelism (3-D
    # activations sharded on the sequence over "seq", attention through
    # ring or Ulysses attention), expert parallelism (group_by's outputs
    # sharded over "expert"), pipeline parallelism (GPipe stages over a
    # "pipe" axis: transformer_blocks' stacked layers sharded over it, or
    # any other graph cut into stages, parallel/pipeline.py) and fsdp
    # (FSDP/ZeRO: weights sharded over an "fsdp" axis carved out of the
    # data workers, gathered on use)
    tensor_parallel_degree: int = 1
    sequence_parallel_degree: int = 1
    expert_parallel_degree: int = 1
    pipeline_parallel_degree: int = 1
    # micro-batches per pipeline flush (0 = one per stage), clamped to a
    # divisor of each data shard's batch
    num_microbatches: int = 0
    fsdp_degree: int = 1
    # the Unity strategy search (search/): >= 0 runs it at compile()
    # (0 = the JAX package's default budget of 10 expansions); -1 = the
    # manual lowering
    search_budget: int = -1
    # best-first pruning: candidates costing more than alpha x the best
    # are dropped (reference config.h search_alpha)
    search_alpha: float = 1.2
    # no search, whatever the budget (reference --only-data-parallel)
    only_data_parallel: bool = False
    # the search's bias toward node-loss-survivable strategies: a
    # candidate's cost is multiplied by 1 + penalty x its weight bytes
    # sharded across nodes. -1.0 = auto: 0.25 on a machine of several
    # nodes, 0 on one (as in the JAX package)
    search_survivability_penalty: float = -1.0
    # the searched graph in DOT form is written here after a search
    # ("" = not written; pcg/graph.py export_dot)
    export_strategy_computation_graph_file: str = ""
    # read by no substitution generator in either package; kept so the
    # reference's flags parse to the same fields
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    # a simulated machine for the search (-1 = the config's own): the
    # winner is searched for this many nodes x workers, then demoted to
    # the one device the port runs on
    search_num_nodes: int = -1
    search_num_workers: int = -1
    # price operators from times measured on the device
    # (search/measure.py) instead of the analytic roofline
    measure_operator_costs: bool = False
    # a JSON file the measurements persist in across runs ("" = memory)
    measured_cache_path: str = ""
    # write the searched strategy here (runtime/strategy_io.py)
    export_strategy_file: str = ""
    # a key = value machine description (search/machine_model.py
    # parse_machine_config); "" = the H100's published numbers
    machine_model_file: str = ""
    # >= 1: the search prices collectives on the topology-aware machine
    # model (search/network.py: hops on a torus of one node's devices,
    # congestion) instead of the flat one
    machine_model_version: int = 0
    # the memory-aware search (search/memory_optimization.py
    # graph_optimize_with_memory, the reference's --memory-search): the
    # lambda loop trades run time for per-device memory until the winner
    # fits device_mem (the chip's capacity when 0)
    perform_memory_search: bool = False
    # the reference simulator's workspace; read by neither package's
    # search, kept so the flag parses to the same field
    simulator_work_space_size: int = 64 * 1024 * 1024
    # a substitution-rule collection to search with instead of the
    # shipped ones (search/substitutions/*.json)
    substitution_json_path: Optional[str] = None
    # the search may also shard the sequence (the partition_seq_ring and
    # partition_seq_allgather substitutions; the JAX package's
    # --enable-sequence-parallel)
    enable_sequence_parallel: bool = False
    # bf16 compute (and KV cache) over f32 master weights
    allow_mixed_precision: bool = False
    # store gradients in bf16: None follows allow_mixed_precision, False
    # keeps f32 gradients under bf16 compute (the JAX package's rule)
    bf16_grads: Optional[bool] = None
    seed: int = 0
    # where a compiled model lives; the process's default_device() when
    # the caller names none
    device: str = dataclasses.field(default_factory=default_device)
    # recompute each attention op's internals in the backward instead of
    # saving them (torch.utils.checkpoint; JAX: jax.checkpoint)
    remat: bool = False
    # train steps fit() runs as one dispatch: on a card, N steps captured
    # in one CUDA graph and replayed (JAX: one lax.scan program). 1 = one
    # eager step per batch
    iterations_per_dispatch: int = 1
    # the rate of the SGD optimizer compile() makes when given none
    learning_rate: float = 0.01
    # pack chains of single-input ops into OP_FUSED nodes at compile()
    # (pcg/fusion.py; the reference's --fusion)
    perform_fusion: bool = False
    # per-device memory budget in bytes for the static analyzers
    # (analysis/memory.py FFA301) and the memory-aware search; 0 = the
    # cost model's chip capacity
    device_mem: int = 0
    # the FFA705 accumulated-drift budget of the precision pass
    # (analysis/precision.py); None = its DEFAULT_DRIFT_BUDGET
    precision_drift_budget: Optional[float] = None
    # fit() times every op (runtime/profiler.py profile_ops) on the first
    # batch and prints "[profiling] <op>: x ms fwd + y ms bwd" lines (the
    # reference's --profiling)
    profiling: bool = False
    # the search prices the weight-gradient syncs that a step can overlap
    # with the backward as hidden (search/cost_model.py); off by default,
    # as in the JAX package, so searched strategies stay reproducible
    search_overlap_backward_update: bool = False
    # the executed step's side (reference config.h:133): on a data axis
    # the mesh executor reduce-scatters each eligible gradient from the
    # backward as soon as it exists, updates the 1/d shard it owns (the
    # optimizer state lives sharded, ZeRO-1) and all-gathers the updated
    # weight (parallel/executor.py MeshExecutor). The same values as the
    # all-reduce step; on by default, inert at data degree 1
    overlap_backward_update: bool = True

    def __post_init__(self):
        from .runtime import distributed as rdist

        dev = resolve_device(self.device)
        if rdist.is_initialized():
            if self.workersPerNode in (0, 1) and self.numNodes == 1:
                self.workersPerNode = rdist.local_world_size()
                self.numNodes = max(1, rdist.process_count()
                                    // self.workersPerNode)
        elif self.workersPerNode == 0:
            self.workersPerNode = (torch.cuda.device_count()
                                   if dev.type == "cuda" else 1)
        argv = sys.argv[1:]
        if argv:
            self.parse_args(argv)

    def parse_args(self, argv: List[str]) -> None:
        """Read the reference's flags (the JAX package's spellings) from
        `argv`: each flag in _FLAGS sets its field from the value after it
        (a bad or missing value leaves the field as it was and is read as
        the next argument, as in the JAX package), each of _SWITCHES sets
        its field, each of _SETTINGS sets its fields to its values, and any
        other argument is skipped."""
        i = 0
        while i < len(argv):
            a = argv[i]
            if a in _SWITCHES:
                setattr(self, _SWITCHES[a], True)
            elif a in _SETTINGS:
                for field, value in _SETTINGS[a].items():
                    setattr(self, field, value)
            elif a in _FLAGS:
                field, kind = _FLAGS[a]
                if kind is None:
                    i += 1
                elif i + 1 < len(argv):
                    try:
                        setattr(self, field, kind(argv[i + 1]))
                        i += 1
                    except ValueError:
                        pass
            i += 1

    @property
    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    # the reference cffi's property and getter spellings
    # (flexflow_cffi.py:526-549), which reference scripts read
    @property
    def workers_per_node(self) -> int:
        if self.workersPerNode > 0:
            return self.workersPerNode
        return (torch.cuda.device_count()
                if resolve_device(self.device).type == "cuda" else 1)

    @property
    def num_nodes(self) -> int:
        return self.numNodes

    @property
    def cpus_per_node(self) -> int:
        return self.cpusPerNode

    @property
    def numWorkers(self) -> int:
        """Devices in the (possibly simulated) machine."""
        if self.search_num_nodes > 0 and self.search_num_workers > 0:
            return self.search_num_nodes * self.search_num_workers
        return self.numNodes * self.workersPerNode

    def get_batch_size(self) -> int:
        return self.batch_size

    def get_epochs(self) -> int:
        return self.epochs

    def get_workers_per_node(self) -> int:
        return self.workers_per_node

    def get_num_nodes(self) -> int:
        return self.num_nodes

    def get_current_time(self) -> float:
        """Microseconds, like Realm::Clock."""
        return time.time() * 1e6

    def begin_trace(self, trace_id: int) -> None:
        """reference: flexflow_cffi.py:2093 (Legion trace capture around
        an iteration). A no-op, as in the JAX package: fit's captured
        CUDA graphs (iterations_per_dispatch) play that role."""

    def end_trace(self, trace_id: int) -> None:
        """See begin_trace."""


# flag -> (field, type) of the reference's flags that take a value and
# whose field this package reads; a None type skips the value (the
# reference's print frequency, which nothing reads in either package)
_FLAGS = {
    "-e": ("epochs", int), "--epochs": ("epochs", int),
    "-b": ("batch_size", int), "--batch-size": ("batch_size", int),
    "--lr": ("learning_rate", float), "-lr": ("learning_rate", float),
    "--wd": ("weight_decay", float), "-wd": ("weight_decay", float),
    "-ll:cpu": ("cpusPerNode", int),
    "--import": ("import_strategy_file", str),
    "--import-strategy": ("import_strategy_file", str),
    "--iterations": ("iterations", int),
    "-p": (None, None), "--print-freq": (None, None),
    "-ll:gpu": ("workersPerNode", int), "-ll:tpu": ("workersPerNode", int),
    "--budget": ("search_budget", int),
    "--search-budget": ("search_budget", int),
    "--alpha": ("search_alpha", float), "--search-alpha": ("search_alpha", float),
    "--search-num-nodes": ("search_num_nodes", int),
    "--search-num-workers": ("search_num_workers", int),
    "--measured-cache": ("measured_cache_path", str),
    "--export": ("export_strategy_file", str),
    "--export-strategy": ("export_strategy_file", str),
    "--machine-model-file": ("machine_model_file", str),
    "--substitution-json": ("substitution_json_path", str),
    "--machine-model-version": ("machine_model_version", int),
    "--simulator-workspace-size": ("simulator_work_space_size", int),
    "--iterations-per-dispatch": ("iterations_per_dispatch", int),
    "--fsdp-degree": ("fsdp_degree", int),
    "--nodes": ("numNodes", int),
}
# flags without a value that set a field to True
_SWITCHES = {
    "--fusion": "perform_fusion",
    "--only-data-parallel": "only_data_parallel",
    "--enable-parameter-parallel": "enable_parameter_parallel",
    "--enable-attribute-parallel": "enable_attribute_parallel",
    "--measured-search": "measure_operator_costs",
    "--profiling": "profiling",
    "--memory-search": "perform_memory_search",
    "--enable-sequence-parallel": "enable_sequence_parallel",
}
# flags without a value that set several fields (the executed step's and
# the search's overlap switch together, as the JAX package's do)
_SETTINGS = {
    "--overlap-backward-update": {"overlap_backward_update": True,
                                  "search_overlap_backward_update": True},
    "--no-overlap-backward-update": {
        "overlap_backward_update": False,
        "search_overlap_backward_update": False},
}
