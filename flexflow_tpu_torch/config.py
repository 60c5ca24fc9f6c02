"""Runtime configuration.

The PyTorch counterpart of flexflow_tpu/config.py, with the fields this
package reads, under the JAX package's names. Device counts come from
`torch.cuda`.

The dataclass has slots, so a field the port does not read (a JAX
field not ported yet) cannot be set: `cfg.unported = 1` raises
AttributeError instead of being ignored.

`device` names where a compiled model lives: "cuda" (the default, the
first card) or "cuda:N", and "cpu" only when the caller asks for it. A
config that asks for a card on a machine without one raises at
construction: the port never continues on the CPU by itself.

Like the JAX package's, a config reads the reference's command-line
flags (`parse_args`, model.cc:3556 spellings) from sys.argv[1:] when it
is made. A flag whose field this package reads sets it; a flag of a
feature not ported here (the memory-aware search, the topology machine
model, strategy import, multi-node and multi-device execution,
profiling) raises NotImplementedError naming the flag; anything else is
skipped, as the reference passes unknown flags on to Legion.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

import torch


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
    # devices; 0 = all visible cards. One by default: compile() runs on
    # one device and refuses more until multi-device execution is ported
    workersPerNode: int = 1
    # the Unity strategy search (search/): >= 0 runs it at compile()
    # (0 = the JAX package's default budget of 10 expansions); -1 = the
    # manual lowering
    search_budget: int = -1
    # best-first pruning: candidates costing more than alpha x the best
    # are dropped (reference config.h search_alpha)
    search_alpha: float = 1.2
    # no search, whatever the budget (reference --only-data-parallel)
    only_data_parallel: bool = False
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
    # a substitution-rule collection to search with instead of the
    # shipped ones (search/substitutions/*.json)
    substitution_json_path: Optional[str] = None
    # bf16 compute (and KV cache) over f32 master weights
    allow_mixed_precision: bool = False
    seed: int = 0
    device: str = "cuda"
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

    def __post_init__(self):
        dev = resolve_device(self.device)
        if self.workersPerNode == 0:
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
        its field, each in _UNPORTED_FLAGS raises NotImplementedError, and
        any other argument is skipped."""
        i = 0
        while i < len(argv):
            a = argv[i]
            if a in _UNPORTED_FLAGS:
                raise NotImplementedError(
                    f"{a}: {_UNPORTED_FLAGS[a]} is not ported to "
                    "flexflow_tpu_torch yet")
            if a in _SWITCHES:
                setattr(self, _SWITCHES[a], True)
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


# flag -> (field, type) of the reference's flags that take a value and
# whose field this package reads; a None type skips the value (the
# reference's print frequency, which nothing reads in either package)
_FLAGS = {
    "-e": ("epochs", int), "--epochs": ("epochs", int),
    "-b": ("batch_size", int), "--batch-size": ("batch_size", int),
    "--lr": ("learning_rate", float), "-lr": ("learning_rate", float),
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
    "--iterations-per-dispatch": ("iterations_per_dispatch", int),
}
# flags without a value that set a field to True
_SWITCHES = {
    "--fusion": "perform_fusion",
    "--only-data-parallel": "only_data_parallel",
    "--enable-parameter-parallel": "enable_parameter_parallel",
    "--enable-attribute-parallel": "enable_attribute_parallel",
    "--measured-search": "measure_operator_costs",
}
# the JAX package's flags whose features are not ported: what each sets
_UNPORTED_FLAGS = {
    "--wd": "the config's weight decay (read by no optimizer)",
    "-wd": "the config's weight decay (read by no optimizer)",
    "-ll:cpu": "CPU workers per node",
    "--nodes": "multi-node execution",
    "--enable-sequence-parallel": "sequence parallelism",
    "--profiling": "op profiling",
    "--import": "strategy import", "--import-strategy": "strategy import",
    "--memory-search": "the memory-aware search (search/memory_optimization.py)",
    "--overlap-backward-update": "overlapped gradient synchronisation",
    "--no-overlap-backward-update": "overlapped gradient synchronisation",
    "--fsdp-degree": "FSDP weight sharding",
    "--machine-model-version": "the topology-aware machine model (search/network.py)",
    "--simulator-workspace-size": "the search's simulator",
    "--iterations": "the config's iteration count",
}
