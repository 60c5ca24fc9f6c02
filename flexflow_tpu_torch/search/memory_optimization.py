"""Per-device memory of a placed strategy.

The part of flexflow_tpu/search/memory_optimization.py the port's
compile() needs: `measure_memory` (reference: the Simulator's memory
accounting per device, memory_optimization.h:45-100 MemoryUsage) and
`weight_bytes_multiplier`. compile() checks the searched winner's
per-device training memory against the device's capacity with them. The
memory-aware search itself (the lambda loop, `--memory-search`,
graph_optimize_with_memory) is not ported.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

from ..pcg.graph import Graph
from ..pcg.machine_view import MachineView
from .cost_model import CostModel


@dataclasses.dataclass
class MemoryUsage:
    """reference: memory_optimization.h:45-100 MemoryUsage"""

    num_devices: int
    per_device_bytes: Dict[int, int]

    @property
    def max_bytes(self) -> int:
        return max(self.per_device_bytes.values(), default=0)


def weight_bytes_multiplier(
    optimizer=None, grad_bytes_ratio: float = 1.0, *, warn: bool = True
) -> float:
    """How many weight-sized allocations training holds per parameter:
    the master weight itself, one gradient buffer (half-width under the
    bf16-grad recipe: grad_bytes_ratio 0.5), and the optimizer's state
    slots (SGD-momentum 1, Adam 2: Optimizer.state_slots_per_weight).
    An optimizer without the hook counts 0 slots, with a warning when
    there are weight bytes to under-count (`warn`)."""
    slots = 0
    if optimizer is not None:
        get = getattr(optimizer, "state_slots_per_weight", None)
        if get is None and warn:
            warnings.warn(
                f"optimizer {type(optimizer).__name__!r} does not report "
                "state_slots_per_weight(); assuming 0 optimizer state "
                "slots -- per-device memory may be under-counted. Add a "
                "state_slots_per_weight() method returning the number of "
                "weight-sized state buffers (SGD-momentum 1, Adam 2).",
                stacklevel=2,
            )
        slots = get() if get is not None else 0
    return 1.0 + grad_bytes_ratio + slots


def measure_memory(
    graph: Graph,
    views: Dict[int, MachineView],
    cost_model: CostModel,
    *,
    train: bool = False,
    optimizer=None,
    grad_bytes_ratio: float = 1.0,
) -> MemoryUsage:
    """Per-device memory of a placed strategy: each op's shard memory
    (inputs+outputs+weights, CostMetrics) lands on its view's devices.
    With `train=True` every weight byte is multiplied by
    `weight_bytes_multiplier(optimizer, grad_bytes_ratio)`, so gradients
    and optimizer slots -- which live for the whole step on the same
    devices as the weight shard -- count against the budget."""
    has_weights = any(op.weights for op in graph.ops)
    wmul = (weight_bytes_multiplier(optimizer, grad_bytes_ratio,
                                    warn=has_weights)
            if train else 1.0)
    per_dev: Dict[int, int] = {}
    for op in graph.ops:
        view = views.get(op.guid)
        if view is None:
            continue
        cm = cost_model.measure_operator_cost(op, view)
        # inputs/outputs are activations (the backward residual stash);
        # weights get the training multiplier
        share = int(
            cm.inputs_memory + cm.outputs_memory
            + cm.weights_memory * wmul
        )
        for d in view.device_ids():
            per_dev[d] = per_dev.get(d, 0) + share
    return MemoryUsage(num_devices=len(per_dev), per_device_bytes=per_dev)
