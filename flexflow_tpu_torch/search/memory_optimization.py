"""Memory-aware multi-objective strategy search.

The PyTorch counterpart of flexflow_tpu/search/memory_optimization.py
(reference: src/runtime/memory_optimization.cc + the lambda
binary-search loop in Graph::graph_optimize_task, graph.cc:2060-2130):
`measure_memory` charges each placed op's shard memory to its view's
devices (weights times the training multiplier,
`weight_bytes_multiplier`), and `graph_optimize_with_memory` optimizes
`run_time + lambda * per_device_memory` instead of pure run time,
searching lambda until the best strategy fits the per-device budget
(`--memory-search`, `FFConfig.device_mem`). compile() also checks every
searched winner's training memory against the device's capacity with
`measure_memory`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Tuple

from ..pcg.graph import Graph
from ..pcg.machine_view import MachineResource, MachineView
from .cost_model import CostModel
from .dp_search import GraphCostResult, SearchHelper
from .substitution import GraphSearchHelper


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


class MemorySearchHelper(SearchHelper):
    """SearchHelper whose node cost includes lambda * memory (reference:
    GraphCostResultWithMemory, graph.h:121)."""

    def __init__(self, cost_model: CostModel, mem_lambda: float = 0.0,
                 weight_mult: float = 1.0, **kw):
        super().__init__(cost_model, **kw)
        self.mem_lambda = mem_lambda
        # same grads+slots multiplier measure_memory applies, so the
        # lambda pressure and the feasibility check price the same bytes
        self.weight_mult = weight_mult

    def node_cost(self, op, view, bounds) -> float:
        base = super().node_cost(op, view, bounds)
        if self.mem_lambda <= 0.0:
            return base
        cm = self.cost_model.measure_operator_cost(op, view)
        mem = (cm.inputs_memory + cm.outputs_memory
               + cm.weights_memory * self.weight_mult)
        return base + self.mem_lambda * mem


def graph_optimize_with_memory(
    graph: Graph,
    cost_model: CostModel,
    res: MachineResource,
    xfers,
    *,
    device_mem_budget: int,
    alpha: float = 1.2,
    budget: int = 10,
    lambda_iters: int = 8,
    train: bool = False,
    optimizer=None,
    grad_bytes_ratio: float = 1.0,
    trajectory=None,
) -> Tuple[Graph, GraphCostResult, MemoryUsage, float]:
    """Binary search over lambda (reference: graph.cc:2071-2128
    try_one_lambda loop): lambda=0 gives the fastest strategy; if it
    overflows the budget, raise lambda until memory fits, then tighten."""

    from .mcmc import simulate_runtime

    wmul = (weight_bytes_multiplier(optimizer, grad_bytes_ratio,
                                    warn=any(op.weights for op in graph.ops))
            if train else 1.0)

    def run(lam: float):
        sh = MemorySearchHelper(cost_model, mem_lambda=lam,
                                weight_mult=wmul)
        gsh = GraphSearchHelper(sh, xfers, alpha=alpha, budget=budget,
                                trajectory=trajectory)
        g, r = gsh.graph_optimize(graph, res)
        mem = measure_memory(g, r.views, cost_model, train=train,
                             optimizer=optimizer,
                             grad_bytes_ratio=grad_bytes_ratio)
        # r.cost is lambda-weighted — recompute the comparable pure runtime
        real = simulate_runtime(g, r.views, cost_model)
        if trajectory is not None:
            trajectory.event("memory_lambda", mem_lambda=lam,
                             cost=real, max_bytes=mem.max_bytes)
        return g, GraphCostResult(real, r.views), mem

    best = run(0.0)
    if best[2].max_bytes <= device_mem_budget:
        return (*best, 0.0)

    lo, hi = 0.0, 1e-6  # seconds per byte; grow hi until feasible
    feasible = None
    for _ in range(lambda_iters):
        cand = run(hi)
        if cand[2].max_bytes <= device_mem_budget:
            feasible = (cand, hi)
            break
        hi *= 16.0
    if feasible is None:
        return (*best, 0.0)  # infeasible — return fastest (caller warns)
    # tighten between lo (infeasible) and hi (feasible)
    best_feasible, best_lambda = feasible
    for _ in range(lambda_iters):
        mid = (lo + hi) / 2.0
        cand = run(mid)
        if cand[2].max_bytes <= device_mem_budget:
            hi = mid
            if cand[1].cost <= best_feasible[1].cost:
                best_feasible, best_lambda = cand, mid
        else:
            lo = mid
    return (*best_feasible, best_lambda)
