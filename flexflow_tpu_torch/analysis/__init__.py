"""Static PCG analysis framework.

The PyTorch counterpart of flexflow_tpu/analysis/__init__.py.

Whole-graph static analysis over the parallel computation graph with a
typed diagnostic model (`Diagnostic(severity, code, op_guid, message,
fix_hint)`) and composable passes:

  structure    — wiring/validity/acyclicity (backs Graph.check_correctness)
  sharding     — shape/dtype/degree re-derivation vs declared tensors
  collectives  — implied-collective consistency (order, axes, views,
                 all-to-all coverage)
  precision    — FFA7xx mixed-precision flow: boundary dtype mismatch,
                 low-precision accumulators, low-precision grad rings,
                 loss-scale range, static drift budget (precision.py)
  memory       — static per-device HBM-fit from material shapes
  perf         — FFA5xx performance lints: overlap-discount soundness,
                 padding/roofline, node-boundary collective cost (perf.py)
  schedule     — overlap race/aliasing over the executor's modelled
                 reduce-scatter/update/all-gather step (schedule.py)
  rules        — substitution-rule soundness (substitution_lint)

Entry points: `analyze_graph` (a graph + optional views), `analyze_model`
(a compiled FFModel), `analyze_rules_path` (a substitution JSON), and the
CLI `python -m flexflow_tpu_torch.analysis`. The analyzer is wired into
`compile()` through `search.register_strategy_validator`, and into
training through `fit(lint="error"|"warn"|"off")`.

Design goal: reject malformed strategies, deadlocking collective
schedules, and OOM-by-construction machine views *before any device time
is spent*. The mesh executor's overlapped gradient sync describes its
step through `overlap_schedule()`, which the schedule pass audits on a
live model; on one device, or at data degree 1, the sync is inert and
the hook returns None.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from .collectives import collective_diagnostics  # noqa: F401
from .diagnostics import (  # noqa: F401
    AnalysisReport,
    Diagnostic,
    Severity,
    StaticAnalysisError,
)
from .memory import (  # noqa: F401
    estimate_per_device_bytes,
    memory_diagnostics,
    training_weight_multiplier,
)
from .perf import diagnostics_by_op, perf_diagnostics  # noqa: F401
from .precision import (  # noqa: F401
    DEFAULT_DRIFT_BUDGET,
    annotate_graph_precision,
    estimate_drift,
    precision_diagnostics,
    register_precision_rule,
)
from .swap_lint import lint_swap_candidate  # noqa: F401
from .schedule import (  # noqa: F401
    OverlapSchedule,
    ScheduleTask,
    build_overlap_schedule,
    schedule_race_diagnostics,
)
from .sharding import sharding_diagnostics  # noqa: F401
from .structure import graph_is_wellformed, structural_diagnostics  # noqa: F401
from .substitution_lint import (  # noqa: F401
    analyze_rules_path,
    lint_rule,
    lint_rules,
)

ALL_PASSES = ("structure", "sharding", "collectives", "precision",
              "memory", "perf", "schedule")


def analyze_graph(
    graph,
    views: Optional[Dict] = None,
    num_devices: Optional[int] = None,
    *,
    hbm_bytes: Optional[int] = None,
    optimizer=None,
    train: bool = True,
    grad_bytes_ratio: float = 1.0,
    passes: Sequence[str] = ALL_PASSES,
    cost_model=None,
    executor=None,
    drift_budget: Optional[float] = None,
    grad_dtype=None,
    step_guard=None,
) -> AnalysisReport:
    """Run the selected analysis passes over a PCG.

    views: op guid -> MachineView (a search result's `.views`); ops fall
    back to their own `machine_view`, then to whole-mesh placement.
    num_devices: live device count (enables view-bounds and degree-
    product checks). hbm_bytes: per-device budget for the memory pass.
    cost_model: the search's cost oracle — enables the "perf" pass's
    overlap-discount audit (FFA501) and its machine model feeds the
    roofline/topology lints (FFA503/504). executor: a live PCGExecutor
    whose ``overlap_schedule()`` hook the "schedule" pass audits for
    FFA502 races (skipped when absent or when it returns None, as the
    port's one-device executor does).
    drift_budget/grad_dtype/step_guard: the "precision" pass's context —
    the FFA705 budget (None = precision.DEFAULT_DRIFT_BUDGET), the
    gradient storage dtype (DT_BF16 under the AMP recipe; enables
    FFA703), and the StepGuardConfig whose loss-scale bounds FFA704
    checks against the compute dtype's dynamic range.
    """
    rep = AnalysisReport()
    if "structure" in passes:
        rep.extend(structural_diagnostics(graph))
        if not rep.ok:
            # downstream passes assume a well-formed graph; inference over
            # a dangling/cyclic graph would only produce noise
            return rep
    if "sharding" in passes:
        rep.extend(sharding_diagnostics(graph, num_devices=num_devices))
    if "collectives" in passes:
        rep.extend(collective_diagnostics(graph, views=views,
                                          num_devices=num_devices))
    if "precision" in passes:
        rep.extend(precision_diagnostics(
            graph, views=views, num_devices=num_devices,
            drift_budget=drift_budget, grad_dtype=grad_dtype,
            step_guard=step_guard,
        ))
    if "memory" in passes:
        mem_rep, _ = memory_diagnostics(
            graph, views=views, num_devices=num_devices or 1,
            hbm_bytes=hbm_bytes, train=train, optimizer=optimizer,
            grad_bytes_ratio=grad_bytes_ratio,
        )
        rep.extend(mem_rep)
    if "perf" in passes:
        rep.extend(perf_diagnostics(
            graph, views=views, cost_model=cost_model,
            num_devices=num_devices,
        ))
    if "schedule" in passes and executor is not None:
        sched = executor.overlap_schedule()
        if sched is not None:
            rep.extend(schedule_race_diagnostics(sched))
    return rep


def analyze_model(model, *, passes: Sequence[str] = ALL_PASSES,
                  hbm_bytes: Optional[int] = None) -> AnalysisReport:
    """Analyze a compiled FFModel: its (possibly searched) PCG, the
    searched machine views, the device count, the per-device memory
    budget (config.device_mem, else the cost model's chip capacity:
    80e9 bytes on the H100 spec), the search's cost model (perf pass),
    and the executor's overlapped step schedule (schedule pass).

    The device count is the one the strategy was searched for: the
    search machine's worker count when the model carries searched views,
    else 1. The port executes on one device and demotes a wider winner
    onto it (compile warns about that); the views are still the search's,
    so they are judged against the machine they address, as the JAX
    package's CLI judges a strategy searched for another machine."""
    graph = model.graph
    if graph is None:
        from ..runtime.verify import NotCompiledError

        raise NotCompiledError("analyze_model: call compile() first")
    cost_model = None
    try:
        cost_model = model._build_cost_model()
    except Exception as e:
        import logging

        logging.getLogger(__name__).warning(
            "analyze_model: no cost model (%s); skipping the overlap-"
            "discount and topology-cost checks", e)
    views = getattr(model, "searched_views", None)
    ndev = (cost_model.machine.num_workers
            if views and cost_model is not None else 1)
    if hbm_bytes is None:
        hbm_bytes = model.config.device_mem or None
        if hbm_bytes is None and cost_model is not None:
            hbm_bytes = cost_model.machine.chip.hbm_capacity
    from ..ff_types import DataType

    grad_dtype = (DataType.DT_BF16 if model._grad_bytes_ratio() < 1.0
                  else None)
    return analyze_graph(
        graph,
        views=views,
        num_devices=ndev,
        hbm_bytes=hbm_bytes,
        optimizer=model.optimizer,
        train=model._is_training_compile(),
        grad_bytes_ratio=model._grad_bytes_ratio(),
        passes=passes,
        cost_model=cost_model,
        executor=model.executor,
        drift_budget=getattr(model.config, "precision_drift_budget", None),
        grad_dtype=grad_dtype,
        step_guard=getattr(model.executor, "step_guard", None),
    )


def strategy_violations(graph, views, num_devices: int) -> list:
    """Adapter for the `search.register_strategy_validator` hook:
    ERROR-severity diagnostics as violation strings. The memory pass is
    excluded here (the hook has no budget context); compile-time memory
    vetting goes through compile's memory check / fit(lint=...)."""
    rep = analyze_graph(
        graph, views=views, num_devices=num_devices,
        passes=("structure", "sharding", "collectives", "precision"),
    )
    return [d.format() for d in rep.errors]
