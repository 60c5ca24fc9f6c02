"""MCMC (simulated annealing) strategy search + task-graph simulation.

The PyTorch counterpart of flexflow_tpu/search/mcmc.py, the same search
and simulation (host Python over the same cost model, so both packages
give the same costs), a re-implementation of the reference's legacy
MLSys'19 search
(FFModel::mcmc_optimize, src/runtime/model.cc:3285: random per-op
ParallelConfig rewrites accepted with probability exp(-alpha·Δ)) and of the
event-driven runtime simulation it scores with
(Simulator::simulate_runtime, src/runtime/simulator.cc:815-1000: per-op-shard
fwd+bwd SimTasks + comm tasks, list-scheduled onto per-device timelines).
Kept for parity and as a fallback when the DP search's graph-split
preconditions don't hold.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple

from ..pcg.graph import Graph
from ..pcg.machine_view import MachineResource, MachineView, enumerate_machine_views
from ..pcg.op import PCGOp
from .cost_model import CostModel


def simulate_runtime(
    graph: Graph,
    views: Dict[int, MachineView],
    cost_model: CostModel,
    *,
    overlap_backward_update: Optional[bool] = None,
) -> float:
    """List-schedule fwd+bwd (+weight sync) task graph onto per-device
    timelines (reference: simulator.cc:822 simulate_runtime).

    Simplification vs the reference: one task per op per pass covering its
    whole view (per-shard tasks run concurrently on their devices anyway
    under SPMD), comm folded into task start via xfer estimates.

    overlap_backward_update (None = follow the cost model's flag) models
    the JAX package's overlapped executor schedule (its
    set_overlap_grad_sync): each STATICALLY overlappable weight-grad sync
    (analysis/collectives.overlappable_grad_syncs) runs on a comm channel
    concurrent with the compute timeline — it starts when the producing
    op's backward finishes (and the channel is free; collectives
    serialize on the wire) and only extends the makespan past the compute
    end. Non-overlappable syncs stay serial, exactly as executed.
    """
    if overlap_backward_update is None:
        overlap_backward_update = getattr(
            cost_model, "overlap_backward_update", False
        )
    machine = cost_model.machine
    dev_free: Dict[int, float] = {}
    ready_fwd: Dict[int, float] = {}  # tensor guid -> time available

    topo = graph.topo_order()
    prod = graph.producers()

    def run_task(view: MachineView, start_lb: float, duration: float) -> float:
        ids = view.device_ids()
        start = max([start_lb] + [dev_free.get(d, 0.0) for d in ids])
        end = start + duration
        for d in ids:
            dev_free[d] = end
        return end

    # forward
    fwd_end: Dict[int, float] = {}
    for op in topo:
        view = views[op.guid]
        cm = cost_model.measure_operator_cost(op, view)
        lb = 0.0
        flows = []
        for t in op.inputs:
            p = prod.get(t.guid)
            if p is None:
                continue
            src_view = views[p[0].guid]
            lb = max(
                lb,
                ready_fwd.get(t.guid, 0.0)
                + cost_model.estimate_xfer_cost(t, src_view, view),
            )
            flows.append((t, src_view, view))
        if len(flows) > 1:
            # an op's input transfers overlap in time — price link sharing
            # (reference: simulator task overlap over EnhancedMachineModel
            # comm devices; zero on flat machines)
            lb += cost_model.concurrent_xfer_penalty(flows)
        dur = cm.forward_time
        if op.is_parallel_op:
            dur += cost_model.parallel_op_cost(op)
        end = run_task(view, lb, dur)
        fwd_end[op.guid] = end
        for t in op.outputs:
            ready_fwd[t.guid] = end

    # backward (reverse topo); grad of op ready when all consumers' bwd done
    bwd_end: Dict[int, float] = {}
    makespan = max(fwd_end.values()) if fwd_end else 0.0
    consumers: Dict[int, List[PCGOp]] = {}
    for op in topo:
        for t in op.inputs:
            p = prod.get(t.guid)
            if p is not None:
                consumers.setdefault(p[0].guid, []).append(op)
    overlappable: set = set()
    if overlap_backward_update:
        from ..analysis.collectives import overlappable_grad_syncs

        overlappable = overlappable_grad_syncs(graph)
    comm_free = 0.0  # the comm channel: overlapped syncs serialize here
    for op in reversed(topo):
        view = views[op.guid]
        cm = cost_model.measure_operator_cost(op, view)
        lb = makespan if not consumers.get(op.guid) else 0.0
        grad_flows = []
        flow_keys = set()  # (consumer, tensor) dedupe: consumers holds one
        # entry PER consumed input, and a consumer reading two outputs of
        # this op is still one gradient transfer per tensor
        for c in consumers.get(op.guid, []):
            lb = max(lb, bwd_end.get(c.guid, makespan))
            for t in op.outputs:
                if any(x.guid == t.guid for x in c.inputs) and \
                        (c.guid, t.guid) not in flow_keys:
                    flow_keys.add((c.guid, t.guid))
                    grad_flows.append((t, views[c.guid], view))
        if len(grad_flows) > 1:
            # gradients from several consumers arrive simultaneously
            lb += cost_model.concurrent_xfer_penalty(grad_flows)
        dur = cm.backward_time
        if op.is_parallel_op:
            dur += cost_model.parallel_op_cost(op)
        end = run_task(view, lb, dur)
        # weight sync (allreduce) after wgrad: overlappable syncs ride
        # the comm channel concurrent with later backward tasks; the
        # rest (and every sync when overlap is off) stay serial
        if cm.sync_time > 0:
            if op.guid in overlappable:
                comm_free = max(comm_free, end) + cm.sync_time
            else:
                end = run_task(view, end, cm.sync_time)
        bwd_end[op.guid] = end

    total = max(dev_free.values()) if dev_free else 0.0
    return max(total, comm_free)


class MCMCSearch:
    """reference: model.cc:3285 mcmc_optimize / :3260 rewrite."""

    def __init__(
        self,
        cost_model: CostModel,
        *,
        alpha: float = 0.05,
        seed: int = 0,
        trajectory=None,
    ):
        self.cost_model = cost_model
        self.alpha = alpha
        self.rng = random.Random(seed)
        # obs.SearchTrajectory: records one entry per proposal (proposed
        # op + view, simulated cost, accept/reject) so the search is
        # explainable after the fact (obs/trajectory.py)
        self.trajectory = trajectory

    def _valid_views(self, op: PCGOp, machine) -> List[MachineView]:
        degree = op.outputs[0].get_total_degree() if op.outputs else 1
        views = [
            v
            for v in enumerate_machine_views(machine.num_nodes, machine.workers_per_node)
            if v.num_parts() == degree
        ]
        return views or [MachineView(start_device_id=0, dim=(1,), stride=(1,))]

    def data_parallel_start(self, graph: Graph) -> Dict[int, MachineView]:
        """reference: start from data-parallel config
        (get_basic_data_parallel_config, model.h:250)."""
        machine = self.cost_model.machine
        out = {}
        for op in graph.ops:
            vs = self._valid_views(op, machine)
            out[op.guid] = vs[0]
        return out

    def optimize(
        self,
        graph: Graph,
        budget: int = 100,
        start: Optional[Dict[int, MachineView]] = None,
        use_native: bool = True,
    ) -> Tuple[Dict[int, MachineView], float]:
        machine = self.cost_model.machine
        # slice-loss survivability bias (search/survivability.py): on
        # hierarchical machines with the penalty armed, every proposal's
        # simulated runtime is scaled by the cross-slice-sharded weight
        # fraction — which also forces the Python annealer (the native
        # one costs proposals in C++ and cannot see the bias)
        pen = getattr(self.cost_model, "survivability_penalty", 0.0)
        biased = bool(pen) and machine.num_nodes > 1
        if biased:
            from .survivability import survivability_cost_factor

            def cost_of(vs):
                return simulate_runtime(
                    graph, vs, self.cost_model
                ) * survivability_cost_factor(graph, vs, self.cost_model)
        else:
            def cost_of(vs):
                return simulate_runtime(graph, vs, self.cost_model)
        if use_native and not biased:
            result = self._optimize_native(graph, budget, start)
            if result is not None:
                if self.trajectory is not None:
                    # the native annealer iterates in C++: no per-proposal
                    # visibility, record the summary instead
                    self.trajectory.event("mcmc_native", cost=result[1],
                                          budget=budget)
                return result
        views = dict(start) if start else self.data_parallel_start(graph)
        cur = cost_of(views)
        best_views, best = dict(views), cur
        traj = self.trajectory
        if traj is not None:
            traj.event("search_begin", engine="mcmc", cost=cur,
                       budget=budget, ops=len(graph.ops))
        ops = list(graph.ops)
        for i in range(budget):
            # rewrite: random op -> random valid view (model.cc:3260)
            op = self.rng.choice(ops)
            cands = self._valid_views(op, machine)
            nxt = dict(views)
            proposed = self.rng.choice(cands)
            nxt[op.guid] = proposed
            c = cost_of(nxt)
            delta = c - cur
            accept = (delta < 0
                      or self.rng.random() < math.exp(-self.alpha * delta * 1e6))
            if traj is not None:
                traj.event("mcmc_iter", iter=i, op=op.name,
                           view=repr(proposed), cost=c, current=cur,
                           best=best, delta=delta, accept=accept)
            if accept:
                views, cur = nxt, c
                if cur < best:
                    best_views, best = dict(views), cur
        if traj is not None:
            traj.event("search_end", engine="mcmc", cost=best)
        return best_views, best

    def _optimize_native(self, graph, budget, start):
        """C++ fast path (native/src/simulator.cc): flatten once, anneal in
        native code. Returns None when the native lib is unavailable (no
        g++, or the build failed): optimize() then runs the Python
        annealer, which records its own search_begin/mcmc_iter events
        where the native one records "mcmc_native"."""
        from .. import native

        if not native.available():
            return None
        from ..native.simulator import NativeSimulator
        machine = self.cost_model.machine
        ops = graph.topo_order()
        views_per_op = {op.guid: self._valid_views(op, machine) for op in ops}
        sim = NativeSimulator(graph, self.cost_model, views_per_op)
        slots = []
        for op in ops:
            if start and op.guid in start:
                cands = views_per_op[op.guid]
                h = start[op.guid].hash()
                slot = next((i for i, v in enumerate(cands) if v.hash() == h), 0)
            else:
                slot = 0
            slots.append(slot)
        views, cost = sim.mcmc(
            slots, budget, alpha=self.alpha, seed=self.rng.randrange(1 << 30)
        )
        return views, cost
