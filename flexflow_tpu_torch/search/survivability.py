"""Slice-loss survivability of a parallelization strategy.

The PyTorch counterpart of flexflow_tpu/search/survivability.py. On
multi-node machines the common failure is losing a whole node (a slice:
one failure domain) at once. Whether that is cheap or catastrophic is a
property of the searched strategy:

  * **survivable** -- only data-parallel replicas cross the node
    boundary: every weight shard set is complete within each node, so
    losing one just drops replicas;
  * **not survivable** -- model or FSDP weight shards cross nodes: the
    lost node held shard pieces that exist nowhere else.

This module classifies a (graph, views) strategy statically and
supplies the cost penalty (`CostModel.survivability_penalty`) that
biases the DP search toward survivable strategies on multi-node
machines -- a bias, not a hard constraint. compile() sets the penalty
as the JAX package's default does: 0.25 on a machine of more than one
node, 0 otherwise.

The per-slice check assumes the canonical device order: the data axis
is outermost, so each data replica occupies a contiguous device block.
Strategies outside that layout are classified conservatively (not
survivable).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


# statuses, roughly from safest to worst
STATELESS = "stateless"            # op has no weights — nothing to lose
CONFINED = "confined"              # view spans a single slice
REPLICATED = "replicated"          # weights replicated: pure DP across slices
SURVIVABLE_SHARDED = "survivable_sharded"  # shard sets complete per slice
CROSS_SLICE_SHARDED = "cross_slice_sharded"  # shards span the boundary
UNPLACED = "unplaced"              # no machine view recorded for the op


@dataclasses.dataclass(frozen=True)
class OpSurvivability:
    guid: int
    name: str
    status: str
    detail: str = ""
    weight_bytes: int = 0
    partition_degree: int = 1
    spanned_slices: Tuple[int, ...] = ()
    per_slice_devices: Tuple[int, ...] = ()

    @property
    def survivable(self) -> bool:
        return self.status != CROSS_SLICE_SHARDED


@dataclasses.dataclass(frozen=True)
class StrategySurvivability:
    ops: Tuple[OpSurvivability, ...]
    num_slices: int

    @property
    def survivable(self) -> bool:
        return all(o.survivable for o in self.ops)

    @property
    def unsurvivable_ops(self) -> Tuple[OpSurvivability, ...]:
        return tuple(o for o in self.ops if not o.survivable)

    @property
    def spans_slices(self) -> bool:
        return any(len(o.spanned_slices) > 1 for o in self.ops)

    @property
    def total_weight_bytes(self) -> int:
        return sum(o.weight_bytes for o in self.ops)

    @property
    def unsurvivable_weight_bytes(self) -> int:
        return sum(o.weight_bytes for o in self.unsurvivable_ops)


def weight_bytes(op) -> int:
    """Logical (unsharded) parameter bytes held by `op`."""
    total = 0
    for w in getattr(op, "weights", ()) or ():
        n = 1
        for s in w.material_shape():
            n *= s
        total += n * w.data_type.size
    return total


def weight_partition_degree(op) -> int:
    """How many distinct shard pieces the op's weights are split into:
    the max over its weights of the product of non-replica dim degrees.
    1 = fully replicated (pure DP); >1 = model/FSDP-sharded (weight
    sharding — parallel/weight_sharding.py — records its degrees on
    these same dims, so FSDP is caught by the same rule)."""
    best = 1
    for w in getattr(op, "weights", ()) or ():
        d = 1
        for dim in w.dims:
            if not dim.is_replica_dim:
                d *= dim.degree
        best = max(best, d)
    return best


def _op_label(op) -> str:
    name = getattr(op, "name", None)
    if name:
        return str(name)
    ot = getattr(op, "op_type", None)
    return getattr(ot, "name", str(ot))


def op_survivability(op, view, slice_of) -> OpSurvivability:
    """Classify one op's placement. `slice_of(device_id)` maps a flat
    device id to its fault-domain index (machine.node_of, or
    FaultDomainMap.slice_of)."""
    guid = getattr(op, "guid", -1)
    label = _op_label(op)
    wbytes = weight_bytes(op)
    if view is None:
        return OpSurvivability(guid, label, UNPLACED, weight_bytes=wbytes)
    per: Dict[int, int] = {}
    for d in view.device_ids():
        s = slice_of(d)
        per[-1 if s is None else int(s)] = per.get(
            -1 if s is None else int(s), 0) + 1
    spanned = tuple(sorted(per))
    counts = tuple(per[s] for s in spanned)
    if len(spanned) <= 1:
        return OpSurvivability(guid, label, CONFINED, weight_bytes=wbytes,
                               spanned_slices=spanned,
                               per_slice_devices=counts)
    if wbytes == 0:
        return OpSurvivability(guid, label, STATELESS,
                               spanned_slices=spanned,
                               per_slice_devices=counts)
    p = weight_partition_degree(op)
    if p == 1:
        return OpSurvivability(
            guid, label, REPLICATED, weight_bytes=wbytes,
            partition_degree=1, spanned_slices=spanned,
            per_slice_devices=counts,
            detail="weights replicated: only DP replicas cross slices",
        )
    if all(c % p == 0 for c in counts):
        return OpSurvivability(
            guid, label, SURVIVABLE_SHARDED, weight_bytes=wbytes,
            partition_degree=p, spanned_slices=spanned,
            per_slice_devices=counts,
            detail=f"{p}-way weight shard sets complete within each slice",
        )
    return OpSurvivability(
        guid, label, CROSS_SLICE_SHARDED, weight_bytes=wbytes,
        partition_degree=p, spanned_slices=spanned,
        per_slice_devices=counts,
        detail=(
            f"weights sharded {p}-way across slices {list(spanned)} "
            f"(per-slice devices {list(counts)}): a lost slice takes "
            "shard pieces that exist nowhere else"
        ),
    )


def strategy_survivability(graph, views: Optional[Dict], *,
                           machine=None,
                           fault_domains=None) -> StrategySurvivability:
    """Classify every op of a strategy. Provide either a MachineModel
    (slices = machine nodes) or a FaultDomainMap; machine wins when both
    are given (it is what the search placed against)."""
    if machine is not None:
        n_slices = machine.num_nodes
        slice_of = machine.node_of
    elif fault_domains is not None:
        n_slices = fault_domains.num_slices
        slice_of = fault_domains.slice_of
    else:
        raise ValueError("need a machine model or a FaultDomainMap")
    views = views or {}
    out: List[OpSurvivability] = []
    for op in graph.topo_order():
        v = views.get(op.guid)
        if v is None:  # same fallback as analysis/collectives._view_of
            v = getattr(op, "machine_view", None)
        out.append(op_survivability(op, v, slice_of))
    return StrategySurvivability(ops=tuple(out), num_slices=n_slices)


def survivability_cost_factor(graph, views: Optional[Dict],
                              cost_model) -> float:
    """Multiplicative penalty the searches apply to a candidate's cost:
    1.0 for survivable strategies (or single-slice machines, or a zero
    penalty knob), else 1 + penalty * (fraction of weight bytes whose
    shards cross the slice boundary). Proportional, so sharding ONE
    small embedding across slices costs less bias than sharding the
    whole trunk — the search trades failure-domain hygiene against real
    step time instead of forbidding anything."""
    pen = float(getattr(cost_model, "survivability_penalty", 0.0) or 0.0)
    machine = getattr(cost_model, "machine", None)
    if pen <= 0.0 or machine is None or machine.num_nodes <= 1:
        return 1.0
    s = strategy_survivability(graph, views, machine=machine)
    total = s.total_weight_bytes
    if total <= 0 or s.survivable:
        return 1.0
    return 1.0 + pen * (s.unsurvivable_weight_bytes / float(total))
