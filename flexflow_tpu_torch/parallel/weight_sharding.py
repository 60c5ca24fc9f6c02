"""FSDP/ZeRO weight sharding as a parallel op of the PCG.

The PyTorch counterpart of flexflow_tpu/parallel/weight_sharding.py: the
graph rewrites the substitutions call (`insert_weight_shard`,
`shardable_dim`, `WeightShardParams`). A WeightShard node
(``OperatorType.OP_WEIGHT_SHARD``) is inserted after a compute op's
output and declares that the producing op's weights -- and so its
gradient buffers and optimizer slots -- are sharded ``shard_degree``
ways. The node is the identity on the activation path; the storage
semantics live in the target op's weight ParallelDims, whose degrees
this module sets. The search prices the all-gather-on-use and the
gradient reduce-scatter (search/cost_model.py parallel_op_cost). On a
mesh with room for the fsdp degree the lowering (parallel/strategies.py
assign_mesh_axes) keeps the nodes and their degree, and the mesh
executor (parallel/executor.py MeshExecutor) holds each target weight
sharded over the ``fsdp`` axis, gathers it where its op reads it and
reduce-scatters its gradient; where the mesh has no room (one device)
the lowering backs the nodes out and the weights stay whole.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..ff_types import OperatorType
from ..pcg.graph import Graph
from ..pcg.op import PCGOp
from ..pcg.parallel_tensor import ParallelTensor

# the canonical mesh axis weight shards map onto (parallel/mesh.AXIS_NAMES)
FSDP_AXIS = "fsdp"


@dataclasses.dataclass(frozen=True)
class WeightShardParams:
    """PCG params record for OP_WEIGHT_SHARD.

    shard_degree: how many ways the target op's parameters (and optimizer
    state slots) are sharded over the ``fsdp`` mesh axis. The activation
    flowing through the node is untouched.
    """

    shard_degree: int


def weight_shard_target(op: PCGOp) -> Optional[PCGOp]:
    """The compute op whose weights a WeightShard node shards: the
    producer of the node's activation input, skipping through any
    parallel ops a later rewrite slid in between (a column-parallel
    substitution inserts its Combine after the target's output, rerouting
    the WeightShard's input through it — the weights still belong to the
    compute op underneath). None when no weight-carrying producer exists
    (a malformed insertion — FFA207 flags it)."""
    if op.op_type != OperatorType.OP_WEIGHT_SHARD or not op.inputs:
        return None
    t = op.inputs[0]
    for _ in range(8):  # bounded: parallel-op chains are short
        target = t.owner_op
        if target is None:
            return None
        if not getattr(target, "is_parallel_op", False):
            break
        if not target.inputs:
            return None
        t = target.inputs[0]
    if target is None or not getattr(target, "weights", None):
        return None
    return target


def shardable_dim(w: ParallelTensor, degree: int) -> Optional[int]:
    """First dim of weight `w` that can shard `degree`-ways: divisible,
    currently unsharded. None when the weight must stay replicated (its
    gradient then still all-reduces — partial sharding is legal ZeRO)."""
    for i, d in enumerate(w.dims):
        if d.degree == 1 and not d.is_replica_dim and d.size % degree == 0:
            return i
    return None


def shard_op_weights(op: PCGOp, degree: int,
                     axis_idx: int = -1) -> List[Tuple[int, int]]:
    """Shard `op`'s weights `degree`-ways in place (one dim per weight,
    the first divisible one). Returns [(weight_idx, dim_idx), ...] of the
    dims actually sharded. Raises ValueError when the op has no weights,
    already carries sharded weight dims (FSDP does not compose with TP on
    the same weight in round 1), or nothing divides."""
    if degree < 2:
        raise ValueError(f"weight shard degree must be >= 2, got {degree}")
    if not op.weights:
        raise ValueError(f"op {op.name} carries no weights to shard")
    if any(d.degree > 1 for w in op.weights for d in w.dims):
        raise ValueError(
            f"op {op.name} already has sharded weight dims; FSDP does not "
            "stack on tensor-parallel weight sharding"
        )
    sharded: List[Tuple[int, int]] = []
    for wi, w in enumerate(op.weights):
        di = shardable_dim(w, degree)
        if di is None:
            continue  # e.g. a small bias: stays replicated, still correct
        w.dims[di].degree = degree
        w.dims[di].parallel_idx = axis_idx
        sharded.append((wi, di))
    if not sharded:
        raise ValueError(
            f"op {op.name}: no weight dim divisible by {degree}"
        )
    return sharded


def unshard_op_weights(op: PCGOp) -> None:
    """Undo shard_op_weights: every weight dim back to degree 1."""
    for w in op.weights:
        for d in w.dims:
            if not d.is_replica_dim:
                d.degree = 1
                d.parallel_idx = -1


def make_weight_shard_op(target: PCGOp, degree: int) -> PCGOp:
    """Build the WeightShard node for `target` (identity on the target's
    first output; the caller wires it into the graph). The output tensor
    copies the input's dims verbatim, so the sharding/structure analyses
    see an exact pass-through."""
    in_t = target.outputs[0]
    op = PCGOp(
        OperatorType.OP_WEIGHT_SHARD,
        WeightShardParams(shard_degree=degree),
        [in_t],
        name=f"weight_shard_{target.name}",
        layer_guid=target.layer_guid,
    )
    out = ParallelTensor(
        dims=[dataclasses.replace(d) for d in in_t.dims],
        data_type=in_t.data_type,
    )
    out.owner_op = op
    op.outputs.append(out)
    return op


def insert_weight_shard(graph: Graph, target: PCGOp, degree: int,
                        axis_idx: int = -1) -> PCGOp:
    """Shard `target`'s weights and insert the WeightShard node after its
    first output, rerouting all consumers through the node. Mutates
    `graph` in place; raises ValueError when the target is ineligible."""
    if not target.outputs:
        raise ValueError(f"op {target.name} has no output to thread "
                         "a WeightShard node through")
    shard_op_weights(target, degree, axis_idx=axis_idx)
    ws = make_weight_shard_op(target, degree)
    old_t = target.outputs[0]
    new_t = ws.outputs[0]
    for op in graph.ops:
        if op is ws:
            continue
        for i, t in enumerate(op.inputs):
            if t.guid == old_t.guid:
                op.inputs[i] = new_t
    graph.add_op(ws)
    return ws


def sharded_weight_records(graph: Graph) -> Dict[int, Tuple[PCGOp, int]]:
    """Map of weight-tensor guid -> (WeightShard node, shard_degree) for
    every weight a WeightShard node in `graph` targets. The single source
    of truth the lowering (strategies.assign_mesh_axes), the analyses and
    strategy_io use to tell FSDP weight degrees from tensor-parallel
    ones."""
    out: Dict[int, Tuple[PCGOp, int]] = {}
    for op in graph.ops:
        if op.op_type != OperatorType.OP_WEIGHT_SHARD:
            continue
        target = weight_shard_target(op)
        if target is None:
            continue
        for w in target.weights:
            out[w.guid] = (op, op.params.shard_degree)
    return out


def fsdp_degree_of(graph: Graph) -> int:
    """The graph's weight-shard degree (1 = no FSDP). When WeightShard
    nodes disagree, the largest degree wins and the lowering demotes
    non-matching weight dims to replicated (the same demotion rule every
    other mismatched degree gets in assign_mesh_axes)."""
    deg = 1
    for op in graph.ops:
        if op.op_type == OperatorType.OP_WEIGHT_SHARD:
            deg = max(deg, op.params.shard_degree)
    return deg


def shard_target_weight_bytes(op: PCGOp) -> int:
    """Total parameter bytes the WeightShard node's collectives move: the
    target op's full (unsharded) weight footprint. Used by the cost model
    (all-gather × 2 + reduce-scatter per step) and the collective-bytes
    telemetry."""
    target = weight_shard_target(op)
    if target is None:
        return 0
    n = 0
    for w in target.weights:
        v = 1
        for s in w.material_shape():
            v *= int(s)
        n += v * w.data_type.size
    return n


def apply_weight_sharding(graph: Graph, degree: int, axis_idx: int) -> int:
    """Manual-strategy pass (config.fsdp_degree, the no-search analog of
    strategies.apply_data_parallel): shard every eligible compute op's
    weights `degree`-ways over the mesh axis at `axis_idx` and insert the
    WeightShard nodes. Ops with no weights, with already-sharded weights
    (tensor parallelism owns them), or with nothing divisible are left
    replicated. Returns the number of ops sharded."""
    if degree <= 1:
        return 0
    count = 0
    for op in list(graph.ops):
        if op.is_parallel_op or not op.weights or not op.outputs:
            continue
        if any(d.degree > 1 for w in op.weights for d in w.dims):
            continue
        if all(shardable_dim(w, degree) is None for w in op.weights):
            continue
        insert_weight_shard(graph, op, degree, axis_idx=axis_idx)
        count += 1
    return count
