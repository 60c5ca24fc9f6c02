"""Parallelization strategies applied to a PCG.

The PyTorch counterpart of flexflow_tpu/parallel/strategies.py. The
reference reaches a parallelized PCG either through the Unity search or
through `--only-data-parallel` lowering (model.cc:2637-2642). These
passes assign degrees/parallel_idx to ParallelTensor dims in place;
`assign_mesh_axes` lowers a searched PCG to the device axes a machine of
`max_devices` devices can hold, demoting every degree that does not fit
to replicated. The port runs on one device, so a searched strategy
comes out of it with every degree 1 (the JAX package's demotion on a
mesh of one device), and the manual `apply_*` passes run at degree 1,
where they change nothing.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

from ..ff_types import OperatorType
from ..pcg.graph import Graph


def apply_data_parallel(graph: Graph, degree: int, axis_idx: int = 0) -> None:
    """Shard dim 0 (sample dim) of every activation tensor by `degree`.

    reference: FFModel::get_basic_data_parallel_config (model.h:250) +
    the OP_INPUT Repartition insertion (model.cc:2637)."""
    if degree <= 1:
        return
    tensors = list(graph.input_tensors())
    for op in graph.ops:
        tensors.extend(op.outputs)
    for t in tensors:
        if t.num_dims == 0:
            continue
        d0 = t.dims[0]
        if d0.size % degree == 0 and not d0.is_replica_dim:
            d0.degree = degree
            d0.parallel_idx = axis_idx
    # weights stay replicated (degree 1): their gradients all-reduce.


def assign_mesh_axes(graph: Graph, max_devices: int) -> Dict[str, int]:
    """Lower a searched PCG (tensor degrees set by substitutions, views by
    the DP) to named device axes (the JAX package's mesh axes).

    The reference executes heterogeneous per-op MachineViews via Legion task
    placement; under one SPMD program we map degrees onto named mesh axes:
    sample-dim degrees -> "data", channel/head/weight degrees -> "model",
    WeightShard-targeted weight degrees -> "fsdp", axis_tag-carrying
    degrees (expert/seq substitution generators) -> their named axis,
    with the expert axis absorbing the data axis when their degrees
    match (the dispatch all-to-all reshards within the same device
    group). A dim whose degree
    doesn't equal its axis size can't shard evenly under NamedSharding and
    is demoted to replicated (round-1 lowering limit; the reference's
    fully heterogeneous placements would need per-segment programs).
    Block-stack (pipeline) ops keep their stage axis: their num_stages
    params were fixed at graph build from config, so the mesh must carry a
    matching "pipe" axis or the GPipe path silently degrades to the
    sequential scan.

    FSDP: when the fsdp degree divides the batch degree (the ZeRO case
    the fsdp substitutions construct — batch and weights sharded over the
    SAME workers), the fsdp axis is carved out of the data axis: mesh
    data size becomes data_deg/fsdp_deg and the batch dim lowers to the
    ("data", "fsdp") tuple (the JAX package's parallel/mesh.py). Otherwise fsdp is its own
    device factor (weights sharded, batch replicated over the group —
    memory-only sharding, still exact)."""
    from .weight_sharding import fsdp_degree_of, sharded_weight_records

    pipe_deg = 1
    for op in graph.ops:
        stages = getattr(op.params, "num_stages", 1)
        if stages > 1:
            pipe_deg = max(pipe_deg, stages)
    fsdp_deg = fsdp_degree_of(graph)
    fsdp_weights = sharded_weight_records(graph) if fsdp_deg > 1 else {}
    data_deg, model_deg = 1, 1
    expert_deg, seq_deg = 1, 1
    tensors = list(graph.input_tensors())
    for op in graph.ops:
        tensors.extend(op.outputs)
        tensors.extend(op.weights)
    # classify: activation dim0 = data; fsdp-targeted weight dims = fsdp;
    # axis_tag-carrying dims (the expert/seq substitution generators) =
    # their named axis; everything else = model
    weight_guids = {w.guid for op in graph.ops for w in op.weights}
    for t in tensors:
        is_weight = t.guid in weight_guids
        for i, d in enumerate(t.dims):
            if d.degree <= 1 or d.is_replica_dim:
                continue
            tag = getattr(d, "axis_tag", None)
            if tag == "expert":
                expert_deg = max(expert_deg, d.degree)
            elif tag == "seq":
                seq_deg = max(seq_deg, d.degree)
            elif i == 0 and not is_weight:
                data_deg = max(data_deg, d.degree)
            elif is_weight and t.guid in fsdp_weights \
                    and d.degree == fsdp_deg:
                pass  # owned by the fsdp axis, not model
            else:
                model_deg = max(model_deg, d.degree)

    def devices_needed(dd: int, fd: int, ed: int) -> int:
        # fsdp rides the data workers when it divides the batch degree
        # (ZeRO); otherwise it's an extra device factor. The expert axis
        # absorbs the data axis when their degrees match (the dispatch
        # all-to-all reshards within the same device group — merge rule
        # below); otherwise it is its own orthogonal factor, like seq.
        e = 1 if ed == dd else ed
        if fd > 1 and dd % fd == 0:
            return dd * e * model_deg * pipe_deg * seq_deg
        return dd * fd * e * model_deg * pipe_deg * seq_deg

    # shrink data, then model, then seq, then drop fsdp, then expert,
    # before sacrificing the user's requested pipeline degree; pipe is
    # last. Exception: while the expert dispatch rides the data axis
    # (equal degrees — the all-to-all NEEDS its input batch-sharded at
    # the expert degree), shrink model first so the pair survives.
    while devices_needed(data_deg, fsdp_deg, expert_deg) > max_devices \
            and model_deg > 1 and expert_deg > 1 and expert_deg == data_deg:
        model_deg //= 2
    while devices_needed(data_deg, fsdp_deg, expert_deg) > max_devices \
            and data_deg > 1:
        data_deg //= 2
    while devices_needed(data_deg, fsdp_deg, expert_deg) > max_devices \
            and model_deg > 1:
        model_deg //= 2
    while devices_needed(data_deg, fsdp_deg, expert_deg) > max_devices \
            and seq_deg > 1:
        seq_deg //= 2
    if devices_needed(data_deg, fsdp_deg, expert_deg) > max_devices \
            and fsdp_deg > 1:
        fsdp_deg = 1  # weight dims demote to replicated below
        fsdp_weights = {}
    if devices_needed(data_deg, fsdp_deg, expert_deg) > max_devices \
            and expert_deg > 1:
        expert_deg = 1  # expert dims demote to replicated below
    if devices_needed(data_deg, fsdp_deg, expert_deg) > max_devices:
        warnings.warn(
            f"dropping pipeline degree {pipe_deg} (needs {pipe_deg} "
            f"devices, have {max_devices}); block-stack ops fall back to "
            "the sequential scan")
        pipe_deg = 1  # ops degrade to the sequential scan path, still correct
    # WeightShard reconciliation: the fsdp axis carries ONE degree
    # (fsdp_degree_of: largest wins), so nodes at any other degree —
    # mixed-degree winners — and every node once the ladder dropped fsdp
    # would come out of the demotion below inert (declared shard degree
    # with no sharded weight dims: FFA207). Back them out the way the
    # fsdp_unshard_weights substitution does: restore the target's
    # replicated weights and splice the identity node out of the graph.
    stale_ws = [op for op in graph.ops
                if op.op_type == OperatorType.OP_WEIGHT_SHARD
                and (fsdp_deg == 1 or op.params.shard_degree != fsdp_deg)]
    if stale_ws:
        from .weight_sharding import unshard_op_weights, weight_shard_target

        drop = {op.guid for op in stale_ws}
        for ws in stale_ws:
            target = weight_shard_target(ws)
            if target is not None:
                unshard_op_weights(target)
            out_t, in_t = ws.outputs[0], ws.inputs[0]
            for o in graph.ops:
                for i, t in enumerate(o.inputs):
                    if t.guid == out_t.guid:
                        o.inputs[i] = in_t
        graph.ops = [o for o in graph.ops if o.guid not in drop]
        graph._producer_cache = None
        fsdp_weights = {g: r for g, r in fsdp_weights.items()
                        if r[0].guid not in drop}
    joint = fsdp_deg > 1 and data_deg % fsdp_deg == 0
    # Expert axis: the expert-parallel substitutions (search/
    # substitution.py partition_experts_alltoall) either compose with
    # partition_batch at the SAME degree — the all-to-all reshards the
    # batch-sharded tokens within the data device group, so the expert
    # axis absorbs the data axis (same devices, renamed) — or run with
    # the batch unsharded, where expert is its own device factor like
    # seq. Under joint fsdp the merge still holds — the fsdp group is a
    # subdivision of the same workers, so the expert axis takes the
    # CARVED size and expert/batch dims lower to the ("expert", "fsdp")
    # tuple (pspec_for_parallel_tensor), exactly the ZeRO batch rule
    # with the data axis renamed.
    merge_expert = expert_deg > 1 and expert_deg == data_deg \
        and (fsdp_deg == 1 or joint)
    solo_expert = expert_deg > 1 and expert_deg != data_deg
    axes = {"data": data_deg // fsdp_deg if joint else data_deg,
            "model": model_deg}
    data_idx, expert_idx = 0, None
    if merge_expert:
        axes["expert"] = axes["data"]  # carved size under joint fsdp
        axes["data"] = 1
        expert_idx = len(axes) - 1
        data_idx = expert_idx  # batch dims ride the renamed axis
    elif solo_expert:
        axes["expert"] = expert_deg
        expert_idx = len(axes) - 1
    seq_idx = None
    if seq_deg > 1:
        axes["seq"] = seq_deg
        seq_idx = len(axes) - 1
    fsdp_idx = None
    if fsdp_deg > 1:
        axes["fsdp"] = fsdp_deg
        fsdp_idx = len(axes) - 1
    for t in tensors:
        is_weight = t.guid in weight_guids
        for i, d in enumerate(t.dims):
            if d.degree <= 1:
                continue
            if d.is_replica_dim:
                d.parallel_idx = -1
                continue
            tag = getattr(d, "axis_tag", None)
            if tag == "expert":
                if expert_idx is not None and d.degree == expert_deg:
                    d.parallel_idx = expert_idx
                else:
                    d.degree, d.parallel_idx = 1, -1
            elif tag == "seq":
                if seq_idx is not None and d.degree == seq_deg:
                    d.parallel_idx = seq_idx
                else:
                    d.degree, d.parallel_idx = 1, -1
            elif i == 0 and not is_weight:
                if d.degree == data_deg and data_deg > 1:
                    d.parallel_idx = data_idx
                else:
                    d.degree, d.parallel_idx = 1, -1
            elif is_weight and fsdp_idx is not None \
                    and t.guid in fsdp_weights and d.degree == fsdp_deg:
                d.parallel_idx = fsdp_idx
            else:
                if d.degree == model_deg and model_deg > 1:
                    d.parallel_idx = 1
                else:
                    d.degree, d.parallel_idx = 1, -1
    # demotion reconciliation: an AllToAll whose scatter dim was demoted
    # above must not keep declaring the searched exchange degree — the
    # strategy validators (FFA104/FFA505) compare params against dims,
    # and a degree-1 exchange lowers to the identity reshard
    for op in graph.ops:
        if op.op_type != OperatorType.OP_ALL_TO_ALL or not op.outputs:
            continue
        p = op.params
        if 0 <= p.scatter_dim < len(op.outputs[0].dims):
            actual = op.outputs[0].dims[p.scatter_dim].degree
            if actual != p.degree:
                op.params = dataclasses.replace(p, degree=actual)
    if pipe_deg > 1:
        axes["pipe"] = pipe_deg
        apply_pipeline_parallel(graph, pipe_deg, axis_idx=len(axes) - 1)
    return axes


def apply_tensor_parallel(graph: Graph, degree: int, axis_idx: int = 1) -> None:
    """Megatron-style tensor/model parallelism via weight-dim sharding.

    reference equivalents: Linear replica-dim model parallelism
    (model.cc:1979 map_linear_weight + Replicate/Reduction pairs) and
    attention attribute parallelism over heads (substitution.cc:1764-1770).
    Here: shard weight dims tagged "out_channel"/"head"/"vocab" over the
    model mesh axis; the JAX package's GSPMD inserts the Replicate/Reduction collectives the
    reference materializes as parallel ops.

    Activations: the hidden dim of LINEAR outputs is sharded to keep the
    matmul local (column-parallel); attention output stays replicated (the
    wo einsum contracts the head dim, producing the reduction)."""
    if degree <= 1:
        return
    for op in graph.ops:
        tags_list = getattr(op, "weight_tags", [])
        shard_out = False
        for wpt, tags in zip(op.weights, tags_list):
            for i, tag in enumerate(tags):
                if tag in ("out_channel", "head", "vocab") and (
                    wpt.dims[i].size % degree == 0
                ):
                    wpt.dims[i].degree = degree
                    wpt.dims[i].parallel_idx = axis_idx
                    if tag == "out_channel":
                        shard_out = True
                    break  # one sharded dim per weight
        if shard_out and op.op_type == OperatorType.OP_LINEAR:
            for t in op.outputs:
                last = t.dims[-1]
                if last.size % degree == 0:
                    last.degree = degree
                    last.parallel_idx = axis_idx


def apply_expert_parallel(graph: Graph, degree: int, axis_idx: int) -> None:
    """Expert parallelism: distinct experts' dense ops run on distinct mesh
    slots (reference: MoE ops get distinct MachineViews, SURVEY §2.3). Under
    SPMD we shard the leading expert-capacity dim of group_by outputs."""
    if degree <= 1:
        return
    for op in graph.ops:
        if op.op_type == OperatorType.OP_GROUP_BY:
            for t in op.outputs:
                if t.dims[0].size % degree == 0:
                    t.dims[0].degree = degree
                    t.dims[0].parallel_idx = axis_idx


def apply_pipeline_parallel(graph: Graph, degree: int, axis_idx: int) -> None:
    """Pipeline parallelism: shard the leading (layer) dim of block-stack
    weights over the pipe mesh axis — stage placement AS a sharding.

    No reference equivalent (OP_PIPELINE is enum-only there, ffconst.h:158);
    execution is parallel/pipeline.py's GPipe schedule."""
    if degree <= 1:
        return
    for op in graph.ops:
        for wpt, tags in zip(op.weights, getattr(op, "weight_tags", [])):
            for i, tag in enumerate(tags):
                if tag == "pipeline_stage" and wpt.dims[i].size % degree == 0:
                    wpt.dims[i].degree = degree
                    wpt.dims[i].parallel_idx = axis_idx
                    break


def apply_weight_sharding(graph: Graph, degree: int, axis_idx: int) -> int:
    """FSDP/ZeRO weight sharding as a manual strategy (config.fsdp_degree;
    no reference equivalent — the reference always replicates weights
    within a model-parallel group): shard every eligible op's parameters
    (and thereby gradient buffers + optimizer-state slots, which inherit
    the sharding) over the ``fsdp`` mesh axis and insert the WeightShard
    bookkeeping nodes. See parallel/weight_sharding.py for semantics."""
    from .weight_sharding import apply_weight_sharding as _apply

    return _apply(graph, degree, axis_idx)


def apply_sequence_parallel(
    graph: Graph, degree: int, axis_idx: int, seq_dim: int = 1
) -> None:
    """Shard the sequence dim of 3-D activations (batch, seq, hidden).

    No reference equivalent (SURVEY §5: sequence parallelism absent there);
    this is the JAX package's first-class SP strategy. Attention ops handle the
    resharding internally (ring attention / all-to-all in kernels/)."""
    if degree <= 1:
        return
    for op in graph.ops:
        for t in op.outputs:
            if t.num_dims == 3 and t.dims[seq_dim].size % degree == 0:
                t.dims[seq_dim].degree = degree
                t.dims[seq_dim].parallel_idx = axis_idx
