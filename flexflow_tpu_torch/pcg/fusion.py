"""Operator fusion pass.

The PyTorch counterpart of flexflow_tpu/pcg/fusion.py (reference:
FFModel::apply_fusion, src/runtime/model.cc:2495-2560, enabled by
--fusion): packs maximal chains of single-input, single-output ops of
the fusable set into one OP_FUSED node (ops/fused.py). Each op of a
chain after the first is the sole consumer of the one before it. The
fused op is named `fused_<first>__<last>` and carries the chain's
weights as `step<i>/<name>`, with their parallel-dim tags and
initializers, so its weights match the JAX package's fused graph by
name. It also records the chain's op names (`fused_from`), which tell
which of an unfused model's weights each step holds.
"""
from __future__ import annotations

from typing import Dict, List

from ..ff_types import OperatorType
from ..ops.fused import FusedOpParams
from .graph import Graph
from .op import PCGOp

# ops safe to pack into a chain (one tensor in, one out, no random draws)
_FUSABLE = {
    OperatorType.OP_LINEAR,
    OperatorType.OP_RELU,
    OperatorType.OP_SIGMOID,
    OperatorType.OP_TANH,
    OperatorType.OP_GELU,
    OperatorType.OP_ELU,
    OperatorType.OP_EXP,
    OperatorType.OP_SCALAR_MULTIPLY,
    OperatorType.OP_SCALAR_ADD,
    OperatorType.OP_SCALAR_SUB,
    OperatorType.OP_SCALAR_TRUE_DIV,
    OperatorType.OP_POW,
    OperatorType.OP_RSQRT,
    OperatorType.OP_SOFTMAX,
    OperatorType.OP_LAYERNORM,
    OperatorType.OP_FLAT,
    OperatorType.OP_RESHAPE,
    OperatorType.OP_IDENTITY,
}


def _fusable(op: PCGOp) -> bool:
    return (op.op_type in _FUSABLE and len(op.inputs) == 1
            and len(op.outputs) == 1)


def apply_fusion(graph: Graph) -> Graph:
    """A new graph with the fusable chains packed into OP_FUSED nodes."""
    topo = graph.topo_order()
    prod = graph.producers()
    consumers: Dict[int, List[PCGOp]] = {}
    for op in topo:
        for t in op.inputs:
            p = prod.get(t.guid)
            if p is not None:
                consumers.setdefault(p[0].guid, []).append(op)

    new_graph = Graph()
    consumed = set()
    for op in topo:
        if op.guid in consumed:
            continue
        if not _fusable(op):
            new_graph.add_op(op)
            continue
        # grow the chain while the next op is the sole consumer and fusable
        chain = [op]
        while True:
            cons = consumers.get(chain[-1].guid, [])
            if len(cons) != 1:
                break
            nxt = cons[0]
            if (not _fusable(nxt)
                    or nxt.inputs[0].guid != chain[-1].outputs[0].guid):
                break
            chain.append(nxt)
        if len(chain) == 1:
            new_graph.add_op(op)
            continue
        consumed.update(c.guid for c in chain)
        new_graph.add_op(_make_fused(chain))
    return new_graph


def _make_fused(chain: List[PCGOp]) -> PCGOp:
    first, last = chain[0], chain[-1]
    # step 0 reads the fused op's input (slot 0), step i the output of
    # step i - 1 (slot i)
    params = FusedOpParams(
        chain=tuple((c.op_type, c.params, (i,)) for i, c in enumerate(chain)),
        num_inputs=1, output_slots=(len(chain),))
    fused = PCGOp(OperatorType.OP_FUSED, params, [first.inputs[0]],
                  name=f"fused_{first.name}__{last.name}",
                  layer_guid=first.layer_guid)
    out = last.outputs[0]
    out.owner_op = fused
    fused.outputs.append(out)
    fused.fused_from = [c.name for c in chain]
    for i, c in enumerate(chain):
        for w, name, tags in zip(c.weights, c.weight_names, c.weight_tags):
            w.owner_op = fused
            fused.weights.append(w)
            fused.weight_names.append(f"step{i}/{name}")
            fused.weight_tags.append(tags)
            fused.initializers[f"step{i}/{name}"] = c.initializers.get(
                name, "glorot_uniform")
    return fused
