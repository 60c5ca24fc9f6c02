"""The Parallel Computation Graph.

The PyTorch counterpart of flexflow_tpu/pcg/graph.py (reference:
PCG::Graph, include/flexflow/graph.h:293-377, and Edge, graph.h:31): a
mutable DAG of PCGOp nodes connected by ParallelTensors, with edges
derived from tensor producer/consumer identity, and the structural
operations the search needs: topo order, hashing, the correctness gate
and dot export.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .op import PCGOp
from .parallel_tensor import ParallelTensor


@dataclasses.dataclass(frozen=True)
class Edge:
    """reference: graph.h:31 Edge{srcOp,dstOp,srcIdx,dstIdx}"""

    src: PCGOp
    dst: PCGOp
    src_idx: int
    dst_idx: int

    def __hash__(self):
        return hash((self.src.guid, self.dst.guid, self.src_idx, self.dst_idx))


class Graph:
    """PCG container (reference: graph.h:293)."""

    def __init__(self, ops: Optional[List[PCGOp]] = None):
        self.ops: List[PCGOp] = list(ops) if ops else []
        # external inputs: ParallelTensors with no producer inside the graph
        self._producer_cache: Optional[Dict[int, Tuple[PCGOp, int]]] = None

    def add_op(self, op: PCGOp) -> PCGOp:
        self.ops.append(op)
        self._producer_cache = None
        return op

    # -- structure ----------------------------------------------------------
    def producers(self) -> Dict[int, Tuple[PCGOp, int]]:
        """tensor guid -> (producing op, output index)."""
        if self._producer_cache is None:
            m: Dict[int, Tuple[PCGOp, int]] = {}
            for op in self.ops:
                for i, t in enumerate(op.outputs):
                    m[t.guid] = (op, i)
            self._producer_cache = m
        return self._producer_cache

    def in_edges(self, op: PCGOp) -> List[Edge]:
        prod = self.producers()
        es = []
        for j, t in enumerate(op.inputs):
            if t.guid in prod:
                src, i = prod[t.guid]
                es.append(Edge(src, op, i, j))
        return es

    def out_edges(self, op: PCGOp) -> List[Edge]:
        es = []
        out_guids = {t.guid: i for i, t in enumerate(op.outputs)}
        for other in self.ops:
            if other is op:
                continue
            for j, t in enumerate(other.inputs):
                if t.guid in out_guids:
                    es.append(Edge(op, other, out_guids[t.guid], j))
        return es

    def input_tensors(self) -> List[ParallelTensor]:
        prod = self.producers()
        seen: Set[int] = set()
        ins: List[ParallelTensor] = []
        for op in self.ops:
            for t in op.inputs:
                if t.guid not in prod and t.guid not in seen:
                    seen.add(t.guid)
                    ins.append(t)
        return ins

    def output_tensors(self) -> List[ParallelTensor]:
        """Tensors produced but never consumed."""
        consumed = {t.guid for op in self.ops for t in op.inputs}
        outs = []
        for op in self.ops:
            for t in op.outputs:
                if t.guid not in consumed:
                    outs.append(t)
        return outs

    def topo_order(self) -> List[PCGOp]:
        prod = self.producers()
        visited: Set[int] = set()
        order: List[PCGOp] = []

        def visit(op: PCGOp):
            if op.guid in visited:
                return
            visited.add(op.guid)
            for t in op.inputs:
                if t.guid in prod:
                    visit(prod[t.guid][0])
            order.append(op)

        for op in self.ops:
            visit(op)
        return order

    def check_correctness(self) -> bool:
        """reference: Graph::check_correctness — every op input either comes
        from another op or is a graph input; every tensor produced at most
        once; shapes valid; graph acyclic. Delegates to the static
        analyzer's structure pass (analysis/structure.py), which names the
        violation when one wants the details (the search only needs the
        boolean gate)."""
        from ..analysis.structure import graph_is_wellformed

        return graph_is_wellformed(self)

    def hash(self) -> int:
        """Structural hash (reference: Graph::hash used in dp_state_hash).

        MUST fold output and weight shape keys, not just inputs: rewrites
        that only change weight/output parallel degrees (attention
        head-partition, embedding channel-split) are otherwise
        hash-identical to the unrewritten graph — the best-first search
        deduplicates by this hash and would silently drop the whole
        attribute-/parameter-parallel candidate class."""
        h = 17
        for op in self.topo_order():
            key = (op.op_type, op.params)
            mv = op.machine_view.hash() if op.machine_view else 0
            h = hash((
                h, key, mv,
                tuple(t.shape_key() for t in op.inputs),
                tuple(t.shape_key() for t in op.outputs),
                tuple(w.shape_key() for w in op.weights),
            ))
        return h

    # -- dot export (reference: Graph::export_strategy_computation_graph,
    #    include/flexflow/utils/dot/) ---------------------------------------
    def export_dot(self) -> str:
        lines = ["digraph PCG {"]
        for op in self.ops:
            label = op.name
            if op.machine_view is not None:
                label += f"\\n{op.machine_view!r}"
            lines.append(f'  n{op.guid} [label="{label}"];')
        for op in self.ops:
            for e in self.in_edges(op):
                lines.append(f"  n{e.src.guid} -> n{e.dst.guid};")
        lines.append("}")
        return "\n".join(lines)

    def __len__(self):
        return len(self.ops)
