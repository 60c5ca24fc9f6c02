"""The Parallel Computation Graph.

The PyTorch counterpart of flexflow_tpu/pcg/graph.py (reference:
graph.h:293-377): a DAG of PCGOp nodes connected by ParallelTensors, with
edges derived from tensor producer/consumer identity.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .op import PCGOp
from .parallel_tensor import ParallelTensor


class Graph:
    """PCG container (reference: graph.h:293)."""

    def __init__(self, ops: Optional[List[PCGOp]] = None):
        self.ops: List[PCGOp] = list(ops) if ops else []
        self._producer_cache: Optional[Dict[int, Tuple[PCGOp, int]]] = None

    def add_op(self, op: PCGOp) -> PCGOp:
        self.ops.append(op)
        self._producer_cache = None
        return op

    def producers(self) -> Dict[int, Tuple[PCGOp, int]]:
        """tensor guid -> (producing op, output index)."""
        if self._producer_cache is None:
            m: Dict[int, Tuple[PCGOp, int]] = {}
            for op in self.ops:
                for i, t in enumerate(op.outputs):
                    m[t.guid] = (op, i)
            self._producer_cache = m
        return self._producer_cache

    def input_tensors(self) -> List[ParallelTensor]:
        """Tensors consumed but produced by no op, in first-use order."""
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
        return [t for op in self.ops for t in op.outputs
                if t.guid not in consumed]

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

    def __len__(self):
        return len(self.ops)
