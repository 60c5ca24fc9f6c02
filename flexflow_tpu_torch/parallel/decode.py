"""Incremental (KV-cache) decoding plan.

The PyTorch counterpart of flexflow_tpu/parallel/decode.py, for the ops
this package has ported. Every tensor is classified by how the decode
position flows through it:

  * live axis   -- the axis indexed by decoder position; per step only the
    newest s0 positions are computed (s0 = 1, or the prompt at prefill);
  * static      -- everything not downstream of the decode input (the
    executor refuses graphs that have any, until static inputs are
    ported).

Axis info propagates forward from the decode input through per-op rules.
An op the rules cannot prove exact raises DecodeExactnessError at build
time; so does a fused op (--fusion), which has no rule in the JAX package
either. The JAX package's further rules (primitive-op attention through
batch_matmul with prefix caches, reshapes, transposes, static slicing and
the causality proof over baked masks) come with the ops they govern.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..ff_types import AggrMode, OperatorType


class DecodeExactnessError(NotImplementedError):
    """Incremental decode cannot prove a step exact for this graph."""


@dataclasses.dataclass(frozen=True)
class AxisInfo:
    """Where the decode position lives in a tensor. None = static/full."""

    live: Optional[int] = None

    @property
    def is_live(self) -> bool:
        return self.live is not None


@dataclasses.dataclass
class DecodePlan:
    """Build-time product: everything the decode step needs."""

    live_ops: List  # topo-ordered ops downstream of the decode input
    static_ops: List  # topo-ordered ops computable from static inputs
    info: Dict[int, AxisInfo]  # guid -> axis info (live tensors only)
    decode_pt: object  # the decode-driving input ParallelTensor


class _Propagator:
    """Forward axis-info propagation + build-time validation."""

    def __init__(self):
        self.info: Dict[int, AxisInfo] = {}

    def get(self, guid) -> AxisInfo:
        return self.info.get(guid, AxisInfo())

    def visit(self, op):
        t = op.op_type
        ins = [self.get(x.guid) for x in op.inputs]
        in_shapes = [tuple(x.material_shape()) for x in op.inputs]

        def fail(msg):
            raise DecodeExactnessError(
                f"{op.name} ({t.name}): incremental decode can't prove "
                f"exactness -- {msg}")

        def set_out(info):
            self.info[op.outputs[0].guid] = info

        if t == OperatorType.OP_MULTIHEAD_ATTENTION:
            q, k, v = ins
            if q.live != 1:
                fail("attention query must be (batch, seq, embed) with the "
                     "live axis at 1")
            if not (k.live == 1 and v.live == 1):
                fail("attention k/v must be live at axis 1 (cross-attention "
                     "decode is not ported yet)")
            if not op.params.causal:
                fail("needs causal=True (otherwise each position sees the "
                     "future and the cached prefix is stale)")
            set_out(AxisInfo(live=1))
            return

        if t == OperatorType.OP_LINEAR:
            a = ins[0]
            if a.live == len(in_shapes[0]) - 1:
                fail("linear contracts the live axis")
            set_out(a)
            return

        if t == OperatorType.OP_EMBEDDING:
            if op.params.aggr != AggrMode.AGGR_MODE_NONE:
                fail("bag aggregation reduces over the ids axis")
            # (.., L) ids -> (.., L, E): axes keep their positions
            set_out(ins[0])
            return

        if t == OperatorType.OP_SOFTMAX:
            a = ins[0]
            dim = op.params.dim % len(in_shapes[0])
            if dim == a.live:
                fail("softmax over the live axis")
            set_out(a)
            return

        fail("op mixes sequence positions and has no decode rule")


def build_plan(topo, input_pts) -> DecodePlan:
    """Classify ops/tensors and validate decodability. The decode input
    is the last graph input (the JAX package's default)."""
    decode_pt = list(input_pts)[-1]
    prop = _Propagator()
    prop.info[decode_pt.guid] = AxisInfo(live=1)
    live_ops, static_ops = [], []
    for op in topo:
        if any(prop.get(x.guid).is_live for x in op.inputs):
            prop.visit(op)
            live_ops.append(op)
        else:
            static_ops.append(op)
    return DecodePlan(live_ops=live_ops, static_ops=static_ops,
                      info=prop.info, decode_pt=decode_pt)
