"""FusedOp: a chain of ops run as one PCG node.

The PyTorch counterpart of flexflow_tpu/ops/fused.py (reference:
src/ops/fused.cc, packed by --fusion, pcg/fusion.py). The chain's steps
run one after another through their own forwards, so a fused graph
launches the same kernels as the unfused one and computes the same
values bit for bit; what fusion changes is the graph the PCG holds.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..ff_types import OperatorType
from .registry import FwdCtx, get_op_def, register_op


@dataclasses.dataclass(frozen=True)
class FusedOpParams:
    """Chain of (op_type, params, input_slot_indices) triples.

    Slots: 0..num_inputs-1 are the fused op's inputs; num_inputs + i is
    the output of chain step i (the reference's slot encoding in
    fused.cc)."""

    chain: Tuple[Tuple[OperatorType, object, Tuple[int, ...]], ...]
    num_inputs: int
    output_slots: Tuple[int, ...]


def _fused_infer(params: FusedOpParams, in_shapes, in_dtypes):
    slots_s, slots_d = list(in_shapes), list(in_dtypes)
    for op_type, p, in_slots in params.chain:
        outs, dts = get_op_def(op_type).infer(
            p, [slots_s[i] for i in in_slots], [slots_d[i] for i in in_slots])
        slots_s.extend(outs)
        slots_d.extend(dts)
    return ([slots_s[i] for i in params.output_slots],
            [slots_d[i] for i in params.output_slots])


def step_weights(weights, step: int):
    """Chain step `step`'s weights from the fused op's: the nested
    {"step0": {...}} or the flat {"step0/kernel": ...} layout."""
    out = dict(weights.get(f"step{step}", {}))
    prefix = f"step{step}/"
    for k, v in weights.items():
        if isinstance(k, str) and k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


def _fused_forward(params: FusedOpParams, weights, inputs, ctx: FwdCtx):
    slots = list(inputs)
    for step, (op_type, p, in_slots) in enumerate(params.chain):
        slots.extend(get_op_def(op_type).forward(
            p, step_weights(weights or {}, step), [slots[i] for i in in_slots],
            ctx))
    return [slots[i] for i in params.output_slots]


register_op(OperatorType.OP_FUSED, "FusedOp", infer=_fused_infer,
            forward=_fused_forward, num_inputs=-1)
