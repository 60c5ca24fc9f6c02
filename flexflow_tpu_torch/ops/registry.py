"""Operator definition registry.

The PyTorch counterpart of flexflow_tpu/ops/registry.py. An operator
definition is a hashable Params dataclass, shape inference, weight specs
and a forward function over torch tensors; incremental decoding adds
`forward_decode`. Backward comes from autograd (through the flash
kernels' autograd Function for attention on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ff_types import DataType, OperatorType


@dataclasses.dataclass
class WeightSpec:
    """Declares one weight tensor of an op."""

    name: str
    shape: Tuple[int, ...]
    dtype: DataType
    initializer: str = "glorot_uniform"
    parallel_dim_tags: Tuple[str, ...] = ()


@dataclasses.dataclass
class OpDef:
    op_type: OperatorType
    name: str
    # (params, input_shapes, input_dtypes) -> (out_shapes, out_dtypes)
    infer: Callable
    # (params, input_shapes, input_dtypes) -> List[WeightSpec]
    weights: Callable
    # (params, weights: Dict[str, Tensor], inputs: List[Tensor], ctx) -> List[Tensor]
    forward: Callable
    num_inputs: int = 1
    # ops that mix sequence positions provide
    # forward_decode(params, weights, inputs, ctx, cache, t) -> (outs, cache)
    forward_decode: Optional[Callable] = None


_REGISTRY: Dict[OperatorType, OpDef] = {}


def register_op(
    op_type: OperatorType,
    name: str,
    *,
    infer: Callable,
    forward: Callable,
    weights: Optional[Callable] = None,
    num_inputs: int = 1,
    forward_decode: Optional[Callable] = None,
) -> OpDef:
    d = OpDef(
        op_type=op_type,
        name=name,
        infer=infer,
        weights=weights or (lambda p, s, dt: []),
        forward=forward,
        num_inputs=num_inputs,
        forward_decode=forward_decode,
    )
    _REGISTRY[op_type] = d
    return d


def get_op_def(op_type: OperatorType) -> OpDef:
    ensure_ops_loaded()
    if op_type not in _REGISTRY:
        raise NotImplementedError(
            f"operator {op_type.name} is not ported to flexflow_tpu_torch yet"
        )
    return _REGISTRY[op_type]


@dataclasses.dataclass
class FwdCtx:
    """Per-call context threaded through op forwards."""

    training: bool = False
    compute_dtype: Optional[object] = None  # torch dtype autocast target
    # the PCG op's name, for per-layer diagnostics ("" for raw calls)
    op_name: str = ""
    # the step's random stream in training (the JAX context's rng key)
    rng: Optional[torch.Generator] = None


def ensure_ops_loaded():
    """Import all op modules so their register_op calls run."""
    from . import attention, embedding, linear, softmax  # noqa: F401
