"""Operator definition registry.

The PyTorch counterpart of flexflow_tpu/ops/registry.py. An operator
definition is a hashable Params dataclass, shape inference, weight specs
and a forward function over torch tensors; incremental decoding adds
`forward_decode`, and ops that carry state across batches (BatchNorm's
running statistics) add `state_spec` and `forward_stateful`. Backward
comes from autograd (through the flash
kernels' autograd Function for attention on the card). Ops whose
objective carries a term of its own (MoE's load-balance loss) append it
to the context's `aux_losses` (`add_aux_loss`); the training objectives
add those terms to the loss.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

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
    # ops that draw random numbers in training provide draws(params) ->
    # bool; the executor's seed table holds seeds for those that do
    draws: Optional[Callable] = None
    # ops with cross-batch state (BatchNorm's running statistics) declare
    # it like weights, state_spec(params, in_shapes, in_dtypes) ->
    # List[WeightSpec], and provide forward_stateful(params, weights,
    # state, inputs, ctx) -> (outs, new_state); the executor keeps the
    # state in TrainState.net_state
    state_spec: Optional[Callable] = None
    forward_stateful: Optional[Callable] = None


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
    draws: Optional[Callable] = None,
    state_spec: Optional[Callable] = None,
    forward_stateful: Optional[Callable] = None,
) -> OpDef:
    d = OpDef(
        op_type=op_type,
        name=name,
        infer=infer,
        weights=weights or (lambda p, s, dt: []),
        forward=forward,
        num_inputs=num_inputs,
        forward_decode=forward_decode,
        draws=draws,
        state_spec=state_spec,
        forward_stateful=forward_stateful,
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


def has_op_def(op_type: OperatorType) -> bool:
    ensure_ops_loaded()
    return op_type in _REGISTRY


def all_op_types() -> List[OperatorType]:
    return list(_REGISTRY)


@dataclasses.dataclass
class FwdCtx:
    """Per-call context threaded through op forwards."""

    training: bool = False
    compute_dtype: Optional[object] = None  # torch dtype autocast target
    # the PCG op's name, for per-layer diagnostics ("" for raw calls)
    op_name: str = ""
    # this op's seed material in training (the JAX context's folded rng
    # key): a host int, fold_in(step seed, compute index), or the op's
    # entry of the executor's seed table: a (2,) int32 tensor on the
    # op's device holding dropout_seeds(that int) (core/seeds.py). The
    # tensor form is what a captured CUDA graph reads at replay.
    rng: Optional[Union[int, torch.Tensor]] = None
    # FFIterationConfig.seq_length (reference: config.h:162); -1 = whole
    seq_length: int = -1
    # serving's cache of compute-dtype weight copies (ops/common.py
    # WeightCache); None on the training path
    weight_cache: Optional[object] = None
    # differentiable auxiliary losses collected during a training walk
    # (MoE load balancing, ops/moe.py); the executor adds them to the
    # loss. None: nothing collects them (inference, raw op calls)
    aux_losses: Optional[List[torch.Tensor]] = None
    # the executor's profiler ranges are on (a step-observatory trace):
    # ops whose backward runs in an autograd Function of their own name
    # it "<op_name>.bwd"
    profile_ranges: bool = False
    # the mesh the executor runs on (parallel/mesh.py Mesh; None: one
    # device, no process group) and its device count, as in the JAX
    # context: ops that shard work by hand (attention's per-shard flash
    # kernels) read the axis sizes
    mesh: Optional[object] = None
    n_devices: int = 1

    def add_aux_loss(self, value: torch.Tensor) -> None:
        if self.aux_losses is not None:
            self.aux_losses.append(value)


def ensure_ops_loaded():
    """Import all op modules so their register_op calls run."""
    from . import (attention, batch_matmul, conv2d, dropout,  # noqa: F401
                   elementwise, embedding, fused, linear, lstm, moe,
                   normalization, pipeline, pool2d, reduce, softmax,
                   tensor_ops)
    from ..parallel import parallel_ops  # noqa: F401
