"""Operator library: the PyTorch counterparts of the JAX package's ops
(reference src/ops/), each registered in ops/registry.py."""
from .registry import (  # noqa: F401
    FwdCtx,
    OpDef,
    WeightSpec,
    all_op_types,
    ensure_ops_loaded,
    get_op_def,
    has_op_def,
    register_op,
)

ensure_ops_loaded()
