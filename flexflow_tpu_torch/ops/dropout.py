"""Dropout operator.

The PyTorch counterpart of flexflow_tpu/ops/dropout.py (reference:
src/ops/dropout.cc). Identity unless training, rate > 0 and an rng are
all present; then each element is kept with probability 1 - rate and
scaled by 1/(1 - rate). JAX draws `jax.random.bernoulli(fold_in(rng,
seed))`, which no torch generator reproduces bit for bit: the port folds
the op's `seed` param into its seed material the same way and draws the
mask on the tensor's device, from a generator on that device seeded with
the result. The mask is never drawn on the host and copied.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.seeds import fold_in
from ..ff_types import OperatorType
from .registry import register_op


@dataclasses.dataclass(frozen=True)
class DropoutParams:
    """reference: include/flexflow/ops/dropout_params.h"""

    rate: float = 0.5
    seed: int = 0


def _infer(params, in_shapes, in_dtypes):
    return [in_shapes[0]], [in_dtypes[0]]


def _forward(params: DropoutParams, weights, inputs, ctx):
    (x,) = inputs
    if not ctx.training or params.rate <= 0.0 or ctx.rng is None:
        return [x]
    keep = 1.0 - params.rate
    gen = torch.Generator(device=x.device)
    gen.manual_seed(fold_in(ctx.rng, params.seed) >> 1)  # 63 bits
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return [torch.where(mask, x / keep, 0).to(x.dtype)]


register_op(OperatorType.OP_DROPOUT, "Dropout", infer=_infer,
            forward=_forward)
