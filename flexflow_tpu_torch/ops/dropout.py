"""Dropout operator.

The PyTorch counterpart of flexflow_tpu/ops/dropout.py (reference:
src/ops/dropout.cc). Identity unless training, rate > 0 and an rng are
all present; then each element is kept with probability 1 - rate and
scaled by 1/(1 - rate). JAX draws `jax.random.bernoulli(fold_in(rng,
seed))`, which no torch generator reproduces bit for bit, so parity is
statistical. The port draws the mask from the op's two dropout seeds
(its seed-table entry on the device, or `dropout_seeds` of a host int)
with the attention kernels' counter hash (kernels/attention.py
`_keep_bits`, here on int32 bit patterns) on the flat element index,
the op's `seed` param folded into the second seed. It is plain torch
integer arithmetic on the tensor's device: no generator, no host sync,
nothing a captured CUDA graph would freeze, so each replay draws the
mask of its step's seeds.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ff_types import OperatorType
from .registry import register_op


@dataclasses.dataclass(frozen=True)
class DropoutParams:
    """reference: include/flexflow/ops/dropout_params.h"""

    rate: float = 0.5
    seed: int = 0


def _infer(params, in_shapes, in_dtypes):
    return [in_shapes[0]], [in_dtypes[0]]


def keep_mask(seeds, rate: float, shape, device, salt: int = 0):
    """The bool keep-mask of `shape`: element i (flat, mod 2^32) is kept
    iff `_keep_bits(i, s0, s1 ^ mix32(salt)) >= round(rate * 2^32)`,
    computed on int32 bit patterns (`_keep_bits_i32`)."""
    from ..kernels.attention import (_M32, _at_least_u32, _drop_threshold,
                                     _i32, _keep_bits_i32, _mix32)

    if isinstance(seeds, torch.Tensor):
        s0, s1 = seeds.to(device=device, dtype=torch.int32)
    else:
        s0, s1 = _i32(int(seeds[0])), _i32(int(seeds[1]))
    if salt:  # mix32(0) == 0
        s1 = s1 ^ _i32(_mix32(int(salt) & _M32))
    n = 1
    for d in shape:
        n *= d
    if n <= 1 << 31:
        idx = torch.arange(n, dtype=torch.int32, device=device)
    else:  # flat indices mod 2^32, as int32 bit patterns
        idx = torch.arange(n, dtype=torch.int64, device=device) & _M32
        idx = ((idx ^ (1 << 31)) - (1 << 31)).to(torch.int32)
    bits = _keep_bits_i32(idx, s0, s1)
    return _at_least_u32(bits, _drop_threshold(rate)).view(shape)


def _forward(params: DropoutParams, weights, inputs, ctx):
    from ..kernels import attention as katt

    (x,) = inputs
    if not ctx.training or params.rate <= 0.0 or ctx.rng is None:
        return [x]
    seeds = (ctx.rng if isinstance(ctx.rng, torch.Tensor)
             else katt.dropout_seeds(ctx.rng))
    mask = keep_mask(seeds, params.rate, x.shape, x.device, params.seed)
    return [torch.where(mask, x / (1.0 - params.rate), 0).to(x.dtype)]


register_op(OperatorType.OP_DROPOUT, "Dropout", infer=_infer,
            forward=_forward, draws=lambda p: p.rate > 0.0)
