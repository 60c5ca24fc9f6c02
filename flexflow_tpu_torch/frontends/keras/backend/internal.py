"""reference: python/flexflow/keras/backend/internal.py — rsqrt/gather
functional wrappers (+ the layer classes live in ..layers)."""
from ..layers import (BatchMatmul, Cos, Exp, Gather, Pow,  # noqa: F401
                      ReduceSum, Rsqrt, Sin)


def rsqrt(x, name=""):
    return Rsqrt(name=name)(x)


def gather(x, indices, axis, name=""):
    return Gather(axis, name=name)([x, indices])
