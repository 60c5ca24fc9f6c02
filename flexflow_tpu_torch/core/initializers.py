"""Weight initializers.

The PyTorch counterpart of flexflow_tpu/core/initializers.py (reference:
src/runtime/initializer.cc): glorot_uniform, zero(s), one(s),
"constant:<value>" (PReLU's slope), uniform and normal (norm). Each draws
from an explicit `torch.Generator`;
the executor seeds one from FFConfig.seed and draws on the CPU, so a seed
gives the same weights on every device. JAX's PRNG and torch's give
different numbers from one seed: to compare the two packages, carry
weights across (runtime/weights.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class Initializer:
    """Base (reference: include/flexflow/initializer.h:21)."""

    def __call__(self, gen: torch.Generator, shape, dtype: torch.dtype):
        raise NotImplementedError


@dataclasses.dataclass
class GlorotUniformInitializer(Initializer):
    """Keras glorot_uniform with the JAX package's fan convention: an OIHW
    conv kernel has fan_in I*kh*kw and fan_out O*kh*kw; any other weight
    of rank >= 2 has fan_in the product of all but the last axis and
    fan_out the last."""

    def __call__(self, gen, shape, dtype):
        if len(shape) == 4:
            receptive = shape[2] * shape[3]
            fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
        elif len(shape) >= 2:
            fan_in, fan_out = int(np.prod(shape[:-1])), shape[-1]
        else:
            fan_in = fan_out = shape[0] if shape else 1
        limit = float(np.sqrt(6.0 / max(1, fan_in + fan_out)))
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
        return (u * (2 * limit) - limit).to(dtype)


@dataclasses.dataclass
class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype):
        return torch.zeros(tuple(shape), dtype=dtype)


@dataclasses.dataclass
class OneInitializer(Initializer):
    def __call__(self, gen, shape, dtype):
        return torch.ones(tuple(shape), dtype=dtype)


@dataclasses.dataclass
class ConstantInitializer(Initializer):
    value: float = 0.0

    def __call__(self, gen, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=dtype)


@dataclasses.dataclass
class UniformInitializer(Initializer):
    """Uniform on [min_value, max_value), drawn in f32. `seed` is the
    reference's argument: the draws come from the generator handed in."""

    seed: int = 0
    min_value: float = 0.0
    max_value: float = 1.0

    def __call__(self, gen, shape, dtype):
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
        return (self.min_value + (self.max_value - self.min_value) * u
                ).to(dtype)


@dataclasses.dataclass
class NormInitializer(Initializer):
    """Normal with `mean` and `stddev`, drawn in f32. `seed` is the
    reference's argument: the draws come from the generator handed in."""

    seed: int = 0
    mean: float = 0.0
    stddev: float = 1.0

    def __call__(self, gen, shape, dtype):
        z = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (self.mean + self.stddev * z).to(dtype)


_BY_NAME = {"glorot_uniform": GlorotUniformInitializer(),
            "zero": ZeroInitializer(), "zeros": ZeroInitializer(),
            "one": OneInitializer(), "ones": OneInitializer(),
            "uniform": UniformInitializer(), "normal": NormInitializer(),
            "norm": NormInitializer()}


def get_initializer(spec) -> Initializer:
    if isinstance(spec, Initializer):
        return spec
    if spec in _BY_NAME:
        return _BY_NAME[spec]
    if isinstance(spec, str) and spec.startswith("constant:"):
        return ConstantInitializer(float(spec.split(":", 1)[1]))
    raise ValueError(f"initializer {spec!r} is not ported yet "
                     f"(have {sorted(_BY_NAME)})")
