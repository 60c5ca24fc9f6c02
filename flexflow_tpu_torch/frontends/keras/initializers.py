"""Keras-style initializer classes (reference: python/flexflow/keras/
initializers.py:18-57 — DefaultInitializer/Zeros/GlorotUniform/
RandomUniform/RandomNormal).

Thin aliases of the port's core initializers (core/initializers.py) with
the reference's Keras constructor signatures, accepted anywhere a layer
takes `kernel_initializer=`/`bias_initializer=`. `seed` is the reference's
argument: the draws come from the generator the executor seeds from
FFConfig.seed.
"""
from __future__ import annotations

from ...core.initializers import (
    GlorotUniformInitializer,
    Initializer,
    NormInitializer,
    UniformInitializer,
    ZeroInitializer,
)

__all__ = [
    "Initializer",
    "DefaultInitializer",
    "Zeros",
    "GlorotUniform",
    "RandomUniform",
    "RandomNormal",
]


class DefaultInitializer:
    """Marker: let the layer pick its default (reference
    initializers.py:26)."""

    def __repr__(self):
        return "DefaultInitializer()"


class Zeros(ZeroInitializer):
    def __init__(self):
        super().__init__()


class GlorotUniform(GlorotUniformInitializer):
    def __init__(self, seed: int = 0):
        super().__init__()
        self.seed = seed


class RandomUniform(UniformInitializer):
    def __init__(self, seed: int = 0, minval: float = -0.05,
                 maxval: float = 0.05):
        super().__init__(seed=seed, min_value=minval, max_value=maxval)


class RandomNormal(NormInitializer):
    def __init__(self, seed: int = 0, mean: float = 0.0, stddev: float = 0.05):
        super().__init__(seed=seed, mean=mean, stddev=stddev)
