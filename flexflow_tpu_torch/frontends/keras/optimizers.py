"""Keras-style optimizer wrappers (reference:
python/flexflow/keras/optimizers.py)."""
from __future__ import annotations

import dataclasses

from ...core.optimizers import AdamOptimizer, SGDOptimizer


class Optimizer:
    def to_core(self):
        raise NotImplementedError


@dataclasses.dataclass
class SGD(Optimizer):
    learning_rate: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def to_core(self):
        return SGDOptimizer(
            lr=self.learning_rate,
            momentum=self.momentum,
            nesterov=self.nesterov,
            weight_decay=self.weight_decay,
        )


@dataclasses.dataclass
class Adam(Optimizer):
    learning_rate: float = 0.001
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-8

    def to_core(self):
        return AdamOptimizer(
            alpha=self.learning_rate,
            beta1=self.beta_1,
            beta2=self.beta_2,
            epsilon=self.epsilon,
        )
