"""Keras-style loss objects (reference: python/flexflow/keras/losses.py).

Each carries a `.type` LossType consumed by `Model.compile(loss=...)`;
`from_logits`/`reduction`/`label_smoothing` are accepted for API parity (the
reference ignores them too — its loss kernels are fixed-function).
"""
from __future__ import annotations

from ...ff_types import LossType

__all__ = [
    "Loss",
    "CategoricalCrossentropy",
    "SparseCategoricalCrossentropy",
    "MeanSquaredError",
    "Identity",
]


class Loss:
    def __init__(self, name=None):
        self.type: LossType | None = None
        self.name = name


class CategoricalCrossentropy(Loss):
    def __init__(self, from_logits=False, label_smoothing=0, reduction="auto",
                 name="categorical_crossentropy"):
        super().__init__(name=name)
        self.type = LossType.LOSS_CATEGORICAL_CROSSENTROPY


class SparseCategoricalCrossentropy(Loss):
    def __init__(self, from_logits=False, reduction="auto",
                 name="sparse_categorical_crossentropy"):
        super().__init__(name=name)
        self.type = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY


class MeanSquaredError(Loss):
    def __init__(self, reduction="auto", name="mean_squared_error"):
        super().__init__(name=name)
        self.type = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE


class Identity(Loss):
    def __init__(self, reduction="auto", name="identity"):
        super().__init__(name=name)
        self.type = LossType.LOSS_IDENTITY
