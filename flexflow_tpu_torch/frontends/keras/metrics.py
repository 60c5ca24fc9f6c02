"""Keras-style metric objects (reference: python/flexflow/keras/metrics.py).

Each carries a `.type` MetricsType consumed by `Model.compile(metrics=[...])`.
"""
from __future__ import annotations

from ...ff_types import MetricsType

__all__ = [
    "Metric",
    "Accuracy",
    "CategoricalCrossentropy",
    "SparseCategoricalCrossentropy",
    "MeanSquaredError",
    "RootMeanSquaredError",
    "MeanAbsoluteError",
]


class Metric:
    def __init__(self, name=None, dtype=None, **kwargs):
        self.name = name
        self.dtype = dtype
        self.type: MetricsType | None = None


class Accuracy(Metric):
    def __init__(self, name="accuracy", dtype=None):
        super().__init__(name=name, dtype=dtype)
        self.type = MetricsType.METRICS_ACCURACY


class CategoricalCrossentropy(Metric):
    def __init__(self, name="categorical_crossentropy", dtype=None,
                 from_logits=False, label_smoothing=0):
        super().__init__(name=name, dtype=dtype)
        self.type = MetricsType.METRICS_CATEGORICAL_CROSSENTROPY


class SparseCategoricalCrossentropy(Metric):
    def __init__(self, name="sparse_categorical_crossentropy", dtype=None,
                 from_logits=False, axis=1):
        super().__init__(name=name, dtype=dtype)
        self.type = MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY


class MeanSquaredError(Metric):
    def __init__(self, name="mean_squared_error", dtype=None):
        super().__init__(name=name, dtype=dtype)
        self.type = MetricsType.METRICS_MEAN_SQUARED_ERROR


class RootMeanSquaredError(Metric):
    def __init__(self, name="root_mean_squared_error", dtype=None):
        super().__init__(name=name, dtype=dtype)
        self.type = MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR


class MeanAbsoluteError(Metric):
    def __init__(self, name="mean_absolute_error", dtype=None):
        super().__init__(name=name, dtype=dtype)
        self.type = MetricsType.METRICS_MEAN_ABSOLUTE_ERROR
