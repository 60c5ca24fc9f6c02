"""Keras-style callbacks (reference: python/flexflow/keras/callbacks.py —
Callback, LambdaCallback, VerifyMetrics, EpochVerifyMetrics)."""
from __future__ import annotations

from typing import Callable, Optional


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass


class LambdaCallback(Callback):
    """reference: keras/callbacks.py LambdaCallback"""

    def __init__(
        self,
        on_epoch_begin: Optional[Callable] = None,
        on_epoch_end: Optional[Callable] = None,
        on_train_begin: Optional[Callable] = None,
        on_train_end: Optional[Callable] = None,
        on_batch_begin: Optional[Callable] = None,
        on_batch_end: Optional[Callable] = None,
    ):
        if on_epoch_begin:
            self.on_epoch_begin = on_epoch_begin
        if on_epoch_end:
            self.on_epoch_end = on_epoch_end
        if on_train_begin:
            self.on_train_begin = lambda logs=None: on_train_begin()
        if on_train_end:
            self.on_train_end = lambda logs=None: on_train_end()
        if on_batch_begin:
            self.on_batch_begin = on_batch_begin
        if on_batch_end:
            self.on_batch_end = on_batch_end


class VerifyMetrics(Callback):
    """Asserts final accuracy reaches a threshold (reference:
    keras/callbacks.py VerifyMetrics + examples accuracy.py ModelAccuracy)."""

    def __init__(self, accuracy_threshold):
        # the reference passes ModelAccuracy enum members; unwrap to the
        # numeric threshold (examples accuracy.py ModelAccuracy.value)
        self.threshold = getattr(accuracy_threshold, "value",
                                 accuracy_threshold)

    def on_train_end(self, logs=None):
        pm = self.model.ffmodel.get_perf_metrics()
        acc = pm.get_accuracy()
        if acc < self.threshold:
            raise AssertionError(
                f"accuracy {acc:.2f}% below threshold {self.threshold}%")


class EpochVerifyMetrics(Callback):
    """Asserts accuracy threshold reached by some epoch (reference:
    keras/callbacks.py EpochVerifyMetrics)."""

    def __init__(self, accuracy_threshold):
        self.threshold = getattr(accuracy_threshold, "value",
                                 accuracy_threshold)
        self.best = 0.0

    def on_epoch_end(self, epoch, logs=None):
        if logs and "accuracy" in logs:
            self.best = max(self.best, logs["accuracy"])

    def on_train_end(self, logs=None):
        if self.best < self.threshold:
            raise AssertionError(
                f"best epoch accuracy {self.best:.2f}% below "
                f"{self.threshold}%")


class LearningRateScheduler(Callback):
    """Per-epoch rate schedule (reference: keras/callbacks.py
    LearningRateScheduler; examples/python/keras/callback.py): sets the
    compiled optimizer's rate at each epoch's start
    (FFModel.set_learning_rate, which drops the captured train scans that
    hold the old rate)."""

    def __init__(self, schedule):
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        ffmodel = getattr(self.model, "ffmodel", self.model)
        ffmodel.set_learning_rate(self.schedule(epoch))
