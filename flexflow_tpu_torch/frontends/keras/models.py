"""Keras-compatible Model / Sequential.

The PyTorch counterpart of flexflow_tpu/frontends/keras/models.py
(reference: python/flexflow/keras/models/base_model.py:128 compile, :198
fit; sequential.py, model.py): traverse the deferred Keras layer graph,
replay it through the port's FFModel, then hand compile/fit/evaluate/
predict to it.

A Model's `ffconfig` is an FFConfig that reads the process's argv, as the
JAX package's does, and names the first card: the card is resolved when
`compile` builds the FFModel, so a caller on a machine without one sets
`model.ffconfig.device = "cpu"` first, and compile raises otherwise.
Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ...config import FFConfig, default_device
from ...core.model import FFModel
from ...ff_types import DataType, LossType, MetricsType
from .layers import Input, KerasTensor, Layer
from .optimizers import SGD, Adam
from .optimizers import Optimizer as KerasOptimizer


_LOSS_MAP = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "identity": LossType.LOSS_IDENTITY,
}

_METRIC_MAP = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "sparse_categorical_crossentropy":
        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
    # Keras short aliases
    "acc": MetricsType.METRICS_ACCURACY,
    "mse": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "rmse": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mae": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}


def _unresolved_config() -> FFConfig:
    """An FFConfig read from argv like FFConfig()'s, its device the
    process's default (config.default_device: the first card unless a
    script runner set another), not yet resolved (FFConfig(device="cuda")
    raises at once on a machine without a card): FFModel resolves it at
    compile."""
    cfg = FFConfig(device="cpu")
    cfg.device = default_device()
    return cfg


class Model:
    """Functional-API model (reference: keras/models/model.py)."""

    def __init__(self, inputs=None, outputs=None, name: str = "model"):
        self.name = name
        self.inputs: List[KerasTensor] = (
            list(inputs) if isinstance(inputs, (list, tuple))
            else ([inputs] if inputs else [])
        )
        self.outputs: List[KerasTensor] = (
            list(outputs) if isinstance(outputs, (list, tuple))
            else ([outputs] if outputs else [])
        )
        self.ffmodel: Optional[FFModel] = None
        self.ffconfig = _unresolved_config()
        self._callbacks = []

    # -- graph replay ----------------------------------------------------
    def _toposort_layers(self) -> List[Layer]:
        order: List[Layer] = []
        visited = set()

        def visit(t: KerasTensor):
            layer = t.source_layer
            if layer is None or id(layer) in visited:
                return
            visited.add(id(layer))
            for it in layer.inbound:
                visit(it)
            order.append(layer)

        for out in self.outputs:
            visit(out)
        return order

    def _build_ff(self, batch_size: int):
        self.ffconfig.batch_size = batch_size
        ffmodel = FFModel(self.ffconfig)
        tensor_of = {}
        for kt in self.inputs:
            dtype = getattr(kt, "dtype", DataType.DT_FLOAT)
            tensor_of[id(kt)] = ffmodel.create_tensor(
                (batch_size,) + kt.shape, dtype
            )
        for layer in self._toposort_layers():
            ff_ins = [tensor_of[id(t)] for t in layer.inbound]
            outs = layer.build_ff(ffmodel, ff_ins)
            for kt, ft in zip(layer.outputs, outs):
                tensor_of[id(kt)] = ft
        self.ffmodel = ffmodel
        return ffmodel

    # -- keras API -------------------------------------------------------
    def compile(self, optimizer="sgd", loss=None, metrics=(),
                batch_size=None, **kw):
        """reference: base_model.py:128"""
        bs = batch_size or self.ffconfig.batch_size
        ffmodel = self._build_ff(bs)
        if isinstance(optimizer, str):
            optimizer = {"sgd": SGD(), "adam": Adam()}[optimizer.lower()]
        core_opt = (
            optimizer.to_core() if isinstance(optimizer, KerasOptimizer)
            else optimizer
        )
        # strings, LossType/MetricsType enums, or keras loss/metric objects
        # carrying `.type` (losses.py / metrics.py) are all accepted
        if isinstance(loss, str):
            loss_type = _LOSS_MAP[loss]
        elif hasattr(loss, "type") and loss.type is not None:
            loss_type = loss.type
        else:
            loss_type = loss
        ms = []
        for m in metrics:
            if isinstance(m, str):
                ms.append(_METRIC_MAP[m])
            elif hasattr(m, "type") and not isinstance(m, MetricsType):
                ms.append(m.type)
            else:
                ms.append(m)
        ffmodel.compile(optimizer=core_opt, loss_type=loss_type, metrics=ms)
        return self

    def fit(self, x=None, y=None, batch_size=None, epochs=1, verbose=True,
            callbacks=None, **kw):
        """reference: base_model.py:198"""
        if self.ffmodel is None:
            raise RuntimeError("call compile() first")
        cbs = list(callbacks or [])
        for cb in cbs:
            cb.set_model(self)
            cb.on_train_begin()
        pm = None
        for epoch in range(epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            pm = self.ffmodel.fit(x, y, batch_size=batch_size, epochs=1,
                                  verbose=verbose)
            logs = {
                "accuracy": pm.get_accuracy(),
                "loss": pm.sparse_cce_loss or pm.cce_loss or pm.mse_loss,
            }
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
        for cb in cbs:
            cb.on_train_end()
        return pm

    def evaluate(self, x=None, y=None, batch_size=None, **kw):
        return self.ffmodel.eval(x, y, batch_size=batch_size)

    def predict(self, x, batch_size=None, **kw):
        return self.ffmodel.predict(x, batch_size=batch_size)

    def summary(self) -> str:
        lines = [f'Model: "{self.name}"', "_" * 60]
        for layer in self._toposort_layers():
            shapes = [t.shape for t in layer.outputs]
            lines.append(f"{layer.name:<30}{type(layer).__name__:<18}{shapes}")
        text = "\n".join(lines)
        # keras API parity: Model.summary() prints by contract
        print(text)
        return text

    def __call__(self, inputs):
        """Use a built model as a layer (reference: nested-model examples,
        e.g. examples/python/keras/seq_mnist_cnn_nested.py — a Sequential /
        functional Model is wired into another model's graph). Re-wires this
        model's layers onto the given input tensors and returns the mapped
        output tensor(s)."""
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        if len(ins) != len(self.inputs):
            raise ValueError(f"model {self.name} expects {len(self.inputs)} "
                             f"inputs, got {len(ins)}")
        if getattr(self, "_called_as_layer", False):
            # Layer objects are re-wired in place, so a second call would
            # corrupt the graph built by the first (no keras-style layer
            # sharing). Fail loudly instead of silently mis-building.
            raise NotImplementedError(
                f"model {self.name} was already called on tensors once; "
                "re-calling a model (weight sharing) is not supported — "
                "build a fresh model instead"
            )
        self._called_as_layer = True
        mapping = {id(kt): new for kt, new in zip(self.inputs, ins)}
        order = self._toposort_layers()
        old_model_outs = list(self.outputs)
        for layer in order:
            old_outs = list(layer.outputs)
            new_ins = [mapping[id(t)] for t in layer.inbound]
            res = layer(new_ins if len(new_ins) > 1 else new_ins[0])
            new_outs = res if isinstance(res, (list, tuple)) else [res]
            for o, n in zip(old_outs, new_outs):
                mapping[id(o)] = n
        new_model_outs = [mapping[id(o)] for o in old_model_outs]
        self.inputs = list(ins)
        self.outputs = new_model_outs
        return (new_model_outs[0] if len(new_model_outs) == 1
                else new_model_outs)

    @property
    def layers(self) -> List[Layer]:
        return self._toposort_layers()

    def get_layer(self, name: Optional[str] = None,
                  index: Optional[int] = None):
        """reference: base_model.py get_layer(name=, index=) — used by the
        net2net examples to pull teacher weights."""
        layers = self._toposort_layers()
        if index is not None:
            return layers[index]
        for layer in layers:
            if layer.name == name:
                return layer
        raise ValueError(f"no layer named {name!r}")


class Sequential(Model):
    """reference: keras/models/sequential.py"""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name="sequential"):
        super().__init__(name=name)
        self._stack: List[Layer] = []
        for l in layers or []:
            self.add(l)

    def add(self, layer_or_input):
        if isinstance(layer_or_input, KerasTensor):
            self.inputs = [layer_or_input]
            self._last = layer_or_input
            return
        if isinstance(layer_or_input, Model):
            # nested model (reference: seq_mnist_cnn_nested.py)
            m = layer_or_input
            if not self.inputs:
                self.inputs = list(m.inputs)
                self._last = m.outputs[0]
            else:
                self._last = m(self._last)
            self.outputs = [self._last]
            return
        if not self.inputs:
            # first layer must declare input_shape
            shape = getattr(layer_or_input, "input_shape", None)
            if shape is None:
                raise ValueError("the first Sequential layer needs "
                                 "input_shape= or add(Input(...))")
            inp = Input(shape)
            self.inputs = [inp]
            self._last = inp
        self._stack.append(layer_or_input)
        self._last = layer_or_input(self._last)
        self.outputs = [self._last]
