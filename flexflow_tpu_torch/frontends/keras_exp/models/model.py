"""Experimental Keras frontend models (reference:
python/flexflow/keras_exp/models/model.py: BaseModel drives FFModel from a
keras-exported ONNX graph; Model/Sequential wrap a tf.keras model).

The PyTorch counterpart of flexflow_tpu/frontends/keras_exp/models/
model.py. The reference hard-imports tensorflow + keras2onnx and
subclasses tf.keras.Model; here tensorflow is *gated*, as in the JAX
package: a functional model built with flexflow_tpu_torch.frontends.keras
layers converts through the vendored converter (keras2onnx_min, no
tensorflow needed); a tf.keras model converts through keras2onnx or
tf2onnx when importable; a pre-exported ONNX ``ModelProto`` (the port's
own codec, ``frontends/onnx/proto.py``) can be passed via
``onnx_model=``. The FFModel lowering (``ONNXModelKeras``) and the
training loop are the same either way.
"""
import time

from .... import obs
from ....core.model import FFModel
from ....config import FFConfig
from ...keras import losses as ff_keras_losses
from ...keras import metrics as ff_keras_metrics
from ...keras import optimizers as ff_keras_optimizer
from ...onnx.model import ONNXModelKeras
from .tensor import Tensor

_LOSSES = {
    "categorical_crossentropy": ff_keras_losses.CategoricalCrossentropy,
    "sparse_categorical_crossentropy":
        ff_keras_losses.SparseCategoricalCrossentropy,
    "mean_squared_error": ff_keras_losses.MeanSquaredError,
}

_METRICS = {
    "accuracy": ff_keras_metrics.Accuracy,
    "categorical_crossentropy": ff_keras_metrics.CategoricalCrossentropy,
    "sparse_categorical_crossentropy":
        ff_keras_metrics.SparseCategoricalCrossentropy,
    "mean_squared_error": ff_keras_metrics.MeanSquaredError,
    "root_mean_squared_error": ff_keras_metrics.RootMeanSquaredError,
    "mean_absolute_error": ff_keras_metrics.MeanAbsoluteError,
}


def _convert_optimizer(optimizer):
    """String / flexflow.keras / tf.keras optimizer → keras wrapper
    (reference: model.py compile()'s isinstance ladder over
    tf_keras_optimizer.SGD/Adam)."""
    if isinstance(optimizer, ff_keras_optimizer.Optimizer):
        return optimizer
    if isinstance(optimizer, str):
        assert optimizer in ("SGD", "Adam"), f"Unsupported optimizer {optimizer}"
        return (ff_keras_optimizer.SGD() if optimizer == "SGD"
                else ff_keras_optimizer.Adam())
    # duck-typed tf.keras optimizer: hyperparams are tf Variables with
    # .numpy(); plain floats also accepted
    def num(v, default):
        if v is None:
            return default
        return float(v.numpy()) if hasattr(v, "numpy") else float(v)

    kind = type(optimizer).__name__
    if kind == "SGD":
        return ff_keras_optimizer.SGD(
            learning_rate=num(getattr(optimizer, "learning_rate", None), 0.01),
            momentum=num(getattr(optimizer, "momentum", None), 0.0),
            nesterov=bool(getattr(optimizer, "nesterov", False)),
        )
    if kind == "Adam":
        return ff_keras_optimizer.Adam(
            learning_rate=num(getattr(optimizer, "learning_rate", None), 1e-3),
            beta_1=num(getattr(optimizer, "beta_1", None), 0.9),
            beta_2=num(getattr(optimizer, "beta_2", None), 0.999),
            epsilon=num(getattr(optimizer, "epsilon", None), 1e-8),
        )
    raise AssertionError(f"Unsupported optimizer {optimizer!r}")


class BaseModel:
    """reference: keras_exp/models/model.py BaseModel — owns the FFConfig/
    FFModel pair, lowers the ONNX graph in compile(), trains in fit()."""

    def __init__(self, inputs, onnx_model, ffconfig=None):
        self._ffconfig = ffconfig or FFConfig()
        self._ffmodel = None
        self._onnx_model = onnx_model
        self._input_tensors = [
            Tensor(ffconfig=self._ffconfig, key=key,
                   shape=tuple(inputs[key].shape),
                   dtype=getattr(inputs[key], "dtype", None))
            for key in inputs
        ]
        self._loss = None
        self._metrics = []
        self._my_onnx_model = None
        self._output_tensor = None

    # ------------------------------------------------------------------
    def compile(self, optimizer, loss=None, metrics=None, loss_weights=None,
                weighted_metrics=None, run_eagerly=None, comp_mode=None,
                **kwargs):
        assert loss_weights is None, "loss_weights is not supported"
        assert weighted_metrics is None, "weighted_metrics is not supported"
        assert run_eagerly is None, "run_eagerly is not supported"
        assert loss is not None, "loss is None"
        assert loss in _LOSSES, f"Unsupported loss {loss}"
        self._loss = _LOSSES[loss]()
        assert isinstance(metrics, list), "Metrics should be a list"
        self._metrics = []
        for m in metrics:
            assert m in _METRICS, f"Unsupported metric {m}"
            self._metrics.append(_METRICS[m]())

        self._ffmodel = FFModel(self._ffconfig)
        input_dict = {}
        for t in self._input_tensors:
            t.create_ff_tensor(self._ffmodel)
            # keras2onnx names graph inputs input_<key>; string keys that
            # already carry the graph name are used verbatim
            name = t.key if isinstance(t.key, str) else f"input_{t.key}"
            input_dict[name] = t.ffhandle
        self._my_onnx_model = ONNXModelKeras(self._onnx_model,
                                             self._ffconfig, self._ffmodel)
        self._output_tensor = self._my_onnx_model.apply(self._ffmodel,
                                                        input_dict)
        self._ffoptimizer = _convert_optimizer(optimizer)
        self._ffmodel.compile(
            optimizer=self._ffoptimizer.to_core(),
            loss_type=self._loss.type,
            metrics=[m.type for m in self._metrics],
        )
        self._my_onnx_model.load_weights(self._ffmodel)

    # ------------------------------------------------------------------
    def fit(self, x=None, y=None, batch_size=None, epochs=1, verbose=1,
            callbacks=None, validation_split=0.0, validation_data=None,
            shuffle=True, class_weight=None, sample_weight=None,
            initial_epoch=0, steps_per_epoch=None, **kwargs):
        assert validation_split == 0.0, "validation_split is not supported"
        assert validation_data is None, "validation_data is not supported"
        assert class_weight is None, "class_weight is not supported"
        assert sample_weight is None, "sample_weight is not supported"
        assert initial_epoch == 0, "initial_epoch is not supported"
        assert steps_per_epoch is None, "steps_per_epoch is not supported"
        assert self._output_tensor is not None, "call compile() first"
        if batch_size is not None:
            assert self._ffconfig.batch_size == batch_size, (
                "batch size is not correct use -b to set it"
            )
        xs = x if isinstance(x, list) else [x]
        assert len(xs) == len(self._input_tensors), "check len of input tensors"
        num_samples = xs[0].shape[0]
        cbs = list(callbacks or [])
        for cb in cbs:
            cb.set_model(self)
            cb.on_train_begin()
        start = time.time()
        pm = None
        for epoch in range(epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            pm = self._ffmodel.fit(xs, y, epochs=1, verbose=bool(verbose))
            logs = {
                "accuracy": pm.get_accuracy(),
                "loss": pm.sparse_cce_loss or pm.cce_loss or pm.mse_loss,
            }
            stop = False
            for cb in cbs:
                if cb.on_epoch_end(epoch, logs):
                    obs.progress(
                        f"Accuracy reaches, now early stop, epoch: {epoch}",
                        name="early_stop", epoch=epoch,
                    )
                    stop = True
            if stop:
                break
        run_time = time.time() - start
        iters = num_samples // self._ffconfig.batch_size
        obs.progress(
            f"epochs {epochs}, ELAPSED TIME = {run_time:.4f}s, "
            f"interations {iters}, samples {num_samples}, THROUGHPUT = "
            f"{num_samples * epochs / run_time:.2f} samples/s\n",
            name="fit_done", elapsed_s=run_time, samples=num_samples,
        )
        for cb in cbs:
            cb.on_train_end()
        return pm

    def evaluate(self, x=None, y=None, batch_size=None, **kwargs):
        xs = x if isinstance(x, list) else [x]
        return self._ffmodel.eval(xs, y, batch_size=batch_size)

    def summary(self):
        lines = [f"keras_exp model ({len(self._onnx_model.graph.node)} "
                 "onnx nodes)"]
        lines += [f"  {n.op_type}: {n.name}" for n in
                  self._onnx_model.graph.node]
        return "\n".join(lines)

    @property
    def ffmodel(self):
        return self._ffmodel


def _convert_tf_keras(model, name):
    """Live keras model → ONNX ModelProto. Duck-typed functional models
    (tensors expose .source_layer — flexflow_tpu_torch.frontends.keras; a real
    tf.keras model does not) go straight to the VENDORED minimal
    converter (keras2onnx_min — Dense/Conv2D/Pooling/Flatten/Concatenate/
    Activation, no tensorflow needed); feeding them to keras2onnx/tf2onnx
    would crash those converters. tf.keras models use the reference's
    ladder: keras2onnx → tf2onnx → informative error."""
    if all(getattr(t, "source_layer", None) is not None
           for t in model.outputs):
        try:
            from ..keras2onnx_min import keras_to_onnx

            return keras_to_onnx(model, name or "keras_exp")
        except NotImplementedError as e:
            raise ImportError(
                "flexflow.keras_exp could not convert this model: the "
                f"vendored converter says {e}; install tensorflow plus "
                "keras2onnx or tf2onnx for full-coverage conversion, or "
                "pass a pre-exported ModelProto via Model(..., onnx_model=...)"
            ) from e
    try:
        import keras2onnx  # noqa: F401

        return keras2onnx.convert_keras(model, name)
    except ImportError:
        pass
    try:
        import tensorflow as tf
        import tf2onnx

        spec = [tf.TensorSpec(t.shape, t.dtype) for t in model.inputs]
        proto, _ = tf2onnx.convert.from_keras(model, input_signature=spec)
        return proto
    except ImportError:
        pass
    raise ImportError(
        "flexflow.keras_exp needs keras2onnx or tf2onnx to convert a live "
        "tf.keras model; alternatively build the model with "
        "flexflow_tpu_torch.frontends.keras layers (vendored converter) or pass "
        "a pre-exported ModelProto via Model(..., onnx_model=...)"
    )


class _InputSpec:
    def __init__(self, shape, dtype=None):
        self.shape = shape
        self.dtype = dtype


class Model:
    """reference: keras_exp Model(tf_keras_Model) — here composition instead
    of inheritance so the no-TF path works; `inputs` is the reference's
    {key: input_tensor} dict."""

    def __init__(self, inputs, outputs=None, name=None, onnx_model=None,
                 ffconfig=None):
        assert isinstance(inputs, dict), "keras_exp Model wants {key: input}"
        if onnx_model is None:
            outs = (list(outputs) if isinstance(outputs, (list, tuple))
                    else [outputs])
            if all(getattr(t, "source_layer", None) is not None
                   for t in outs):
                # a functional graph built with flexflow_tpu_torch's own keras
                # frontend (or anything satisfying its tensor contract):
                # convert directly, no tensorflow required
                class _Holder:
                    pass

                live = _Holder()
                live.inputs = list(inputs.values())
                live.outputs = outs
                live.input_keys = list(inputs.keys())
                onnx_model = _convert_tf_keras(live, name)
                # our keras tensors carry sans-batch shapes; BaseModel's
                # Tensor expects the tf.keras (None, ...) convention
                inputs = {
                    k: _InputSpec(shape=(None,) + tuple(t.shape),
                                  dtype=getattr(t, "dtype", None))
                    for k, t in inputs.items()
                }
            else:
                try:
                    from tensorflow.keras import Model as TFModel
                except ImportError as e:
                    raise ImportError(
                        "tensorflow is not installed; build the model with "
                        "flexflow_tpu_torch.frontends.keras layers (the vendored "
                        "converter handles Dense/Conv2D/Pooling/Flatten/"
                        "Concatenate/Activation) or pass onnx_model= with "
                        "a pre-exported ONNX ModelProto"
                    ) from e
                tf_model = TFModel(inputs=list(inputs.values()),
                                   outputs=outputs, name=name)
                onnx_model = _convert_tf_keras(tf_model, name)
        self._base_model = BaseModel(inputs=inputs, onnx_model=onnx_model,
                                     ffconfig=ffconfig)

    def compile(self, optimizer, loss=None, metrics=None, **kwargs):
        self._base_model.compile(optimizer=optimizer, loss=loss,
                                 metrics=metrics, **kwargs)

    def fit(self, x=None, y=None, **kwargs):
        return self._base_model.fit(x=x, y=y, **kwargs)

    def evaluate(self, x=None, y=None, **kwargs):
        return self._base_model.evaluate(x=x, y=y, **kwargs)

    def summary(self):
        return self._base_model.summary()

    @property
    def ffmodel(self):
        return self._base_model.ffmodel


class Sequential(Model):
    """reference keras_exp exports Sequential alongside Model; a sequential
    tf.keras model converts through the same ONNX path."""

    def __init__(self, layers=None, name=None, onnx_model=None, inputs=None,
                 ffconfig=None):
        if onnx_model is None:
            try:
                from tensorflow.keras import Sequential as TFSequential
            except ImportError as e:
                raise ImportError(
                    "tensorflow is not installed; pass onnx_model= (and "
                    "inputs=) with a pre-exported ONNX ModelProto"
                ) from e
            tf_model = TFSequential(layers=layers, name=name)
            inputs = {i: t for i, t in enumerate(tf_model.inputs, start=1)}
            onnx_model = _convert_tf_keras(tf_model, name)
        assert inputs is not None, "Sequential(onnx_model=...) needs inputs="
        self._base_model = BaseModel(inputs=inputs, onnx_model=onnx_model,
                                     ffconfig=ffconfig)
