"""Keras-compatible layer classes.

The PyTorch counterpart of flexflow_tpu/frontends/keras/layers.py
(reference: python/flexflow/keras/layers/: Conv2D, Dense, Embedding,
pooling, merge, normalization, attention). Layers are deferred configs;
calling one on a KerasTensor records an edge; a Model's compile replays
the graph through the port's FFModel methods (reference:
keras/models/base_model.py compile -> _create_flexflow_layers).

Shapes are channels-first like the reference's Keras examples
(Input(shape=(3,32,32))), batch dim implicit until compile.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...ff_types import ActiMode, AggrMode, DataType, PoolType, to_data_type

_uid = itertools.count(1)


class KerasTensor:
    def __init__(self, shape: Tuple[int, ...], source_layer=None,
                 source_idx: int = 0):
        self.shape = tuple(shape)  # without batch dim
        self.source_layer = source_layer
        self.source_idx = source_idx

    def __repr__(self):
        return f"KerasTensor{self.shape}"


class Layer:
    """Base deferred layer (reference: keras/layers/base_layer.py). After
    the model's compile, `get_weights`/`set_weights` read and write the
    FFModel layer's weights (set in place, through Tensor.set_tensor)."""

    def __init__(self, name: Optional[str] = None, input_shape=None, **kwargs):
        self.name = name or f"{type(self).__name__.lower()}_{next(_uid)}"
        self.inbound: List[KerasTensor] = []
        self.outputs: List[KerasTensor] = []
        # keras-style: first Sequential layer may declare its input shape
        self.input_shape = (tuple(input_shape) if input_shape is not None
                            else None)
        self._ff_tensors = None  # set during model build

    def __call__(self, inputs):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.inbound = list(ins)
        out_shapes = self.compute_output_shape([t.shape for t in ins])
        self.outputs = [
            KerasTensor(s, source_layer=self, source_idx=i)
            for i, s in enumerate(out_shapes)
        ]
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs

    # subclass API ------------------------------------------------------
    def compute_output_shape(self, input_shapes) -> List[Tuple[int, ...]]:
        return [input_shapes[0]]

    def build_ff(self, ffmodel, ff_inputs):
        raise NotImplementedError

    # weight access (reference: keras layer get/set_weights)
    def get_weights(self, ffmodel=None):
        layer = self._ff_layer
        return [w.get_tensor(None) for w in layer.weights]

    def set_weights(self, weights):
        layer = self._ff_layer
        for wt, val in zip(layer.weights, weights):
            wt.set_tensor(None, np.asarray(val))


def Input(shape: Sequence[int], dtype=DataType.DT_FLOAT,
          name: str = "") -> KerasTensor:
    """reference: keras input_layer.Input (string dtypes accepted, as in
    keras)"""
    t = KerasTensor(tuple(shape), source_layer=None)
    t.dtype = to_data_type(dtype)
    return t


def _init_or_none(init):
    """Map keras initializer specs to core ones. `DefaultInitializer` (and
    the stock string defaults) mean "layer default" → None."""
    if init is None or type(init).__name__ == "DefaultInitializer":
        # the layer's WeightSpec default (glorot kernel, zero bias)
        return None
    return init  # strings resolve via core get_initializer (_BY_NAME)


def _acti(activation) -> ActiMode:
    if activation in (None, "linear", "none"):
        return ActiMode.AC_MODE_NONE
    if isinstance(activation, ActiMode):
        return activation
    return {
        "relu": ActiMode.AC_MODE_RELU,
        "sigmoid": ActiMode.AC_MODE_SIGMOID,
        "tanh": ActiMode.AC_MODE_TANH,
        "gelu": ActiMode.AC_MODE_GELU,
        "softmax": "softmax",  # handled by Dense/Activation specially
    }[activation]


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias=True,
                 kernel_initializer="glorot_uniform", bias_initializer="zeros",
                 kernel_regularizer=None, **kw):
        super().__init__(**kw)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer

    def compute_output_shape(self, shapes):
        return [tuple(shapes[0][:-1]) + (self.units,)]

    def build_ff(self, ffmodel, ff_inputs):
        act = self.activation
        softmax = act == "softmax"
        t = ffmodel.dense(
            ff_inputs[0],
            self.units,
            _acti(None if softmax else act),
            use_bias=self.use_bias,
            kernel_initializer=_init_or_none(self.kernel_initializer),
            bias_initializer=_init_or_none(self.bias_initializer),
            kernel_regularizer=self.kernel_regularizer,
            name=self.name,
        )
        if softmax:
            t = ffmodel.softmax(t)
        self._ff_layer = ffmodel.layers[-2] if softmax else ffmodel.layers[-1]
        return [t]


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, use_bias=True, groups=1,
                 **kw):
        super().__init__(**kw)
        self.filters = filters
        self.kernel_size = (
            (kernel_size, kernel_size) if isinstance(kernel_size, int)
            else tuple(kernel_size)
        )
        self.strides = ((strides, strides) if isinstance(strides, int)
                        else tuple(strides))
        self.padding = padding
        self.activation = activation
        self.use_bias = use_bias
        self.groups = groups

    def _pads(self):
        if self.padding == "same":
            return self.kernel_size[0] // 2, self.kernel_size[1] // 2
        if self.padding == "valid":
            return 0, 0
        ph, pw = (self.padding if isinstance(self.padding, tuple)
                  else (self.padding,) * 2)
        return ph, pw

    def compute_output_shape(self, shapes):
        c, h, w = shapes[0]
        ph, pw = self._pads()
        oh = (h + 2 * ph - self.kernel_size[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.kernel_size[1]) // self.strides[1] + 1
        return [(self.filters, oh, ow)]

    def build_ff(self, ffmodel, ff_inputs):
        ph, pw = self._pads()
        t = ffmodel.conv2d(
            ff_inputs[0], self.filters,
            self.kernel_size[0], self.kernel_size[1],
            self.strides[0], self.strides[1], ph, pw,
            _acti(self.activation), groups=self.groups,
            use_bias=self.use_bias, name=self.name,
        )
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class _Pool2D(Layer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid", **kw):
        super().__init__(**kw)
        self.pool_size = (
            (pool_size, pool_size) if isinstance(pool_size, int)
            else tuple(pool_size)
        )
        self.strides = (
            self.pool_size if strides is None
            else ((strides, strides) if isinstance(strides, int)
                  else tuple(strides))
        )
        self.padding = padding

    def _pads(self):
        if self.padding == "same":
            return self.pool_size[0] // 2, self.pool_size[1] // 2
        return 0, 0

    def compute_output_shape(self, shapes):
        c, h, w = shapes[0]
        ph, pw = self._pads()
        oh = (h + 2 * ph - self.pool_size[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.pool_size[1]) // self.strides[1] + 1
        return [(c, oh, ow)]

    def build_ff(self, ffmodel, ff_inputs):
        ph, pw = self._pads()
        t = ffmodel.pool2d(
            ff_inputs[0], self.pool_size[0], self.pool_size[1],
            self.strides[0], self.strides[1], ph, pw,
            pool_type=self.pool_type, name=self.name,
        )
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class MaxPooling2D(_Pool2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(_Pool2D):
    pool_type = PoolType.POOL_AVG


class Flatten(Layer):
    def compute_output_shape(self, shapes):
        return [(int(np.prod(shapes[0])),)]

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.flat(ff_inputs[0], name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Activation(Layer):
    def __init__(self, activation, **kw):
        super().__init__(**kw)
        self.activation = activation

    def build_ff(self, ffmodel, ff_inputs):
        a = self.activation
        x = ff_inputs[0]
        if a == "softmax":
            t = ffmodel.softmax(x, name=self.name)
        elif a == "relu":
            t = ffmodel.relu(x, name=self.name)
        elif a == "sigmoid":
            t = ffmodel.sigmoid(x, name=self.name)
        elif a == "tanh":
            t = ffmodel.tanh(x, name=self.name)
        elif a == "gelu":
            t = ffmodel.gelu(x, name=self.name)
        elif a == "elu":
            t = ffmodel.elu(x, name=self.name)
        else:
            raise ValueError(f"unknown activation {a}")
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Dropout(Layer):
    def __init__(self, rate, seed=0, **kw):
        super().__init__(**kw)
        self.rate = rate
        self.seed = seed

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.dropout(ff_inputs[0], self.rate, self.seed, name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class BatchNormalization(Layer):
    def __init__(self, momentum=0.9, epsilon=1e-5, relu=False, **kw):
        super().__init__(**kw)
        self.momentum = momentum
        self.epsilon = epsilon
        self.relu = relu

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.batch_norm(ff_inputs[0], relu=self.relu, name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class LayerNormalization(Layer):
    def __init__(self, axis=-1, epsilon=1e-5, **kw):
        super().__init__(**kw)
        self.axis = axis if isinstance(axis, (list, tuple)) else (axis,)
        self.epsilon = epsilon

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.layer_norm(
            ff_inputs[0], axes=tuple(self.axis), eps=self.epsilon,
            name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Embedding(Layer):
    def __init__(self, input_dim, output_dim, **kw):
        super().__init__(**kw)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def compute_output_shape(self, shapes):
        return [tuple(shapes[0]) + (self.output_dim,)]

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.embedding(
            ff_inputs[0], self.input_dim, self.output_dim,
            AggrMode.AGGR_MODE_NONE, name=self.name,
        )
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Reshape(Layer):
    def __init__(self, target_shape, **kw):
        super().__init__(**kw)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, shapes):
        return [self.target_shape]

    def build_ff(self, ffmodel, ff_inputs):
        batch = ff_inputs[0].dims[0]
        t = ffmodel.reshape(ff_inputs[0], (batch,) + self.target_shape,
                            name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Permute(Layer):
    """reference: python/flexflow/keras/layers/core.py Permute — dims are
    1-indexed over non-batch axes, Keras semantics."""

    def __init__(self, dims, **kw):
        super().__init__(**kw)
        self.dims = tuple(dims)

    def compute_output_shape(self, shapes):
        (s,) = shapes
        return [tuple(s[d - 1] for d in self.dims)]

    def build_ff(self, ffmodel, ff_inputs):
        perm = (0,) + tuple(d for d in self.dims)  # batch stays in front
        t = ffmodel.transpose(ff_inputs[0], perm, name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class _Merge(Layer):
    op = None

    def compute_output_shape(self, shapes):
        return [tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))]

    def build_ff(self, ffmodel, ff_inputs):
        t = ff_inputs[0]
        for other in ff_inputs[1:]:
            t = getattr(ffmodel, self.op)(t, other, name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Add(_Merge):
    op = "add"


class Subtract(_Merge):
    op = "subtract"


class Multiply(_Merge):
    op = "multiply"


class Maximum(_Merge):
    op = "max"


class Minimum(_Merge):
    op = "min"


class Concatenate(Layer):
    def __init__(self, axis=1, **kw):
        super().__init__(**kw)
        self.axis = axis  # axis includes batch dim at 0, like keras

    def compute_output_shape(self, shapes):
        ax = self.axis - 1 if self.axis > 0 else len(shapes[0]) + self.axis
        out = list(shapes[0])
        out[ax] = sum(s[ax] for s in shapes)
        return [tuple(out)]

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.concat(list(ff_inputs), self.axis, name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class MultiHeadAttention(Layer):
    """reference: keras multihead attention example
    (examples/python/keras/func_multihead_attention.py semantics)."""

    def __init__(self, num_heads, key_dim, dropout=0.0, use_bias=True, **kw):
        super().__init__(**kw)
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.dropout = dropout
        self.use_bias = use_bias

    def compute_output_shape(self, shapes):
        return [shapes[0]]

    def build_ff(self, ffmodel, ff_inputs):
        q = ff_inputs[0]
        k = ff_inputs[1] if len(ff_inputs) > 1 else q
        v = ff_inputs[2] if len(ff_inputs) > 2 else k
        embed = q.dims[-1]
        t = ffmodel.multihead_attention(
            q, k, v, embed, self.num_heads, self.key_dim, self.key_dim,
            dropout=self.dropout, bias=self.use_bias, name=self.name,
        )
        self._ff_layer = ffmodel.layers[-1]
        return [t]


def concatenate(inputs, axis=1, name=""):
    """Functional alias (reference: keras/layers/merge.py `concatenate`)."""
    return Concatenate(axis=axis, name=name)(inputs)


# ---------------------------------------------------------------------------
# Backend op layers (reference: python/flexflow/keras/backend/internal.py —
# BatchMatmul/Sin/Cos/Exp/Pow/ReduceSum/Rsqrt/Gather layer classes backing
# the K.* functional API)
# ---------------------------------------------------------------------------

class _UnaryOp(Layer):
    _ff_call = ""

    def build_ff(self, ffmodel, ff_inputs):
        t = getattr(ffmodel, self._ff_call)(ff_inputs[0], name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Sin(_UnaryOp):
    _ff_call = "sin"


class Cos(_UnaryOp):
    _ff_call = "cos"


class Exp(_UnaryOp):
    _ff_call = "exp"


class Rsqrt(_UnaryOp):
    _ff_call = "rsqrt"


class Pow(Layer):
    def __init__(self, a: float, **kw):
        super().__init__(**kw)
        self.a = float(a)

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.pow(ff_inputs[0], self.a, name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class ReduceSum(Layer):
    """K.sum over non-batch axes (axis counts the batch dim, like keras)."""

    def __init__(self, axis, keepdims: bool = False, **kw):
        super().__init__(**kw)
        self.axis = [axis] if isinstance(axis, int) else list(axis)
        self.keepdims = keepdims

    def compute_output_shape(self, shapes):
        shape = list(shapes[0])
        # self.axis includes the batch dim at 0; tensor shape here excludes
        # it. Negative axes count from the end of the full (batched) shape.
        rank = len(shape) + 1
        drop = sorted((a if a >= 0 else rank + a) - 1 for a in self.axis)
        if self.keepdims:
            for a in drop:
                shape[a] = 1
        else:
            for a in reversed(drop):
                del shape[a]
        return [tuple(shape)]

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.reduce_sum(
            ff_inputs[0], self.axis, keepdims=self.keepdims, name=self.name
        )
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class Gather(Layer):
    """torch.gather semantics (reference internal.py Gather ->
    ffmodel.gather)."""

    def __init__(self, axis: int, **kw):
        super().__init__(**kw)
        self.axis = axis

    def compute_output_shape(self, shapes):
        return [shapes[1]]

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.gather(ff_inputs[0], ff_inputs[1], self.axis,
                           name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


class BatchMatmul(Layer):
    def compute_output_shape(self, shapes):
        a, b = shapes
        return [tuple(a[:-1]) + (b[-1],)]

    def build_ff(self, ffmodel, ff_inputs):
        t = ffmodel.batch_matmul(ff_inputs[0], ff_inputs[1], name=self.name)
        self._ff_layer = ffmodel.layers[-1]
        return [t]


# functional merge aliases (reference: keras/layers/merge.py:63-132)

def add(inputs, name=""):
    return Add(name=name)(inputs)


def subtract(inputs, name=""):
    return Subtract(name=name)(inputs)


def multiply(inputs, name=""):
    return Multiply(name=name)(inputs)


# python operators on KerasTensor (the reference's tensor wrappers support
# `x + y` in examples, e.g. examples/python/keras/rsqrt.py)
KerasTensor.__add__ = lambda self, other: Add()([self, other])
KerasTensor.__sub__ = lambda self, other: Subtract()([self, other])
KerasTensor.__mul__ = lambda self, other: Multiply()([self, other])
