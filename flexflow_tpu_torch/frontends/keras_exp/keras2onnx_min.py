"""Vendored minimal keras->ONNX conversion.

The PyTorch counterpart of flexflow_tpu/frontends/keras_exp/
keras2onnx_min.py. The reference's keras_exp frontend converts a LIVE
tf.keras model to ONNX through keras2onnx (python/flexflow/keras_exp/
models/model.py); neither tensorflow nor a converter is installed
everywhere (the H100 machine has neither). This module converts the
layer subset the reference's keras_exp examples use (Dense / Conv2D /
Max+AveragePooling2D / Flatten / Concatenate / Activation) from any
DUCK-TYPED functional keras model:

  * tensors expose `.shape` (sans batch) and `.source_layer`;
  * layers expose `.inbound` tensors, `.outputs` tensors, and the
    standard keras config attributes (units/filters/kernel_size/...).

The flexflow_tpu_torch.frontends.keras functional API satisfies this
contract. A real tf.keras model still goes through tf2onnx/keras2onnx
when those are installed.

Weights are initialized here (glorot-uniform kernels, zero biases:
keras's defaults) from `seed` and embedded as ONNX initializers, as a
converted tf.keras model ships its live weights. The graph it writes is
byte for byte the JAX package's converter's from the same seed (the
model's producer name names the package that wrote it).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..onnx import proto as P

_FLOAT = 1  # onnx TensorProto.FLOAT


def _glorot(rng: np.random.RandomState, shape, fan_in, fan_out):
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def _toposort(outputs):
    order, visited = [], set()

    def visit(t):
        layer = getattr(t, "source_layer", None)
        if layer is None or id(layer) in visited:
            return
        visited.add(id(layer))
        for it in layer.inbound:
            visit(it)
        order.append(layer)

    for out in outputs:
        visit(out)
    return order


_ACT_NODE = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
             "softmax": "Softmax"}


def keras_to_onnx(model, name: str = "keras_exp", seed: int = 0):
    """Functional keras-like model -> ONNX ModelProto (see module doc)."""
    rng = np.random.RandomState(seed)
    nodes: List = []
    inits: List = []
    names: Dict[int, str] = {}
    counter = [0]

    def fresh(prefix):
        counter[0] += 1
        return f"{prefix}_{counter[0]}"

    def tname(t):
        if id(t) not in names:
            names[id(t)] = fresh("t")
        return names[id(t)]

    def emit_activation(act, cur):
        if act is None or act in ("linear", "none"):
            return cur  # identity — keras's documented Dense default
        node_type = _ACT_NODE.get(act)
        if node_type is None:
            raise NotImplementedError(f"keras_to_onnx: activation {act!r}")
        out = fresh("act")
        nodes.append(P.make_node(node_type, [cur], [out]))
        return out

    graph_inputs = []
    # keras_exp's BaseModel binds graph inputs by the reference's
    # "input_<key>" naming (ONNXModelKeras env) — the caller supplies the
    # actual dict keys via model.input_keys; positional 1..N otherwise
    keys = getattr(model, "input_keys", None) or \
        list(range(1, len(model.inputs) + 1))
    for key, t in zip(keys, model.inputs):
        names[id(t)] = f"input_{key}"
        graph_inputs.append(P.make_tensor_value_info(
            names[id(t)], _FLOAT, ("N",) + tuple(t.shape)
        ))

    for layer in _toposort(model.outputs):
        cls = type(layer).__name__
        ins = [tname(t) for t in layer.inbound]
        out_t = layer.outputs[0]
        if cls == "Dense":
            in_dim = layer.inbound[0].shape[-1]
            w = _glorot(rng, (layer.units, in_dim), in_dim, layer.units)
            wn, cur = fresh("W"), fresh("gemm")
            inits.append(P.from_array(w, wn))
            gemm_in = [ins[0], wn]
            if layer.use_bias:
                bn = fresh("b")
                inits.append(P.from_array(
                    np.zeros(layer.units, np.float32), bn))
                gemm_in.append(bn)
            nodes.append(P.make_node("Gemm", gemm_in, [cur], transB=1))
            cur = emit_activation(layer.activation, cur)
        elif cls == "Conv2D":
            cin = layer.inbound[0].shape[0]
            kh, kw = layer.kernel_size
            fan_in = cin * kh * kw
            fan_out = layer.filters * kh * kw
            w = _glorot(rng, (layer.filters, cin // layer.groups, kh, kw),
                        fan_in, fan_out)
            wn, cur = fresh("W"), fresh("conv")
            inits.append(P.from_array(w, wn))
            conv_in = [ins[0], wn]
            if layer.use_bias:
                bn = fresh("b")
                inits.append(P.from_array(
                    np.zeros(layer.filters, np.float32), bn))
                conv_in.append(bn)
            ph, pw = layer._pads()
            nodes.append(P.make_node(
                "Conv", conv_in, [cur],
                kernel_shape=list(layer.kernel_size),
                strides=list(layer.strides),
                pads=[ph, pw, ph, pw],
                group=layer.groups,
            ))
            cur = emit_activation(layer.activation, cur)
        elif cls in ("MaxPooling2D", "AveragePooling2D"):
            op = "MaxPool" if cls == "MaxPooling2D" else "AveragePool"
            ph, pw = layer._pads()
            cur = fresh("pool")
            nodes.append(P.make_node(
                op, [ins[0]], [cur],
                kernel_shape=list(layer.pool_size),
                strides=list(layer.strides),
                pads=[ph, pw, ph, pw],
            ))
        elif cls == "Flatten":
            cur = fresh("flat")
            nodes.append(P.make_node("Flatten", [ins[0]], [cur]))
        elif cls == "Concatenate":
            cur = fresh("concat")
            nodes.append(P.make_node("Concat", ins, [cur],
                                     axis=layer.axis))
        elif cls == "Activation":
            cur = emit_activation(layer.activation, ins[0])
        else:
            raise NotImplementedError(
                f"keras_to_onnx: layer {cls} not in the vendored subset "
                "(Dense/Conv2D/Pooling/Flatten/Concatenate/Activation)"
            )
        names[id(out_t)] = cur

    graph_outputs = [
        P.make_tensor_value_info(tname(t), _FLOAT, ("N",) + tuple(t.shape))
        for t in model.outputs
    ]
    graph = P.make_graph(nodes, name, graph_inputs, graph_outputs,
                         initializer=inits)
    return P.make_model(graph)
