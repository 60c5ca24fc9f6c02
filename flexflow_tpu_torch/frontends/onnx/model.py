"""ONNX frontend: import an ONNX graph into FFModel.

The PyTorch counterpart of flexflow_tpu/frontends/onnx/model.py
(reference: python/flexflow/onnx/model.py:56, `ONNXModel(path).apply(
ffmodel, input_dict)` walking graph.node and dispatching each op_type to
its handle_<Op> method). A path or bytes load through the package's own
protobuf codec (proto.py), so no `onnx` package is needed; any object
with the ModelProto shape (.graph.node, .graph.initializer, .graph.output)
is taken as it is. Each handler builds the port's FFModel ops as the JAX
package's handler builds its own; `load_weights` then writes the graph's
initializers into the compiled model in place (Tensor.set_tensor).

Dense layers: a MatMul by an initializer followed by the Add of a per-unit
bias (keras2onnx's layout) folds into one dense with a trainable bias
(`_plan_bias_folds`); a broadcast scalar operand stays a constant, and a
MatMul whose output is itself a graph output is not folded. `Constant`
nodes' values join the initializers before the walk, so their MatMuls
fold too, and a constant operand of an elementwise op is baked
(`create_constant_tensor`).
"""
from __future__ import annotations

import importlib.util
from typing import Dict

import numpy as np

from ...ff_types import DataType, PoolType
from . import proto

# the onnx package is importable (the JAX package's flag). The port
# reads a path or bytes with its own codec either way, and takes an
# onnx ModelProto as any object of that shape
HAS_ONNX = importlib.util.find_spec("onnx") is not None


# AttributeProto.AttributeType values (onnx.proto): FLOAT=1 INT=2 STRING=3
# FLOATS=6 INTS=7
_ATTR_FIELD_BY_TYPE = {1: "f", 2: "i", 3: "s", 6: "floats", 7: "ints"}


def _attrs(node) -> Dict[str, object]:
    out = {}
    for a in node.attribute:
        # minimal AttributeProto decoding (reference: onnx/model.py uses
        # helper.get_attribute_value). Trust the type tag when present —
        # heuristics must not let a default i=0 shadow a populated `ints`.
        t = getattr(a, "type", 0)
        if t in _ATTR_FIELD_BY_TYPE:
            field = _ATTR_FIELD_BY_TYPE[t]
            v = getattr(a, field)
            out[a.name] = list(v) if field in ("ints", "floats") else v
            continue
        for field in ("ints", "floats", "s", "i", "f"):
            v = getattr(a, field, None)
            if field in ("ints", "floats", "s"):
                if v not in (None, "", b"") and len(v):
                    out[a.name] = list(v) if field != "s" else v
                    break
            elif v:  # scalar: zero is indistinguishable from unset → default
                out[a.name] = v
                break
    return out


class ONNXTensor:
    """reference: onnx/model.py ONNXTensor"""

    def __init__(self, name, dims):
        self.name = name
        self.dims = list(dims)


class ONNXModel:
    """reference: onnx/model.py:56"""

    def __init__(self, model):
        if isinstance(model, (str, bytes)):
            model = proto.load_model(model)
        self.model = model
        self.initializers: Dict[str, np.ndarray] = {}
        for init in model.graph.initializer:
            if hasattr(init, "dims"):  # a TensorProto (proto.py's or onnx's)
                self.initializers[init.name] = proto.to_array(init)
            else:  # an object carrying its array as .data
                self.initializers[init.name] = np.asarray(init.data)
        self._weight_loads = []
        self._ffmodel = None

    def _plan_bias_folds(self):
        """keras2onnx dense layout is MatMul(x, W_init) → Add(mm, b_init):
        fold each such pair into ONE dense(use_bias=True) so the bias stays
        a *trainable* weight. (The reference's ONNXModelKeras instead drops
        dense biases entirely, onnx/model.py:343-345.) Returns
        ({id(matmul_node): (add_node, bias_name)}, {id(add_node), ...})."""
        consumers: Dict[str, list] = {}
        for node in self.model.graph.node:
            for i in node.input:
                consumers.setdefault(i, []).append(node)
        graph_outs = {o.name for o in self.model.graph.output}
        folds, skip = {}, set()
        for node in self.model.graph.node:
            if (node.op_type != "MatMul"
                    or node.input[1] not in self.initializers):
                continue
            cons = consumers.get(node.output[0], [])
            if (len(cons) != 1 or cons[0].op_type != "Add"
                    or node.output[0] in graph_outs):  # pre-bias tap exposed
                continue
            add = cons[0]
            other = (add.input[1] if add.input[0] == node.output[0]
                     else add.input[0])
            bias = self.initializers.get(other)
            w = self.initializers[node.input[1]]
            # only a true per-unit bias folds; broadcastable scalar adds
            # must stay constants, not become trainable parameters
            if bias is None or bias.shape != (w.shape[1],):
                continue
            folds[id(node)] = (add, other)
            skip.add(id(add))
        return folds, skip

    def apply(self, ffmodel, input_tensors: Dict[str, object]):
        """Walk graph.node, building FFModel ops. input_tensors maps graph
        input names to FFModel tensors."""
        env: Dict[str, object] = dict(input_tensors)
        outputs = []
        # register Constant-node values up front so the fold planner (and
        # the MatMul/Gemm weight path) see them before the walk reaches the
        # Constant node; the walk's handle_Constant re-registers harmlessly
        for node in self.model.graph.node:
            if node.op_type == "Constant":
                self.handle_Constant(None, node, env)
        folds, skip = self._plan_bias_folds()
        for node in self.model.graph.node:
            if id(node) in skip:
                continue  # bias Add folded into its dense
            if id(node) in folds:
                add, bias_name = folds[id(node)]
                w = self.initializers[node.input[1]]
                t = ffmodel.dense(env[node.input[0]], w.shape[1],
                                  use_bias=True)
                self._weight_loads.append(
                    (ffmodel.layers[-1], [w, self.initializers[bias_name]]))
                env[add.output[0]] = t  # mm output has no other reader
                continue
            handler = getattr(self, f"handle_{node.op_type}", None)
            if handler is None:
                raise NotImplementedError(f"ONNX op {node.op_type}")
            result = handler(ffmodel, node, env)
            outs = list(node.output)
            if not isinstance(result, (list, tuple)):
                result = [result]
            for name, t in zip(outs, result):
                env[name] = t
        for out in self.model.graph.output:
            if out.name in env:
                outputs.append(env[out.name])
        self._ffmodel = ffmodel
        return outputs[0] if len(outputs) == 1 else outputs

    def load_weights(self, ffmodel=None):
        """Write the graph's weights into the compiled model, in place."""
        model = ffmodel or self._ffmodel
        if model is None or model.params is None:
            raise RuntimeError("load_weights: apply() and compile() the "
                               "model first")
        for layer, arrays in self._weight_loads:
            for wt, arr in zip(layer.weights, arrays):
                wt.set_tensor(model, np.asarray(arr))

    # -- handlers (reference: onnx/model.py handle_* methods) -----------
    def handle_Conv(self, ff, node, env):
        x = env[node.input[0]]
        w = self.initializers[node.input[1]]
        a = _attrs(node)
        pads = a.get("pads", [0, 0, 0, 0])
        strides = a.get("strides", [1, 1])
        group = int(a.get("group", 1))
        out = ff.conv2d(
            x, w.shape[0], w.shape[2], w.shape[3],
            int(strides[0]), int(strides[1]), int(pads[0]), int(pads[1]),
            groups=group, use_bias=len(node.input) > 2,
        )
        arrays = [w] + ([self.initializers[node.input[2]]]
                        if len(node.input) > 2 else [])
        self._weight_loads.append((ff.layers[-1], arrays))
        return out

    def handle_Gemm(self, ff, node, env):
        x = env[node.input[0]]
        w = self.initializers[node.input[1]]
        a = _attrs(node)
        trans_b = int(a.get("transB", 0))
        kernel = w.T if trans_b else w
        out_dim = kernel.shape[1]
        out = ff.dense(x, out_dim, use_bias=len(node.input) > 2)
        arrays = [kernel] + (
            [self.initializers[node.input[2]]] if len(node.input) > 2 else []
        )
        self._weight_loads.append((ff.layers[-1], arrays))
        return out

    def handle_MatMul(self, ff, node, env):
        x = env[node.input[0]]
        if node.input[1] in self.initializers:
            w = self.initializers[node.input[1]]
            out = ff.dense(x, w.shape[1], use_bias=False)
            self._weight_loads.append((ff.layers[-1], [w]))
            return out
        return ff.batch_matmul(x, env[node.input[1]])

    def handle_MaxPool(self, ff, node, env):
        a = _attrs(node)
        k = a.get("kernel_shape", [2, 2])
        s = a.get("strides", k)
        p = a.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], int(k[0]), int(k[1]),
                         int(s[0]), int(s[1]), int(p[0]), int(p[1]),
                         PoolType.POOL_MAX)

    def handle_AveragePool(self, ff, node, env):
        a = _attrs(node)
        k = a.get("kernel_shape", [2, 2])
        s = a.get("strides", k)
        p = a.get("pads", [0, 0, 0, 0])
        return ff.pool2d(env[node.input[0]], int(k[0]), int(k[1]),
                         int(s[0]), int(s[1]), int(p[0]), int(p[1]),
                         PoolType.POOL_AVG)

    def handle_GlobalAveragePool(self, ff, node, env):
        x = env[node.input[0]]
        return ff.pool2d(x, x.dims[2], x.dims[3], 1, 1, 0, 0,
                         PoolType.POOL_AVG)

    def handle_Flatten(self, ff, node, env):
        return ff.flat(env[node.input[0]])

    def handle_Relu(self, ff, node, env):
        return ff.relu(env[node.input[0]])

    def handle_Gelu(self, ff, node, env):
        return ff.gelu(env[node.input[0]])

    def handle_Sigmoid(self, ff, node, env):
        return ff.sigmoid(env[node.input[0]])

    def handle_Tanh(self, ff, node, env):
        return ff.tanh(env[node.input[0]])

    def handle_Softmax(self, ff, node, env):
        a = _attrs(node)
        return ff.softmax(env[node.input[0]], axis=int(a.get("axis", -1)))

    def handle_Add(self, ff, node, env):
        return self._binary(ff, node, env, "add")

    def handle_Sub(self, ff, node, env):
        return self._binary(ff, node, env, "subtract")

    def handle_Mul(self, ff, node, env):
        return self._binary(ff, node, env, "multiply")

    def handle_Div(self, ff, node, env):
        return self._binary(ff, node, env, "divide")

    def _binary(self, ff, node, env, opname):
        def resolve(name):
            if name in env:
                v = env[name]
                if isinstance(v, np.ndarray):
                    # Constant-node operand: its handler leaves a raw array
                    # in env; bake it the same way as an initializer
                    return ff.create_constant_tensor(np.atleast_1d(v))
                return v
            # constant operand (keras-export bias Add, scale Mul, ...):
            # bake the initializer as a constant tensor; elementwise ops
            # broadcast-infer the output shape
            arr = self.initializers.get(name)
            if arr is None:
                raise ValueError(
                    f"ONNX {opname}: operand {name!r} is neither a graph "
                    "value nor an initializer")
            return ff.create_constant_tensor(np.atleast_1d(arr))

        a, b = resolve(node.input[0]), resolve(node.input[1])
        return getattr(ff, opname)(a, b)

    def handle_Concat(self, ff, node, env):
        a = _attrs(node)
        return ff.concat([env[i] for i in node.input], int(a.get("axis", 1)))

    def handle_Split(self, ff, node, env):
        a = _attrs(node)
        sizes = [int(s) for s in a.get("split", [])]
        axis = int(a.get("axis", 0))
        x = env[node.input[0]]
        if not sizes:
            sizes = len(node.output)
        return ff.split(x, sizes, axis)

    def handle_Reshape(self, ff, node, env):
        shape = self.initializers.get(node.input[1])
        if shape is None:
            raise NotImplementedError("ONNX Reshape to a dynamic shape")
        return ff.reshape(env[node.input[0]], [int(s) for s in shape])

    def handle_Transpose(self, ff, node, env):
        a = _attrs(node)
        return ff.transpose(env[node.input[0]], [int(p) for p in a["perm"]])

    def handle_Dropout(self, ff, node, env):
        a = _attrs(node)
        return ff.dropout(env[node.input[0]], float(a.get("ratio", 0.5)))

    def handle_Cast(self, ff, node, env):
        # ONNX TensorProto dtypes: 1=float32, 6=int32, 7=int64, 10=f16, 16=bf16
        a = _attrs(node)
        to = {1: DataType.DT_FLOAT, 6: DataType.DT_INT32, 7: DataType.DT_INT64,
              10: DataType.DT_HALF, 16: DataType.DT_BF16}[int(a.get("to", 1))]
        return ff.cast(env[node.input[0]], to)

    def handle_ReduceMean(self, ff, node, env):
        a = _attrs(node)
        axes = [int(x) for x in a.get("axes", [-1])]
        return ff.mean(env[node.input[0]], axes, bool(a.get("keepdims", 1)))

    def handle_BatchNormalization(self, ff, node, env):
        out = ff.batch_norm(env[node.input[0]], relu=False)
        arrays = [self.initializers[node.input[1]],
                  self.initializers[node.input[2]]]
        self._weight_loads.append((ff.layers[-1], arrays))
        return out

    def handle_Constant(self, ff, node, env):
        """keras2onnx-style Constant weight nodes: decode the value tensor
        into the initializer map so MatMul/Gemm consume it as a weight."""
        a = next((x for x in node.attribute if x.name == "value"), None)
        if a is None:
            raise ValueError("Constant node without a value attribute")
        arr = proto.to_array(a.t)
        self.initializers[node.output[0]] = arr
        return arr

    def handle_Identity(self, ff, node, env):
        return ff.identity(env[node.input[0]])

    def handle_Squeeze(self, ff, node, env):
        a = _attrs(node)
        axes = a.get("axes")
        # opset 13: axes as optional second input ('' = omitted)
        if axes is None and len(node.input) > 1 and node.input[1]:
            axes = self.initializers.get(node.input[1])
            if axes is None:
                raise NotImplementedError(
                    "ONNX Squeeze with dynamic axes (not an initializer)")
        # no axes anywhere = legal ONNX: squeeze every unit dim
        axes = [] if axes is None else list(axes)
        return ff.squeeze(env[node.input[0]], [int(x) for x in axes])

    def handle_Unsqueeze(self, ff, node, env):
        a = _attrs(node)
        axes = a.get("axes")
        if axes is None and len(node.input) > 1:
            axes = self.initializers.get(node.input[1])
        if axes is None:
            raise NotImplementedError("ONNX Unsqueeze with dynamic axes")
        return ff.unsqueeze(env[node.input[0]], [int(x) for x in axes])

    def handle_Where(self, ff, node, env):
        return ff.where(env[node.input[0]], env[node.input[1]],
                        env[node.input[2]])

    def handle_Resize(self, ff, node, env):
        x = env[node.input[0]]
        sizes = (self.initializers.get(node.input[3])
                 if len(node.input) > 3 else None)
        if sizes is None:
            raise NotImplementedError("ONNX Resize without static sizes")
        return ff.resize(x, [int(s) for s in sizes])

    def handle_PRelu(self, ff, node, env):
        out = ff.prelu(env[node.input[0]])
        slope = self.initializers.get(node.input[1])
        if slope is not None:
            # PyTorch exports default to a scalar slope; our alpha weight is
            # per-channel — broadcast up to its declared shape
            (alpha_decl,) = ff.layers[-1].weights
            arr = np.broadcast_to(np.ravel(slope), tuple(alpha_decl.dims))
            self._weight_loads.append((ff.layers[-1], [arr]))
        return out


class ONNXModelKeras(ONNXModel):
    """Keras-exported ONNX graphs (reference: onnx/model.py ONNXModelKeras —
    same walker, but keras exports carry Const/Identity weight nodes and
    dense kernels already (in, out)-oriented, which the stock handlers
    accept; ffconfig/ffmodel ctor args kept for signature parity)."""

    def __init__(self, model, ffconfig=None, ffmodel=None):
        super().__init__(model)
        self.ffconfig = ffconfig
        self.ffmodel = ffmodel
