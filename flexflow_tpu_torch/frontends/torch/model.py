"""PyTorch-FX frontend: import a torch.nn.Module into FFModel.

The PyTorch counterpart of flexflow_tpu/frontends/torch/model.py
(reference: python/flexflow/torch/model.py):
`PyTorchModel(module).torch_to_ff(ffmodel, input_tensors)` traces the
module with torch.fx.symbolic_trace and maps each fx node onto the port's
FFModel ops; `load_weights` then copies the module's parameters into the
compiled model's params.

File format (reference: torch_to_flexflow export + PyTorchModel.file_to_ff
import, model.py:2540): `torch_to_flexflow(module, path)` writes the
traced graph as JSON lines, one record per fx node with each module's
config extracted, and `PyTorchModel(path).apply(ffmodel, inputs)` (or
`file_to_ff`) rebuilds the ops from the file. Live trace and replay share
one builder table (`_MODULE_BUILDERS`) and one call dispatch
(`_replay_fn`); the format is the JAX package's, so a file written by
either package replays in the other.

The rows are those whose ops the port has: `_MODULE_BUILDERS` holds
Linear, Conv2d, MaxPool2d, AvgPool2d, AdaptiveAvgPool2d (to 1x1 or the
identity size), BatchNorm2d, LayerNorm, Embedding, the activations,
Flatten, Softmax, Dropout, MultiheadAttention and Identity, and
`_replay_fn` the arithmetic, the activations, softmax, flatten, dropout,
`cat`/`concat`, `matmul`/`bmm` (batch_matmul), the casts (`to`,
`type_as`, `float`, `half`, `double`, `type`), `unsqueeze`, `squeeze`,
`mean`, `transpose`, `permute`, `view`/`reshape`, the metadata the
shape rows read (`size`, `dim`, `getattr` of shape, dtype, ndim and
device), `getitem` on a list of outputs or MultiheadAttention's tuple,
and the no-ops. Every other module or target raises NotImplementedError
with its name, as the JAX package does for what it lacks. Not ported
yet: concrete tensors meeting the graph (they need
`create_constant_tensor`, and with it the `where`, `masked_fill` and
`expand` rows and the `*_like` fills) and Hugging Face tracing. As in
the JAX package, MultiheadAttention's weights and BatchNorm2d's running
statistics are not carried over from torch.
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch
import torch.fx

from ...ff_types import (AggrMode, DataType, OperatorType, PoolType,
                         to_data_type)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _linear_export(mod):
    return {"out_features": mod.out_features, "bias": mod.bias is not None}


def _linear_build(ff, cfg, args, name):
    return ff.dense(args[0], cfg["out_features"], use_bias=cfg["bias"],
                    name=name)


def _linear_weights(mod):
    w = [mod.weight.detach().cpu().numpy().T]  # torch (out,in) -> (in,out)
    if mod.bias is not None:
        w.append(mod.bias.detach().cpu().numpy())
    return w


def _conv2d_export(mod):
    return {"out_channels": mod.out_channels,
            "kernel": list(_pair(mod.kernel_size)),
            "stride": list(_pair(mod.stride)),
            "padding": list(_pair(mod.padding)),
            "groups": mod.groups, "bias": mod.bias is not None}


def _conv2d_build(ff, cfg, args, name):
    k, s, p = cfg["kernel"], cfg["stride"], cfg["padding"]
    return ff.conv2d(args[0], cfg["out_channels"], k[0], k[1], s[0], s[1],
                     p[0], p[1], groups=cfg["groups"], use_bias=cfg["bias"],
                     name=name)


def _conv2d_weights(mod):
    w = [mod.weight.detach().cpu().numpy()]  # OIHW in both
    if mod.bias is not None:
        w.append(mod.bias.detach().cpu().numpy())
    return w


def _pool_export(mod):
    k = _pair(mod.kernel_size)
    s = _pair(mod.stride) if mod.stride is not None else k
    return {"kernel": list(k), "stride": list(s),
            "padding": list(_pair(mod.padding))}


def _pool_build(pool_type):
    def build(ff, cfg, args, name):
        k, s, p = cfg["kernel"], cfg["stride"], cfg["padding"]
        return ff.pool2d(args[0], k[0], k[1], s[0], s[1], p[0], p[1],
                         pool_type, name=name)

    return build


def _adaptive_export(mod):
    return {"output_size": list(_pair(mod.output_size))}


def _adaptive_build(ff, cfg, args, name):
    x = args[0]
    h, w = x.dims[2], x.dims[3]
    osz = tuple(cfg["output_size"])
    if osz == (1, 1):
        return ff.pool2d(x, h, w, 1, 1, 0, 0, PoolType.POOL_AVG, name=name)
    if (h, w) != osz:
        raise NotImplementedError(
            f"AdaptiveAvgPool2d from {(h, w)} to {osz}: only 1x1 and the "
            "identity size")
    return x


def _bn_build(ff, cfg, args, name):
    return ff.batch_norm(args[0], relu=False, name=name)


def _bn_weights(mod):
    if mod.weight is None:  # BatchNorm2d(affine=False)
        return None
    return [mod.weight.detach().cpu().numpy(),
            mod.bias.detach().cpu().numpy()]


def _ln_export(mod):
    return {"normalized_shape": list(mod.normalized_shape), "eps": mod.eps,
            "affine": mod.elementwise_affine}


def _ln_build(ff, cfg, args, name):
    return ff.layer_norm(
        args[0], axes=tuple(range(-len(cfg["normalized_shape"]), 0)),
        eps=cfg["eps"], name=name)


def _ln_weights(mod):
    if not mod.elementwise_affine:
        return None
    return [mod.weight.detach().cpu().numpy(),
            mod.bias.detach().cpu().numpy()]


def _emb_export(mod):
    return {"num": mod.num_embeddings, "dim": mod.embedding_dim}


def _emb_build(ff, cfg, args, name):
    return ff.embedding(args[0], cfg["num"], cfg["dim"],
                        AggrMode.AGGR_MODE_NONE, name=name)


def _emb_weights(mod):
    return [mod.weight.detach().cpu().numpy()]


def _act_build(method):
    def build(ff, cfg, args, name):
        return getattr(ff, method)(args[0], name=name)

    return build


def _softmax_export(mod):
    return {"dim": mod.dim if mod.dim is not None else -1}


def _softmax_build(ff, cfg, args, name):
    return ff.softmax(args[0], axis=cfg["dim"], name=name)


def _dropout_export(mod):
    return {"p": mod.p}


def _dropout_build(ff, cfg, args, name):
    return ff.dropout(args[0], cfg["p"], name=name)


def _mha_export(mod):
    return {"embed_dim": mod.embed_dim, "num_heads": mod.num_heads,
            "dropout": mod.dropout, "bias": mod.in_proj_bias is not None}


def _mha_build(ff, cfg, args, name):
    return ff.multihead_attention(
        args[0], args[1], args[2], cfg["embed_dim"], cfg["num_heads"],
        dropout=cfg["dropout"], bias=cfg["bias"], name=name)


def _none_export(mod):
    return {}


# type name -> (export, build, weights|None)
_MODULE_BUILDERS = {
    "Linear": (_linear_export, _linear_build, _linear_weights),
    "Conv2d": (_conv2d_export, _conv2d_build, _conv2d_weights),
    "MaxPool2d": (_pool_export, _pool_build(PoolType.POOL_MAX), None),
    "AvgPool2d": (_pool_export, _pool_build(PoolType.POOL_AVG), None),
    "AdaptiveAvgPool2d": (_adaptive_export, _adaptive_build, None),
    "BatchNorm2d": (_none_export, _bn_build, _bn_weights),
    "LayerNorm": (_ln_export, _ln_build, _ln_weights),
    "Embedding": (_emb_export, _emb_build, _emb_weights),
    "ReLU": (_none_export, _act_build("relu"), None),
    "GELU": (_none_export, _act_build("gelu"), None),
    "Sigmoid": (_none_export, _act_build("sigmoid"), None),
    "Tanh": (_none_export, _act_build("tanh"), None),
    "ELU": (_none_export, _act_build("elu"), None),
    "Identity": (_none_export, _act_build("identity"), None),
    "Flatten": (_none_export, lambda ff, c, a, n: ff.flat(a[0], name=n),
                None),
    "Softmax": (_softmax_export, _softmax_build, None),
    "Dropout": (_dropout_export, _dropout_build, None),
    "MultiheadAttention": (_mha_export, _mha_build, None),
}


class PyTorchModel:
    """reference: torch/model.py:2408 PyTorchModel"""

    def __init__(self, module, is_hf_model: bool = False, input_names=None,
                 batch_size: int = 1, seq_length=None):
        # a path names a `torch_to_flexflow` export to replay
        # (bootcamp_demo/ff_alexnet_cifar10.py: PyTorchModel("alexnet.ff"))
        self._file = module if isinstance(module, str) else None
        if is_hf_model:
            raise NotImplementedError(
                "Hugging Face tracing (is_hf_model) is not ported to "
                "flexflow_tpu_torch yet")
        self.module = module
        self.batch_size = batch_size
        self._weight_loads = []  # (ff layer, [np arrays]) applied post-compile
        self._ffmodel = None

    def apply(self, ffmodel, input_tensors: List) -> List:
        """The uniform entry point of the frontends (ONNXModel.apply):
        replays the file when constructed from a path, traces the module
        live otherwise."""
        if self._file is not None:
            return PyTorchModel.file_to_ff(self._file, ffmodel,
                                           input_tensors)
        return self.torch_to_ff(ffmodel, input_tensors)

    def torch_to_ff(self, ffmodel, input_tensors: List) -> List:
        """Map the traced graph onto ffmodel; returns output tensors."""
        if self._file is not None:
            raise TypeError("constructed from a file: use apply() or "
                            "file_to_ff()")
        traced = torch.fx.symbolic_trace(self.module)
        modules = dict(traced.named_modules())
        env: Dict[str, object] = {}
        inputs = list(input_tensors)
        outputs: List = []

        for node in traced.graph.nodes:
            if node.op not in ("placeholder", "output") and not node.users:
                # dead value (e.g. the discarded attention-weights half of
                # `out, _ = mha(...)`): nothing consumes it, skip
                continue
            if node.op == "placeholder":
                env[node.name] = inputs.pop(0)
            elif node.op == "call_module":
                mod = modules[node.target]
                args = [env[a.name] if isinstance(a, torch.fx.Node) else a
                        for a in node.args]
                env[node.name] = self._module_to_ff(ffmodel, mod, args, node)
            elif node.op == "call_function":
                env[node.name] = self._function_to_ff(ffmodel, node, env)
            elif node.op == "call_method":
                env[node.name] = self._method_to_ff(ffmodel, node, env)
            elif node.op == "get_attr":
                env[node.name] = self._fetch_attr(node.target)
            elif node.op == "output":
                def collect(a):
                    if isinstance(a, torch.fx.Node):
                        outputs.append(_lift(ffmodel, env[a.name]))
                    elif isinstance(a, (tuple, list)):
                        for x in a:
                            collect(x)
                    elif isinstance(a, dict):
                        for x in a.values():
                            collect(x)
                collect(node.args[0])
        self._ffmodel = ffmodel
        return outputs

    def _fetch_attr(self, target: str):
        obj = self.module
        for part in target.split("."):
            obj = getattr(obj, part)
        return obj

    def _module_to_ff(self, ff, mod, args, node):
        tname = type(mod).__name__
        spec = _MODULE_BUILDERS.get(tname)
        if spec is None:
            raise NotImplementedError(f"torch module {tname}")
        if node.kwargs:
            # builders bind positionally; dropping kwargs (e.g.
            # MultiheadAttention's key_padding_mask) would lose semantics
            raise NotImplementedError(
                f"module {tname} called with kwargs {sorted(node.kwargs)}")
        args = [_lift(ff, a) if _concrete_np(a) is not None else a
                for a in args]
        export, build, weights = spec
        out = build(ff, export(mod), args, node.name)
        if weights is not None:
            w = weights(mod)
            if w is not None:
                self._weight_loads.append((ff.layers[-1], w))
        return out

    @staticmethod
    def _resolve(node, env):
        """Map fx Nodes to runtime values through nested args."""
        args = torch.fx.node.map_arg(node.args, lambda n: env[n.name])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n.name])
        return list(args), dict(kwargs)

    def _function_to_ff(self, ff, node, env):
        args, kwargs = self._resolve(node, env)
        if not _any_ff(args) and not _any_ff(kwargs):
            # fully concrete: evaluate eagerly with the real torch function
            return node.target(*args, **kwargs)
        return _replay_fn(ff, _fn_name(node.target), args, kwargs)

    def _method_to_ff(self, ff, node, env):
        args, kwargs = self._resolve(node, env)
        if not _any_ff(args) and not _any_ff(kwargs):
            return getattr(args[0], node.target)(*args[1:], **kwargs)
        return _replay_fn(ff, node.target, args, kwargs)

    def load_weights(self, ffmodel=None):
        """Copy the torch module's parameters (Linear, Conv2d,
        BatchNorm2d's scale and bias, LayerNorm, Embedding) into the
        compiled model's params, in place, so the optimizer state stays
        the model's own."""
        model = ffmodel or self._ffmodel
        if model is None or model.params is None:
            raise RuntimeError("load_weights: torch_to_ff and compile() the "
                               "model first")
        with torch.no_grad():
            for layer, arrays in self._weight_loads:
                for wt, arr in zip(layer.weights, arrays):
                    dst = model.params[layer.name][wt.name]
                    if tuple(arr.shape) != tuple(dst.shape):
                        raise ValueError(
                            f"{layer.name}.{wt.name}: torch shape "
                            f"{tuple(arr.shape)} != {tuple(dst.shape)}")
                    dst.copy_(torch.as_tensor(arr))

    @staticmethod
    def file_to_ff(filename: str, ffmodel, input_tensors: List) -> List:
        """Rebuild the FFModel ops of a `torch_to_flexflow` export; returns
        the output tensors. The file carries each module's config, so
        nothing of the module is needed."""
        env: Dict[str, object] = {}
        inputs = list(input_tensors)
        outputs: List = []

        def val(a):
            if isinstance(a, dict) and "ref" in a:
                return env[a["ref"]]
            if isinstance(a, list):
                return [val(x) for x in a]
            return a

        with open(filename) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind, name = rec["op"], rec["name"]
                if kind == "placeholder":
                    env[name] = inputs.pop(0)
                elif kind == "call_module":
                    spec = _MODULE_BUILDERS.get(rec["module_type"])
                    if spec is None:
                        raise NotImplementedError(
                            f"module {rec['module_type']} in {filename}")
                    args = [val(a) for a in rec["args"]]
                    env[name] = spec[1](ffmodel, rec["config"], args, name)
                elif kind in ("call_function", "call_method"):
                    env[name] = _replay_fn(
                        ffmodel, rec["target"], [val(a) for a in rec["args"]],
                        {k: val(v) for k, v in rec.get("kwargs", {}).items()})
                elif kind == "output":
                    outputs.extend(val(a) for a in rec["args"])
        return outputs


def torch_to_flexflow(module, path: str, batch_size: int = 1) -> str:
    """Write a torch module's fx graph to the flexflow file format
    (reference: torch/model.py torch_to_flexflow): JSON lines, one record
    per live fx node, each module's config extracted by its builder row,
    so `file_to_ff` replays it without the module. Returns `path`."""
    traced = torch.fx.symbolic_trace(module)
    modules = dict(traced.named_modules())

    def ser(a):
        if isinstance(a, torch.fx.Node):
            return {"ref": a.name}
        if isinstance(a, (tuple, list)):
            return [ser(x) for x in a]
        if isinstance(a, (int, float, str, bool)) or a is None:
            return a
        raise NotImplementedError(f"cannot serialize arg {a!r}")

    with open(path, "w") as f:
        for node in traced.graph.nodes:
            if node.op not in ("placeholder", "output") and not node.users:
                continue  # dead value, the live walk's skip
            rec = {"op": node.op, "name": node.name}
            if node.op == "call_module":
                mod = modules[node.target]
                tname = type(mod).__name__
                spec = _MODULE_BUILDERS.get(tname)
                if spec is None:
                    raise NotImplementedError(f"torch module {tname}")
                if node.kwargs:
                    # a file that silently lost them would replay wrong
                    raise NotImplementedError(
                        f"kwargs on module call {tname}: "
                        f"{sorted(node.kwargs)}")
                rec["module_type"] = tname
                rec["config"] = spec[0](mod)
                rec["args"] = [ser(a) for a in node.args]
            elif node.op in ("call_function", "call_method"):
                rec["target"] = _fn_name(node.target)
                rec["args"] = [ser(a) for a in node.args]
                rec["kwargs"] = {k: ser(v) for k, v in node.kwargs.items()}
            elif node.op == "output":
                flat = []

                def collect(a):
                    if isinstance(a, torch.fx.Node):
                        flat.append({"ref": a.name})
                    elif isinstance(a, (tuple, list)):
                        for x in a:
                            collect(x)

                collect(node.args[0])
                rec["args"] = flat
            elif node.op == "get_attr":
                raise NotImplementedError("get_attr is not serializable")
            f.write(json.dumps(rec) + "\n")
    return path


# reference model.py:2607 exposes file_to_ff at module level
file_to_ff = PyTorchModel.file_to_ff


def _fn_name(fn) -> str:
    """A call_function target's name as the file writes it
    (`operator.add`/`torch.add` -> "add"), so live trace and replay go
    through the one `_replay_fn` dispatch."""
    return fn if isinstance(fn, str) else fn.__name__


def _is_ff_tensor(v) -> bool:
    return hasattr(v, "guid") and hasattr(v, "dims") and hasattr(v, "data_type")


def _any_ff(v) -> bool:
    if _is_ff_tensor(v):
        return True
    if isinstance(v, (list, tuple)):
        return any(_any_ff(x) for x in v)
    if isinstance(v, dict):
        return any(_any_ff(x) for x in v.values())
    return False


def _concrete_np(v):
    """numpy view of a concrete (non-FF) tensor-like value, else None."""
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return None


def _lift(ff, v):
    """A graph tensor as it is; a concrete value would become a baked
    constant tensor, which is not ported yet."""
    if _is_ff_tensor(v):
        return v
    raise NotImplementedError(
        f"a concrete {type(v).__name__} meets the graph: constant tensors "
        "(create_constant_tensor) are not ported to flexflow_tpu_torch yet")


def _is_scalar(v) -> bool:
    return isinstance(v, (int, float))


def _slice_is_identity(x, idx) -> bool:
    """True when x[idx] would return x unchanged (static shapes): full
    slices, an Ellipsis expanded over the dims it stands for."""
    items = idx if isinstance(idx, tuple) else (idx,)
    if sum(1 for it in items if it is Ellipsis) > 1:
        return False
    if any(it is Ellipsis for it in items):
        pos = items.index(Ellipsis)
        n_missing = len(x.dims) - (len(items) - 1)
        if n_missing < 0:
            return False
        items = items[:pos] + (slice(None),) * n_missing + items[pos + 1:]
    if (len(items) > len(x.dims)
            or any(not isinstance(it, slice) for it in items)):
        return False
    for dim, sl in zip(x.dims, items):
        try:
            bounds = slice(*(None if v is None else int(v)
                             for v in (sl.start, sl.stop, sl.step))
                           ).indices(dim)
        except (TypeError, ValueError):
            return False
        if bounds != (0, dim, 1):
            return False
    return True


def _cast_row(ff, target, x, args, kwargs):
    """to / type_as / float / half / double / type: a Cast op, or x
    itself where only the device changes (placement is the model's)."""
    fixed = {"float": DataType.DT_FLOAT, "half": DataType.DT_HALF,
             "double": DataType.DT_DOUBLE}
    if target in fixed:
        return ff.cast(_lift(ff, x), fixed[target])
    other = kwargs.get("dtype", args[1] if len(args) > 1 else None)
    if other is None:
        return x
    if _is_ff_tensor(other):
        return ff.cast(_lift(ff, x), other.data_type)
    c = _concrete_np(other)
    if c is not None:  # type_as(concrete tensor)
        return ff.cast(_lift(ff, x), to_data_type(c.dtype))
    if isinstance(other, (str, torch.device)):
        return x
    return ff.cast(_lift(ff, x), to_data_type(other))  # loud when unknown


def _shape_row(ff, target, x, args, kwargs):
    """mean, transpose, permute, view / reshape, as the JAX package maps
    them."""
    if target == "mean":
        dims = kwargs.get("dim", args[1] if len(args) > 1 else None)
        keep = kwargs.get("keepdim", False)
        if dims is None:  # torch.mean(x): the mean over every axis
            dims = list(range(len(x.dims)))
        dims = [dims] if isinstance(dims, int) else list(dims)
        return ff.mean(x, dims, keep)
    if target == "transpose":
        perm = list(range(len(x.dims)))
        perm[args[1]], perm[args[2]] = perm[args[2]], perm[args[1]]
        return ff.transpose(x, perm)
    if target == "permute":
        perm = args[1] if isinstance(args[1], (list, tuple)) else args[1:]
        return ff.transpose(x, list(perm))
    shape = args[1:] if not isinstance(args[1], (list, tuple)) else args[1]
    shape = [-1 if isinstance(v, str) else int(v) for v in shape]
    return ff.reshape(x, shape)


def _getattr_row(x, attr):
    """x.shape / x.dtype / x.ndim / x.device on a graph tensor."""
    if attr == "shape":
        return tuple(x.dims)
    if attr == "dtype":
        # a torch.dtype, which both eager torch and the cast rows take
        return x.data_type.torch_dtype
    if attr == "ndim":
        return len(x.dims)
    if attr == "device":
        return "cpu"  # eager ops at import time run on the host
    raise NotImplementedError(f"getattr({attr}) on graph tensor")


_UNARY_TARGETS = ("relu", "gelu", "sigmoid", "tanh", "elu", "exp", "sin",
                  "cos", "rsqrt", "sqrt", "log")


def _replay_fn(ff, target: str, args, kwargs):
    """The call_function/call_method dispatch. Targets are normalized
    names (`operator.add`/`torch.add` -> "add", methods keep their
    string)."""
    x = args[0] if args else None
    if target in ("add", "sub", "subtract", "mul", "multiply", "truediv",
                  "div", "divide"):
        key = {"subtract": "sub", "multiply": "mul", "divide": "div"}.get(
            target, target)
        scalar_ops = {"add": ff.scalar_add, "sub": ff.scalar_sub,
                      "mul": ff.scalar_multiply,
                      "truediv": ff.scalar_true_divide,
                      "div": ff.scalar_true_divide}
        pair_ops = {"add": ff.add, "sub": ff.subtract, "mul": ff.multiply,
                    "truediv": ff.divide, "div": ff.divide}
        a, b = args[0], args[1]
        if _is_scalar(b) and _is_ff_tensor(a):
            return scalar_ops[key](a, float(b))
        if _is_scalar(a) and _is_ff_tensor(b):
            # reversed scalar op: c - t = -t + c; c / t via pow(-1)
            if key == "add":
                return ff.scalar_add(b, float(a))
            if key == "mul":
                return ff.scalar_multiply(b, float(a))
            if key == "sub":
                return ff.scalar_add(ff.scalar_multiply(b, -1.0), float(a))
            return ff.scalar_multiply(ff.pow(b, -1.0), float(a))
        return pair_ops[key](_lift(ff, a), _lift(ff, b))
    if target in _UNARY_TARGETS:
        return getattr(ff, target)(x)
    if target == "softmax":
        dim = kwargs.get("dim", args[1] if len(args) > 1 else -1)
        return ff.softmax(x, axis=dim if dim is not None else -1)
    if target in ("cat", "concat"):
        dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        return ff.concat(list(args[0]), dim)
    if target in ("flatten", "flat"):
        return ff.flat(x)
    if target in ("matmul", "bmm"):
        return ff.batch_matmul(_lift(ff, x), _lift(ff, args[1]))
    if target in ("min", "max") and len(args) > 1:
        op = ff.min if target == "min" else ff.max
        return op(_lift(ff, x), _lift(ff, args[1]))
    if target == "neg":
        return ff.scalar_multiply(x, -1.0)
    if target == "abs":
        return ff.max(x, ff.scalar_multiply(x, -1.0, inplace=False))
    if target == "pow":
        return ff.pow(x, float(args[1]))
    if target == "dropout":
        p = kwargs.get("p", args[1] if len(args) > 1 else 0.5)
        training = kwargs.get("training", args[2] if len(args) > 2 else True)
        if not training:  # F.dropout(..., training=False) is a no-op
            return x
        return ff.dropout(x, rate=float(p))
    if target in ("to", "type_as", "float", "half", "double", "type"):
        return _cast_row(ff, target, x, args, kwargs)
    if target == "dim":
        return len(x.dims)
    if target == "unsqueeze":
        return ff.unsqueeze(x, [args[1]])
    if target == "squeeze":
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        return ff.squeeze(x, () if dim is None else [dim])
    if target == "getattr" and _is_ff_tensor(x):
        return _getattr_row(x, args[1])
    if target in ("mean", "transpose", "permute", "view", "reshape"):
        return _shape_row(ff, target, x, args, kwargs)
    if target in ("contiguous", "detach", "clone", "identity"):
        return x
    if target == "size":
        return x.dims if len(args) == 1 else x.dims[args[1]]
    if target == "getitem":
        if isinstance(x, (list, tuple)):
            return x[args[1]]
        idx = args[1]
        if _slice_is_identity(x, idx):
            # e.g. T5's position_bias[:, :, -seq_len:, :] with no KV cache
            return x
        if (isinstance(idx, tuple) and any(it is None for it in idx)
                and all(it is None or (isinstance(it, slice)
                                       and it == slice(None))
                        for it in idx)):
            # newaxis-only indexing: unsqueeze at the None positions
            return ff.unsqueeze(x, [i for i, it in enumerate(idx)
                                    if it is None])
        owner_op = getattr(getattr(x, "owner_layer", None), "op_type", None)
        if idx == 0 and owner_op in (OperatorType.OP_MULTIHEAD_ATTENTION,
                                     OperatorType.OP_LSTM):
            # tuple-returning torch modules (MultiheadAttention's (output,
            # weights), LSTM's (output, state)) map to their single output
            # tensor; true tensor indexing stays a loud error
            return x
        raise NotImplementedError(f"getitem[{idx}] on single-output op")
    raise NotImplementedError(f"torch call {target}")
