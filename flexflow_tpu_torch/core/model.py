"""FFModel: the user-facing model container.

The PyTorch counterpart of flexflow_tpu/core/model.py for the serving
slice: the builder methods the served decoder LM uses, `compile` on the
manual single-device branch, and `forward`/`predict`. Op names follow the
JAX package (`f"{op_type.name.lower()}_{len(self.layers)}"`), so weights
carry across by (op name, weight name) (runtime/weights.py).

`compile` stores the optimizer and loss for the training slice, which
will use them; it refuses a strategy search (search_budget >= 0) and more
than one device, neither of which is ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import FFConfig
from ..ff_types import ActiMode, AggrMode, DataType, OperatorType, to_data_type
from ..ops.attention import MultiHeadAttentionParams
from ..ops.embedding import EmbeddingParams
from ..ops.linear import LinearParams
from ..ops.registry import get_op_def
from ..ops.softmax import SoftmaxParams
from ..parallel.executor import PCGExecutor
from ..pcg.lowering import layers_to_pcg
from .tensor import Layer, Tensor


class FFModel:
    """reference: model.h:326 FFModel / flexflow_cffi.py:883."""

    def __init__(self, ffconfig: Optional[FFConfig] = None):
        self.config = ffconfig or FFConfig()
        self.device = self.config.torch_device
        self.layers: List[Layer] = []
        self.input_tensors: List[Tensor] = []
        self.optimizer = None
        self.loss_type = None
        self.metrics: Sequence = ()
        self.graph = None
        self.executor: Optional[PCGExecutor] = None
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._fit_input_tensors: List[Tensor] = []

    # -- graph building -----------------------------------------------------
    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.DT_FLOAT,
                      create_grad: bool = True, name: str = "") -> Tensor:
        t = Tensor(tuple(dims), to_data_type(dtype),
                   create_gradients=create_grad, name=name)
        t._model = self
        self.input_tensors.append(t)
        return t

    def _add_layer(self, op_type: OperatorType, params, inputs: List[Tensor],
                   name: str = "",
                   initializers: Optional[Dict[str, object]] = None) -> Tensor:
        # deterministic per-model names, as the JAX package gives them
        if not name:
            name = f"{op_type.name.lower()}_{len(self.layers)}"
        layer = Layer(op_type, params, inputs, name=name)
        if initializers:
            layer.initializers.update(
                {k: v for k, v in initializers.items() if v is not None})
        opdef = get_op_def(op_type)
        in_shapes = [t.dims for t in inputs]
        in_dtypes = [t.data_type for t in inputs]
        out_shapes, out_dtypes = opdef.infer(params, in_shapes, in_dtypes)
        for i, (s, dt) in enumerate(zip(out_shapes, out_dtypes)):
            out = Tensor(s, dt, owner_layer=layer, owner_idx=i)
            out._model = self
            layer.outputs.append(out)
        for spec in opdef.weights(params, in_shapes, in_dtypes):
            wt = Tensor(spec.shape, spec.dtype, owner_layer=layer,
                        name=spec.name)
            wt._model = self
            layer.weights.append(wt)
        self.layers.append(layer)
        return layer.outputs[0]

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE,
              use_bias: bool = True, datatype: DataType = DataType.DT_FLOAT,
              kernel_initializer=None, bias_initializer=None,
              name: str = "") -> Tensor:
        p = LinearParams(out_channels=out_dim, use_bias=use_bias,
                         activation=ActiMode(activation),
                         data_type=to_data_type(datatype))
        return self._add_layer(OperatorType.OP_LINEAR, p, [input], name,
                               {"kernel": kernel_initializer,
                                "bias": bias_initializer})

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  dtype: DataType = DataType.DT_FLOAT,
                  kernel_initializer=None, name: str = "") -> Tensor:
        p = EmbeddingParams(num_entries=num_entries, out_channels=out_dim,
                            aggr=AggrMode(aggr), data_type=to_data_type(dtype))
        return self._add_layer(OperatorType.OP_EMBEDDING, p, [input], name,
                               {"weight": kernel_initializer})

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, add_bias_kv: bool = False,
                            add_zero_attn: bool = False,
                            kernel_initializer=None, causal: bool = False,
                            name: str = "") -> Tensor:
        p = MultiHeadAttentionParams(
            embed_dim=embed_dim, num_heads=num_heads, kdim=kdim, vdim=vdim,
            dropout=dropout, bias=bias, add_bias_kv=add_bias_kv,
            add_zero_attn=add_zero_attn, causal=causal)
        inits = ({k: kernel_initializer for k in ("wq", "wk", "wv", "wo")}
                 if kernel_initializer else None)
        return self._add_layer(OperatorType.OP_MULTIHEAD_ATTENTION, p,
                               [query, key, value], name, inits)

    def softmax(self, input: Tensor, axis: int = -1, name="") -> Tensor:
        return self._add_layer(OperatorType.OP_SOFTMAX,
                               SoftmaxParams(dim=axis), [input], name)

    # -- compile ------------------------------------------------------------
    def compile(self, optimizer=None, loss_type=None, metrics: Sequence = ()):
        """Lower the layers to a PCG and initialize the weights on
        `config.device`. Only the manual single-device branch is ported:
        a strategy search or more than one device raises."""
        if self.config.search_budget >= 0:
            raise NotImplementedError(
                "strategy search (search_budget >= 0) is not ported to "
                "flexflow_tpu_torch yet; use search_budget=-1")
        n_dev = self.config.workersPerNode
        if n_dev != 1:
            raise NotImplementedError(
                f"{n_dev} devices requested: only single-device execution "
                "is ported to flexflow_tpu_torch (set workersPerNode=1)")
        # kept for the training slice, which runs them
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = tuple(metrics)
        self.graph, tensor_map = layers_to_pcg(self.layers)
        graph_inputs = {pt.guid: pt for pt in self.graph.input_tensors()}
        self._fit_input_tensors = [
            t for t in self.input_tensors
            if tensor_map.get(t.guid) in graph_inputs]
        self.executor = PCGExecutor(
            self.graph, self.device,
            compute_dtype=(torch.bfloat16
                           if self.config.allow_mixed_precision else None),
            seed=self.config.seed,
            input_order=[graph_inputs[tensor_map[t.guid]]
                         for t in self._fit_input_tensors])
        self.params = self.executor.init_params()

    # -- inference ----------------------------------------------------------
    def forward(self, inputs: Sequence[np.ndarray]) -> torch.Tensor:
        """The full forward of one compiled batch: inputs in creation order,
        returns the graph output on the model's device."""
        if self.executor is None:
            raise RuntimeError("compile() the model first")
        return self.executor.build_forward()(self.params, list(inputs))

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Forward over a dataset in compiled-batch chunks -> numpy. The
        tail that does not fill a batch is padded and its rows dropped."""
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        bs = batch_size or self._fit_input_tensors[0].dims[0]
        n = len(xs[0])
        outs = []
        for i in range(0, n, bs):
            chunk = [a[i:i + bs] for a in xs]
            short = bs - len(chunk[0])
            if short:
                chunk = [np.concatenate([c, np.repeat(c[-1:], short, 0)])
                         for c in chunk]
            y = self.forward(chunk).float().cpu().numpy()
            outs.append(y[:bs - short])
        return np.concatenate(outs)
