"""FFModel: the user-facing model container.

The PyTorch counterpart of flexflow_tpu/core/model.py: the builder methods
of the ported ops (the ones the served LM, the flagship Transformer, the
PyTorch frontend, the CNNs and the rest of the zoo call: the shape ops,
the reductions and top_k, batch_matmul, PReLU and the MoE family with
its `moe` composite; an op with several outputs returns their list),
`compile` on the manual single-device branch
(it creates the label tensor, `get_label_tensor`), `init_layers`,
`create_data_loader`, `fit` and `eval` (training; both take arrays or
data loaders), `predict` (serving) and the stepwise API
(`set_iteration_batch`, `forward`, `zero_gradients`, `backward`,
`update`). Stateful ops' buffers (BatchNorm's running statistics,
Cache's cached value) live in `self.state.net_state`: training updates
them, eval, `predict` and the stepwise `forward` read them. Op names follow the JAX package
(`f"{op_type.name.lower()}_{len(self.layers)}"`), so weights carry across
by (op name, weight name) (runtime/weights.py).

`compile` builds the loss, the metrics and the optimizer state into
`self.state` (a TrainState); `self.params` is `self.state.params`, the one
dict that training updates and serving reads. It refuses a strategy search
(search_budget >= 0) and more than one device, neither of which is ported
yet. `fit` is the JAX package's loop: per-epoch metrics, the reference's
throughput line, each step's seed drawn from the model's CPU generator
(as the JAX loop splits its key), and one eager train step per batch or,
with `config.iterations_per_dispatch` N > 1, chunks of N batches through
the executor's train scan (one CUDA graph replay per chunk on a card),
the shorter tail chunk through its own. The step guard, checkpointing
and telemetry are not ported.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import FFConfig
from ..ff_types import (ActiMode, AggrMode, DataType, LossType, OperatorType,
                        PoolType, to_data_type)
from ..ops.attention import MultiHeadAttentionParams
from ..ops.batch_matmul import BatchMatmulParams
from ..ops.conv2d import Conv2DParams
from ..ops.dropout import DropoutParams
from ..ops.elementwise import (ElementBinaryParams, ElementUnaryParams,
                               PReluParams)
from ..ops.embedding import EmbeddingParams
from ..ops.linear import LinearParams
from ..ops.moe import (AggregateParams, AggregateSpecParams, CacheParams,
                       GroupByParams)
from ..ops.normalization import BatchNormParams, LayerNormParams
from ..ops.pool2d import Pool2DParams
from ..ops.reduce import ReduceParams, TopKParams
from ..ops.registry import get_op_def
from ..ops.softmax import SoftmaxParams
from ..ops.tensor_ops import (CastParams, ConcatParams, FlatParams,
                              GatherParams, ReshapeParams, ResizeParams,
                              ReverseParams, SplitParams, SqueezeParams,
                              TransposeParams, UnsqueezeParams, WhereParams)
from ..parallel.executor import PCGExecutor, TrainState
from ..pcg.lowering import layers_to_pcg
from .dataloader import SingleDataLoader
from .losses import to_loss_type
from .metrics import Metrics, PerfMetrics
from .optimizers import SGDOptimizer
from .seeds import step_seed
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
        self.state: Optional[TrainState] = None
        self.perf_metrics: Optional[PerfMetrics] = None
        self.label_tensor: Optional[Tensor] = None
        self._dataloaders: List[SingleDataLoader] = []
        self._fit_input_tensors: List[Tensor] = []
        self._rng: Optional[torch.Generator] = None
        # the stepwise API's bound batch and pending gradients
        self._current_batch: Optional[Tuple] = None
        self._last_logits: Optional[torch.Tensor] = None
        self._pending_grads = None
        self._pending_net_state = None

    @property
    def params(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """The weights, `self.state.params`: what training updates is what
        serving reads."""
        return None if self.state is None else self.state.params

    @params.setter
    def params(self, value) -> None:
        if self.state is None:
            raise RuntimeError("compile() the model first")
        self.state.params = value

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
                   initializers: Optional[Dict[str, object]] = None
                   ) -> Union[Tensor, List[Tensor]]:
        """Add a layer; returns its output, or the list of its outputs
        when it has more than one (split, top_k, group_by), as the JAX
        package does."""
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
        if len(layer.outputs) == 1:
            return layer.outputs[0]
        return layer.outputs

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               groups: int = 1, use_bias: bool = True, shared_op=None,
               kernel_initializer=None, bias_initializer=None,
               name: str = "") -> Tensor:
        p = Conv2DParams(out_channels=out_channels, kernel_h=kernel_h,
                         kernel_w=kernel_w, stride_h=stride_h,
                         stride_w=stride_w, padding_h=padding_h,
                         padding_w=padding_w, groups=groups,
                         use_bias=use_bias, activation=ActiMode(activation))
        return self._add_layer(OperatorType.OP_CONV2D, p, [input], name,
                               {"kernel": kernel_initializer,
                                "bias": bias_initializer})

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.POOL_MAX,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               name: str = "") -> Tensor:
        p = Pool2DParams(kernel_h=kernel_h, kernel_w=kernel_w,
                         stride_h=stride_h, stride_w=stride_w,
                         padding_h=padding_h, padding_w=padding_w,
                         pool_type=PoolType(pool_type),
                         activation=ActiMode(activation))
        return self._add_layer(OperatorType.OP_POOL2D, p, [input], name)

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_BATCHNORM,
                               BatchNormParams(relu=relu), [input], name)

    def flat(self, input: Tensor, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_FLAT, FlatParams(), [input],
                               name)

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

    def layer_norm(self, input: Tensor, axes: Sequence[int] = (-1,),
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: str = "") -> Tensor:
        p = LayerNormParams(axes=tuple(axes),
                            elementwise_affine=elementwise_affine, eps=eps)
        return self._add_layer(OperatorType.OP_LAYERNORM, p, [input], name)

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name="") -> Tensor:
        return self._add_layer(OperatorType.OP_DROPOUT,
                               DropoutParams(rate=rate, seed=seed), [input],
                               name)

    # elementwise binary (numpy broadcasting)
    def _binary(self, t: OperatorType, x: Tensor, y: Tensor,
                name: str) -> Tensor:
        return self._add_layer(t, ElementBinaryParams(op_type=t), [x, y], name)

    def add(self, x, y, inplace_a=False, name=""):
        return self._binary(OperatorType.OP_EW_ADD, x, y, name)

    def subtract(self, x, y, inplace_a=False, name=""):
        return self._binary(OperatorType.OP_EW_SUB, x, y, name)

    def multiply(self, x, y, inplace_a=False, name=""):
        return self._binary(OperatorType.OP_EW_MUL, x, y, name)

    def divide(self, x, y, inplace_a=False, name=""):
        return self._binary(OperatorType.OP_EW_DIV, x, y, name)

    def max(self, x, y, inplace_a=False, name=""):
        return self._binary(OperatorType.OP_EW_MAX, x, y, name)

    def min(self, x, y, inplace_a=False, name=""):
        return self._binary(OperatorType.OP_EW_MIN, x, y, name)

    # elementwise unary and scalar
    def _unary(self, t: OperatorType, x: Tensor, name: str, scalar=0.0,
               inplace=False) -> Tensor:
        p = ElementUnaryParams(op_type=t, inplace=inplace, scalar=scalar)
        return self._add_layer(t, p, [x], name)

    def exp(self, x, name=""):
        return self._unary(OperatorType.OP_EXP, x, name)

    def log(self, x, name=""):
        return self._unary(OperatorType.OP_LOG, x, name)

    def relu(self, x, inplace=True, name=""):
        return self._unary(OperatorType.OP_RELU, x, name, inplace=inplace)

    def sigmoid(self, x, name=""):
        return self._unary(OperatorType.OP_SIGMOID, x, name)

    def tanh(self, x, name=""):
        return self._unary(OperatorType.OP_TANH, x, name)

    def elu(self, x, inplace=True, name=""):
        return self._unary(OperatorType.OP_ELU, x, name, inplace=inplace)

    def gelu(self, x, name=""):
        return self._unary(OperatorType.OP_GELU, x, name)

    def identity(self, x, name=""):
        return self._unary(OperatorType.OP_IDENTITY, x, name)

    def rsqrt(self, x, name=""):
        return self._unary(OperatorType.OP_RSQRT, x, name)

    def sqrt(self, x, name=""):
        return self._unary(OperatorType.OP_SQRT, x, name)

    def sin(self, x, name=""):
        return self._unary(OperatorType.OP_SIN, x, name)

    def cos(self, x, name=""):
        return self._unary(OperatorType.OP_COS, x, name)

    def pow(self, x, exponent: float, name=""):
        return self._unary(OperatorType.OP_POW, x, name, scalar=exponent)

    def scalar_multiply(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OperatorType.OP_SCALAR_MULTIPLY, x, name,
                           scalar=scalar)

    def scalar_add(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OperatorType.OP_SCALAR_ADD, x, name, scalar=scalar)

    def scalar_sub(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OperatorType.OP_SCALAR_SUB, x, name, scalar=scalar)

    def scalar_true_divide(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OperatorType.OP_SCALAR_TRUE_DIV, x, name,
                           scalar=scalar)

    def batch_matmul(self, A: Tensor, B: Tensor, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name: str = "") -> Tensor:
        p = BatchMatmulParams(a_seq_length_dim, b_seq_length_dim)
        return self._add_layer(OperatorType.OP_BATCHMATMUL, p, [A, B], name)

    # shape ops
    def concat(self, tensors: Sequence[Tensor], axis: int,
               name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_CONCAT,
                               ConcatParams(axis=axis), list(tensors), name)

    def split(self, input: Tensor, sizes, axis: int,
              name: str = "") -> List[Tensor]:
        """Split along `axis` into `sizes` (a list) or into that many
        equal parts (an int); always returns a list."""
        if isinstance(sizes, int):
            if input.dims[axis] % sizes:
                raise ValueError(f"split: dim {input.dims[axis]} not "
                                 f"divisible into {sizes} parts")
            sizes = [input.dims[axis] // sizes] * sizes
        if sum(sizes) != input.dims[axis]:
            raise ValueError(f"split sizes {list(sizes)} don't sum to dim "
                             f"{input.dims[axis]}")
        out = self._add_layer(OperatorType.OP_SPLIT,
                              SplitParams(tuple(sizes), axis), [input], name)
        return out if isinstance(out, list) else [out]

    def reshape(self, input: Tensor, shape: Sequence[int],
                name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_RESHAPE,
                               ReshapeParams(tuple(shape)), [input], name)

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_TRANSPOSE,
                               TransposeParams(tuple(perm)), [input], name)

    def reverse(self, input: Tensor, axis: int, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_REVERSE,
                               ReverseParams(axis=axis), [input], name)

    def cast(self, input: Tensor, dtype, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_CAST,
                               CastParams(dtype=to_data_type(dtype)),
                               [input], name)

    def squeeze(self, input: Tensor, axes: Sequence[int] = (),
                name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_SQUEEZE,
                               SqueezeParams(tuple(axes)), [input], name)

    def unsqueeze(self, input: Tensor, axes: Sequence[int],
                  name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_UNSQUEEZE,
                               UnsqueezeParams(tuple(axes)), [input], name)

    def where(self, cond: Tensor, x: Tensor, y: Tensor,
              name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_WHERE, WhereParams(),
                               [cond, x, y], name)

    def resize(self, input: Tensor, out_shape: Sequence[int],
               name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_RESIZE,
                               ResizeParams(tuple(out_shape)), [input], name)

    def prelu(self, input: Tensor, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_PRELU, PReluParams(), [input],
                               name)

    def gather(self, input: Tensor, index: Tensor, dim: int = 0,
               name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_GATHER, GatherParams(dim=dim),
                               [input, index], name)

    # reductions
    def reduce_sum(self, input: Tensor, axes: Sequence[int],
                   keepdims: bool = False, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_REDUCE_SUM,
                               ReduceParams(tuple(axes), keepdims), [input],
                               name)

    def reduce_mean(self, input: Tensor, axes: Sequence[int],
                    keepdims: bool = False, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_REDUCE_MEAN,
                               ReduceParams(tuple(axes), keepdims), [input],
                               name)

    def mean(self, input: Tensor, dims: Sequence[int], keepdims: bool = False,
             name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_MEAN,
                               ReduceParams(tuple(dims), keepdims), [input],
                               name)

    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name: str = "") -> List[Tensor]:
        """[values, int32 indices] of the k largest along the last axis,
        sorted, ties to the lower index (ops/reduce.py)."""
        return self._add_layer(OperatorType.OP_TOPK,
                               TopKParams(k=k, sorted=sorted), [input], name)

    # the MoE family (reference: moe.cc:20-44 FFModel::moe composite)
    def group_by(self, input: Tensor, assign: Tensor, n: int, alpha: float,
                 name: str = ""):
        return self._add_layer(OperatorType.OP_GROUP_BY,
                               GroupByParams(n=n, alpha=alpha),
                               [input, assign], name)

    def aggregate(self, tensors: Sequence[Tensor], n: int,
                  lambda_bal: float = 0.0, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_AGGREGATE,
                               AggregateParams(n=n, lambda_bal=lambda_bal),
                               list(tensors), name)

    def aggregate_spec(self, tensors: Sequence[Tensor], n: int,
                       lambda_bal: float = 0.0, name: str = "") -> Tensor:
        return self._add_layer(OperatorType.OP_AGG_SPEC,
                               AggregateSpecParams(n=n,
                                                   lambda_bal=lambda_bal),
                               list(tensors), name)

    def cache(self, input: Tensor, num_batches: int = 1,
              name: str = "") -> Tensor:
        """Cross-batch activation cache (ops/moe.py CacheParams): training
        passes the input through and blends it into the op's buffers in
        `state.net_state`; inference serves the cached value."""
        return self._add_layer(OperatorType.OP_CACHE,
                               CacheParams(num_batches=num_batches), [input],
                               name)

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.0) -> Tensor:
        """reference: src/ops/moe.cc:20-44 -- gate -> top_k -> group_by ->
        per-expert dense -> aggregate."""
        gate_preds = self.dense(input, num_exp, ActiMode.AC_MODE_RELU)
        topk_out, topk_assign = self.top_k(gate_preds, num_select)
        exp_tensors = self.group_by(input, topk_assign, num_exp, alpha)
        if not isinstance(exp_tensors, list):
            exp_tensors = [exp_tensors]
        agg_inputs = [self.softmax(topk_out), topk_assign, topk_assign,
                      gate_preds]
        for et in exp_tensors:
            agg_inputs.append(self.dense(et, expert_hidden_size,
                                         ActiMode.AC_MODE_RELU))
        return self.aggregate(agg_inputs, num_exp, lambda_bal)

    # -- compile ------------------------------------------------------------
    def set_optimizer(self, opt) -> None:
        self.optimizer = opt

    # the reference's older spellings (flexflow_c.cc
    # flexflow_model_set_sgd_optimizer / _set_adam_optimizer), which the
    # bootcamp scripts call
    set_sgd_optimizer = set_optimizer
    set_adam_optimizer = set_optimizer

    def get_label_tensor(self) -> Tensor:
        """The label tensor, which compile() creates (the reference's cffi
        `label_tensor` property)."""
        if self.label_tensor is None:
            raise RuntimeError("the label tensor exists after compile(); "
                               "call compile() first")
        return self.label_tensor

    def compile(self, optimizer=None, loss_type=None, metrics: Sequence = ()):
        """Lower the layers to a PCG and initialize the weights and the
        optimizer state on `config.device`. A model compiled without a
        loss_type serves but cannot train. Only the manual single-device
        branch is ported: a strategy search or more than one device
        raises."""
        if self.config.search_budget >= 0:
            raise NotImplementedError(
                "strategy search (search_budget >= 0) is not ported to "
                "flexflow_tpu_torch yet; use search_budget=-1")
        n_dev = self.config.workersPerNode
        if n_dev != 1:
            raise NotImplementedError(
                f"{n_dev} devices requested: only single-device execution "
                "is ported to flexflow_tpu_torch (set workersPerNode=1)")
        if optimizer is not None:
            self.optimizer = optimizer
        if self.optimizer is None:
            # the JAX package's default, SGD at its config's default lr
            self.optimizer = SGDOptimizer()
        self.loss_type = (to_loss_type(loss_type) if loss_type is not None
                          else None)
        self.metrics = tuple(metrics)
        self.graph, tensor_map = layers_to_pcg(self.layers)
        if self.label_tensor is None:
            # class ids (..., 1) for sparse CE, else the output's shape
            logits_pt = self.graph.output_tensors()[-1]
            sparse = (self.loss_type
                      == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
            shape = tuple(logits_pt.material_shape())
            self.label_tensor = Tensor(
                shape[:-1] + (1,) if sparse else shape,
                DataType.DT_INT32 if sparse else logits_pt.data_type,
                name="label")
            self.label_tensor._model = self
        graph_inputs = {pt.guid: pt for pt in self.graph.input_tensors()}
        self._fit_input_tensors = [
            t for t in self.input_tensors
            if tensor_map.get(t.guid) in graph_inputs]
        mixed = self.config.allow_mixed_precision
        self.executor = PCGExecutor(
            self.graph, self.device, optimizer=self.optimizer,
            loss_type=self.loss_type,
            metrics=Metrics(self.loss_type, self.metrics),
            compute_dtype=torch.bfloat16 if mixed else None,
            # bf16 gradient storage rides mixed precision, as in JAX
            grad_dtype=torch.bfloat16 if mixed else None,
            seed=self.config.seed,
            input_order=[graph_inputs[tensor_map[t.guid]]
                         for t in self._fit_input_tensors],
            remat=self.config.remat)
        self.state = self.executor.init_state()
        self.perf_metrics = PerfMetrics()
        self._rng = torch.Generator().manual_seed(self.config.seed)

    def init_layers(self) -> None:
        """Initialize every weight, the optimizer state and the stateful
        ops' buffers afresh (reference: flexflow_cffi.py:1975), as
        compile() did."""
        if self.executor is None:
            raise RuntimeError("init_layers: call compile() first")
        self.state = self.executor.init_state()

    def create_data_loader(self, batch_tensor: Tensor,
                           full_array: np.ndarray) -> SingleDataLoader:
        """A loader over `full_array` in batches of `batch_tensor`'s first
        dim (an input tensor, or `get_label_tensor()` for the labels)."""
        dl = SingleDataLoader(self, batch_tensor, full_array)
        self._dataloaders.append(dl)
        return dl

    # -- training -----------------------------------------------------------
    @staticmethod
    def _batches(arrays: List[np.ndarray], batch_size: int):
        for i in range(arrays[0].shape[0] // batch_size):
            yield [a[i * batch_size:(i + 1) * batch_size] for a in arrays]

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, verbose: bool = True):
        """Train on (x, y), arrays or data loaders (`create_data_loader`):
        one train step per full batch, `epochs` passes
        (config.epochs by default). The tail that does not fill a batch is
        dropped, with a warning. With config.iterations_per_dispatch N > 1
        the batches go N at a time through the train scan, the last
        shorter chunk through its own, with the same step seeds as one
        step per batch. Prints each epoch's loss and metrics when
        `verbose`, and the reference's ELAPSED TIME / THROUGHPUT line at
        the end. Returns the last epoch's PerfMetrics."""
        if self.executor is None:
            raise RuntimeError("fit: call compile() first")
        x, y = _unwrap_loaders(x, y)
        step_fn = self.executor.build_train_step()
        spd = max(1, self.config.iterations_per_dispatch)
        scan_fn = self.executor.build_train_scan() if spd > 1 else None
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        bs = batch_size or self.config.batch_size
        ep = epochs or self.config.epochs
        n = xs[0].shape[0]
        if n < bs:
            raise ValueError(
                f"dataset has {n} samples < batch_size {bs}; nothing to train on")
        if n % bs != 0:
            print(f"[flexflow_tpu_torch] warning: dropping {n % bs} tail "
                  f"samples (dataset {n} % batch {bs})")
        start = time.time()
        num_samples = 0
        for epoch in range(ep):
            # per-epoch accumulator like the reference (model.cc
            # reset_metrics); partials stay on the device until the
            # epoch's end, so the host does not wait on every step
            self.perf_metrics = PerfMetrics()
            device_partials = []
            chunk: List[list] = []

            def flush(chunk):
                # one dispatch for the chunk's steps; one seed per step,
                # drawn exactly as the stepwise path draws them
                seeds = self.executor.seed_table(
                    [step_seed(self._rng) for _ in chunk])
                self.state, partials = scan_fn(
                    self.state, [[b[i] for b in chunk]
                                 for i in range(len(xs))],
                    [b[-1] for b in chunk], seeds)
                device_partials.append(partials)

            for batch in self._batches(xs + [y], bs):
                if scan_fn is not None:
                    chunk.append(batch)
                    if len(chunk) == spd:
                        flush(chunk)
                        chunk = []
                else:
                    self.state, partials = step_fn(self.state, batch[:-1],
                                                   batch[-1], self._rng)
                    device_partials.append(partials)
                num_samples += bs
            if chunk:  # tail chunk shorter than spd (its own graph)
                flush(chunk)
            folded = {k: float(torch.cat([p[k].reshape(-1)
                                          for p in device_partials])
                               .double().sum())
                      for k in device_partials[0]}
            last_loss = float(device_partials[-1]["loss"].reshape(-1)[-1])
            folded.pop("loss")
            self.perf_metrics.update(folded)
            if verbose:
                print(f"epoch {epoch}: loss={last_loss:.4f} "
                      + self.perf_metrics.report())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.time() - start
        # reference: transformer.cc:208-211 throughput print
        print(f"ELAPSED TIME = {elapsed:.4f}s, "
              f"THROUGHPUT = {num_samples / elapsed:.2f} samples/s")
        return self.perf_metrics

    def eval(self, x=None, y=None, batch_size: Optional[int] = None):
        """Metrics and loss of the inference forward over full batches of
        (x, y), arrays or data loaders; stateful ops read the running
        buffers. Prints the metrics line and returns the PerfMetrics."""
        if self.executor is None:
            raise RuntimeError("eval: call compile() first")
        x, y = _unwrap_loaders(x, y)
        step_fn = self.executor.build_eval_step()
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        pm = PerfMetrics()
        for batch in self._batches(xs + [y],
                                   batch_size or self.config.batch_size):
            _, partials = step_fn(self.params, batch[:-1], batch[-1],
                                  self.state.net_state)
            pm.update({k: float(v) for k, v in partials.items()})
        print(pm.report())
        return pm

    # -- inference ----------------------------------------------------------
    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Forward over a dataset in compiled-batch chunks -> numpy. The
        tail that does not fill a batch is padded and its rows dropped."""
        if self.executor is None:
            raise RuntimeError("compile() the model first")
        fwd = self.executor.build_forward()
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
            y = fwd(self.params, chunk,
                    self.state.net_state).float().cpu().numpy()
            outs.append(y[:bs - short])
        return np.concatenate(outs)

    # -- stepwise API for cffi parity (reference: model.cc forward/backward/
    #    update/zero_gradients driven from flexflow_cffi.fit) -------------
    def set_iteration_batch(self, inputs: List[np.ndarray], label: np.ndarray):
        """Bind the batch the next forward/backward run on: inputs in
        creation order, and the labels."""
        self._current_batch = (inputs, label)

    def _bound_inputs(self) -> List:
        if self.executor is None or self._current_batch is None:
            raise RuntimeError("compile() the model and set_iteration_batch "
                               "first")
        inputs, _ = self._current_batch
        for i, a in enumerate(inputs):
            if a is None:
                raise ValueError(
                    f"input tensor '{self._fit_input_tensors[i].name or i}' "
                    "was never attached")
        return inputs

    def forward(self, seq_length: int = -1):
        """The inference forward of the bound batch (the JAX package's
        stepwise `forward`): returns the graph output on the device."""
        inputs = self._bound_inputs()
        fwd = self.executor.build_forward(seq_length)
        self._last_logits = fwd(self.params, inputs, self.state.net_state)
        return self._last_logits

    def zero_gradients(self):
        self._pending_grads = None

    def backward(self, seq_length: int = -1):
        """Gradients of the loss on the bound batch, and the stateful ops'
        new buffers, kept for `update`. As in the JAX package no op draws
        random numbers (no rng)."""
        inputs = self._bound_inputs()
        _, label = self._current_batch
        if label is None:
            raise ValueError("the label tensor was never attached")
        grad_fn = self.executor.build_grad_step(seq_length)
        self._pending_net_state = {}
        self._pending_grads = grad_fn(self.params, inputs, label,
                                      self.state.net_state,
                                      self._pending_net_state)

    def update(self):
        """Apply the pending gradients with the optimizer and the pending
        buffers of the stateful ops (both in place), and advance the
        step."""
        if self._pending_grads is None:
            raise RuntimeError("call backward() first")
        self.optimizer.update(self.state.params, self._pending_grads,
                              self.state.opt_state)
        with torch.no_grad():
            for op, bufs in (self._pending_net_state or {}).items():
                for k, v in bufs.items():
                    self.state.net_state[op][k].copy_(v)
        self.state.step += 1
        self._pending_grads = None
        self._pending_net_state = None


def _unwrap_loaders(x, y):
    """fit and eval take SingleDataLoaders for x and y, as the reference
    does (fit(x=dataloader_input, y=dataloader_label)): each stands for
    its array's first num_samples rows."""

    def unwrap(v):
        if isinstance(v, SingleDataLoader):
            return v.full_array[:v.num_samples]
        return v

    if isinstance(x, (list, tuple)):
        x = [unwrap(v) for v in x]
    else:
        x = unwrap(x)
    return x, unwrap(y)
