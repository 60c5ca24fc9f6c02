"""FFModel: the user-facing model container.

The PyTorch counterpart of flexflow_tpu/core/model.py: the builder methods
of the ported ops (the ones the served LM, the flagship Transformer, the
PyTorch frontend, the CNNs and the rest of the zoo call: the shape ops,
the reductions and top_k, batch_matmul, PReLU, the MoE family with its
`moe` composite and the LSTM; an op with several outputs returns their
list), `compile` on the manual single-device branch (it creates the
label tensor, `get_label_tensor`; with `config.perform_fusion` it packs
op chains into fused ops, pcg/fusion.py), `init_layers`,
`create_data_loader`, `fit` and `eval` (training; both take arrays or
data loaders), `predict` (serving) and the stepwise API
(`set_iteration_batch`, `forward`, `zero_gradients`, `backward`,
`update`), constant inputs (`create_constant`, `create_constant_tensor`),
`compile_decode` (a second search under the decode objective, whose
executor the ContinuousBatcher serves from) and
`output_probability_like`. Stateful ops' buffers (BatchNorm's running
statistics, Cache's cached value) live in `self.state.net_state`:
training updates them, eval, `predict` and the stepwise `forward` read
them. Op names follow the JAX package
(`f"{op_type.name.lower()}_{len(self.layers)}"`), so weights carry across
by (op name, weight name) (runtime/weights.py).

`compile` builds the loss, the metrics and the optimizer state into
`self.state` (a TrainState); `self.params` is `self.state.params`, the one
dict that training updates and serving reads. With `search_budget >= 0`
it runs the Unity strategy search first (substitutions and the DP over
machine views, priced by the machine and cost models of search/, from
times measured on the device with `measure_operator_costs`) for the
configured machine -- a machine file, or H100s with their published
numbers -- and then demotes the winner to the one device it runs on, as
the JAX package does on a smaller mesh. Each compile records its phases
and the search's decisions in `self.search_trajectory`. More than one
device is refused: multi-device execution is not ported yet. `fit` is
the JAX package's loop: per-epoch metrics, the reference's throughput
line, each step's seed drawn from the model's CPU generator
(as the JAX loop splits its key), and one eager train step per batch or,
with `config.iterations_per_dispatch` N > 1, chunks of N batches through
the executor's train scan (one CUDA graph replay per chunk on a card),
the shorter tail chunk through its own. Given any of its resilience
keywords, `fit` runs the JAX package's resilient loop instead
(`_fit_resilient`, one device): atomic checkpoints with crc32 integrity
every N steps (runtime/checkpoint.py, runtime/resilience.py
CheckpointManager), mid-epoch resume bit for bit (the data cursor and
the step-seed generator's state ride in the checkpoint's sidecar), the
NaN/Inf step guard with a dynamic loss scale (parallel/executor.py),
preemption between steps (hard, graceful, and the drain protocol of a
deadline-bearing notice) and deterministic fault injection. The
resilient loop dispatches stepwise, as the JAX package's does. Not
ported yet, and refused by name: `elastic`, `health_monitor`,
`verify_strategy`, `canary`, `tuner`, `lint` and `telemetry` (an active
obs session is fed steps and epochs, but `fit` cannot start one: its
model wiring needs the analysis passes).
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
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
from ..ops.lstm import LSTMParams
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
from ..obs.trajectory import SearchTrajectory
from ..parallel.executor import PCGExecutor, TrainState
from ..pcg.fusion import apply_fusion
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
        # constant inputs: tensor guid -> a float or a baked array
        self._constant_values: Dict[int, Union[float, np.ndarray]] = {}
        # compile_decode's products
        self.decode_graph = None
        self.decode_executor: Optional[PCGExecutor] = None
        self.decode_searched_views = None
        self.decode_searched_cost = None
        self.decode_trajectory = None

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

    def create_constant(self, dims: Sequence[int], value: float,
                        data_type: DataType = DataType.DT_FLOAT) -> Tensor:
        """A constant input tensor filled with `value`: materialized by the
        executor, never one of fit()'s batch inputs (reference:
        flexflow_cffi.py:941)."""
        t = self.create_tensor(dims, data_type, create_grad=False)
        self._constant_values[t.guid] = float(value)
        return t

    def create_constant_tensor(self, array, data_type=None) -> Tensor:
        """A constant tensor with arbitrary (non-trainable) contents: baked
        masks, position tables."""
        arr = np.asarray(array)
        dt = to_data_type(arr.dtype) if data_type is None \
            else to_data_type(data_type)
        t = self.create_tensor(arr.shape, dt, create_grad=False)
        self._constant_values[t.guid] = arr.astype(dt.np_dtype)
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

    def lstm(self, input: Tensor, hidden_size: int,
             return_sequences: bool = True, name: str = "") -> Tensor:
        """An LSTM over (batch, seq, features) (ops/lstm.py): the hidden
        states of every step, or the last step's with return_sequences
        False."""
        return self._add_layer(OperatorType.OP_LSTM,
                               LSTMParams(hidden_size=hidden_size,
                                          return_sequences=return_sequences),
                               [input], name)

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

    def compile(self, optimizer=None, loss_type=None, metrics: Sequence = (),
                calibration=None, artifact_store=None):
        """Lower the layers to a PCG, choose its strategy (the Unity search
        when config.search_budget >= 0 and not only_data_parallel) and
        initialize the weights and the optimizer state on
        `config.device`. A model compiled without a loss_type serves but
        cannot train. More than one device, a calibration store and an
        artifact store are not ported and raise."""
        if calibration is not None:
            raise NotImplementedError(
                "compile(calibration=...): measured calibration stores (the "
                "JAX package's obs/calibration.py) are not ported to "
                "flexflow_tpu_torch yet; measure_operator_costs prices ops "
                "from the device instead")
        if artifact_store is not None:
            raise NotImplementedError(
                "compile(artifact_store=...): the strategy artifact store "
                "(the JAX package's runtime/artifact_store.py) is not "
                "ported to flexflow_tpu_torch yet")
        n_dev = self.config.workersPerNode
        if n_dev != 1:
            raise NotImplementedError(
                f"{n_dev} devices requested: only single-device execution "
                "is ported to flexflow_tpu_torch (set workersPerNode=1; "
                "search_num_workers searches for a bigger machine)")
        if optimizer is not None:
            self.optimizer = optimizer
        if self.optimizer is None:
            # the JAX package's default, SGD at the config's rate
            self.optimizer = SGDOptimizer(lr=self.config.learning_rate)
        self.loss_type = (to_loss_type(loss_type) if loss_type is not None
                          else None)
        self.metrics = tuple(metrics)
        # every compile records its phases and the search's decisions
        self.search_trajectory = SearchTrajectory()
        self.compile_phase_s = {}
        t_phase = time.perf_counter()
        self.graph, tensor_map = layers_to_pcg(self.layers)
        if self.config.perform_fusion:
            # reference: apply_fusion (model.cc:2495, --fusion); the
            # chains' weights move under their fused ops
            self.graph = apply_fusion(self.graph)
        self._phase("lowering", t_phase,
                                     ops=len(self.graph.ops))
        # the user's inputs by their position among the graph's inputs:
        # a search rewrite copies the graph with fresh tensors, and the
        # positions survive the copy
        pre_pos = {pt.guid: i
                   for i, pt in enumerate(self.graph.input_tensors())}
        self._fit_input_tensors = [
            t for t in self.input_tensors
            if tensor_map.get(t.guid) in pre_pos
            and t.guid not in self._constant_values]
        self._input_positions = [pre_pos[tensor_map[t.guid]]
                                 for t in self._fit_input_tensors]
        self._constant_positions = {
            pre_pos[tensor_map[t.guid]]: self._constant_values[t.guid]
            for t in self.input_tensors
            if t.guid in self._constant_values
            and tensor_map.get(t.guid) in pre_pos}
        self.searched_views = None
        self.searched_cost = None
        self.searched_op_costs = None
        if self.config.search_budget >= 0 and \
                not self.config.only_data_parallel:
            t_phase = time.perf_counter()
            self._run_strategy_search(1)
            self.strategy_provenance = {"source": "search"}
            self._phase("strategy_search", t_phase,
                                         devices=1)
        else:
            # the manual lowering: every degree 1 on the one device
            self.strategy_provenance = {"source": "manual"}
        self._check_probability_tail()
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
        mixed = self.config.allow_mixed_precision
        t_phase = time.perf_counter()
        inputs, constants = self._graph_inputs(self.graph)
        self.executor = PCGExecutor(
            self.graph, self.device, optimizer=self.optimizer,
            loss_type=self.loss_type,
            metrics=Metrics(self.loss_type, self.metrics),
            compute_dtype=torch.bfloat16 if mixed else None,
            # bf16 gradient storage rides mixed precision, as in JAX
            grad_dtype=torch.bfloat16 if mixed else None,
            seed=self.config.seed, input_order=inputs,
            remat=self.config.remat, constants=constants)
        self._phase("executor_build", t_phase)
        t_phase = time.perf_counter()
        self.state = self.executor.init_state()
        self._phase("init_state", t_phase)
        self.perf_metrics = PerfMetrics()
        self._rng = torch.Generator().manual_seed(self.config.seed)

    def _graph_inputs(self, graph):
        """(the batch inputs in creation order, the constants {guid:
        (tensor, value)}) of a lowering of this model's layers, by their
        positions among its inputs: a search rewrite copies the graph with
        fresh tensors, and the positions survive the copy."""
        cur = graph.input_tensors()
        return ([cur[i] for i in self._input_positions],
                {cur[i].guid: (cur[i], v)
                 for i, v in self._constant_positions.items()})

    def _phase(self, name: str, t0: float, **fields) -> None:
        """Record a compile phase in the trajectory and in
        `compile_phase_s` (the trajectory is bounded, and a long search
        can fill it before the phases after it land)."""
        self.search_trajectory.phase(name, t0, **fields)
        self.compile_phase_s[name] = time.perf_counter() - t0

    # -- the strategy search --------------------------------------------------
    def _build_cost_model(self, objective: str = "train"):
        """The search's cost oracle: the machine of the config's machine
        file, else H100s with their published numbers
        (search/machine_model.py h100_machine), search_num_nodes x
        search_num_workers of them when set (1 x 1 otherwise). No
        calibration is applied: the port ships no fit. `objective` is what
        it prices (search/cost_model.py CostObjective): "train" or
        "decode", the one-token memory-roofline pricing of
        compile_decode's search."""
        from ..search import CostModel, h100_machine, parse_machine_config

        cfg = self.config
        if cfg.machine_model_file:
            machine = parse_machine_config(cfg.machine_model_file)
        else:
            nodes = cfg.search_num_nodes if cfg.search_num_nodes > 0 else 1
            workers = (cfg.search_num_workers if cfg.search_num_workers > 0
                       else cfg.workersPerNode)
            machine = h100_machine(nodes, workers)
        # the JAX package's default search_survivability_penalty (auto):
        # a bias toward node-loss-survivable strategies only where nodes
        # exist as failure domains
        pen = 0.25 if machine.num_nodes > 1 else 0.0
        return CostModel(machine, bf16=cfg.allow_mixed_precision,
                         survivability_penalty=pen, objective=objective)

    def compile_decode(self, *, strategy_path: Optional[str] = None,
                       export_path: Optional[str] = None) -> PCGExecutor:
        """Run the Unity search a SECOND time over the same layer graph
        with the DECODE cost objective: one-token decode is bound by
        memory where training is bound by compute, so the cheapest
        parallelization differs (search/cost_model.py CostObjective).

        The model then carries two strategies: `graph`/`searched_views`
        (training and prefill) and `decode_graph`/`decode_searched_views`
        with `decode_searched_cost`, and `decode_trajectory` records this
        search. The ContinuousBatcher builds its running-batch decode step
        from `decode_executor` while prefill keeps the training strategy
        (runtime/serving.py). As `compile` does, the winner is demoted to
        the one device the port runs on.

        strategy_path: import the decode strategy from a strategy_io JSON
        file instead of searching (ServingConfig.decode_strategy_path feeds
        this). export_path: export the searched strategy for a later
        import. Returns the decode executor. The JAX package's perf and
        precision lints of the winner are not ported."""
        if self.executor is None:
            raise RuntimeError(
                "compile() the model before compile_decode(): the decode "
                "strategy is searched over the same layer graph and serves "
                "alongside the training one")
        from types import SimpleNamespace

        from ..parallel import strategies
        from ..runtime.strategy_io import (apply_imported_strategy,
                                           export_strategy, import_strategy)
        from ..search import run_strategy_validators

        cfg = self.config
        ndev = 1
        self.decode_trajectory = SearchTrajectory()
        t_phase = time.perf_counter()
        # a fresh lowering: the training search rewrote self.graph with
        # its own substitutions; the decode search starts from the layers
        graph, _ = layers_to_pcg(self.layers)
        if cfg.perform_fusion:
            graph = apply_fusion(graph)
        self.decode_trajectory.phase("decode_lowering", t_phase,
                                     ops=len(graph.ops))
        cost_model = self._build_cost_model(objective="decode")
        t_phase = time.perf_counter()
        if strategy_path:
            strategy = import_strategy(strategy_path)
            apply_imported_strategy(graph, strategy, num_devices=ndev)
            views = {op.guid: op.machine_view for op in graph.ops
                     if op.machine_view is not None}
            cost = None
            self.decode_trajectory.phase(
                "decode_strategy_import", t_phase, records=len(strategy),
                devices=ndev)
        else:
            from ..pcg.machine_view import MachineResource
            from ..search import (GraphSearchHelper, SearchHelper,
                                  generate_all_pcg_xfers)

            machine = cost_model.machine
            sh = SearchHelper(cost_model, trajectory=self.decode_trajectory)
            degrees = []
            d = 2
            while d <= machine.num_workers:
                degrees.append(d)
                d *= 2
            budget = cfg.search_budget if cfg.search_budget > 0 else 10
            # parallelization xfers ONLY, no operator substitutions: a
            # substitution builds its ops' weights afresh, but the decode
            # strategy serves the weights trained under the training graph
            # (the batcher feeds both lowerings one param store, by op
            # name)
            xfers = generate_all_pcg_xfers(degrees or [1], cfg)
            res = MachineResource(
                num_nodes=machine.num_nodes,
                all_procs_per_node=machine.workers_per_node,
                available_procs_per_node=machine.workers_per_node)
            gsh = GraphSearchHelper(sh, xfers, alpha=cfg.search_alpha,
                                    budget=budget,
                                    trajectory=self.decode_trajectory)
            graph, result = gsh.graph_optimize(graph, res)
            views, cost = result.views, result.cost
            self.decode_trajectory.phase("decode_strategy_search", t_phase,
                                         devices=ndev)
        self.decode_graph = graph
        self.decode_searched_views = views
        self.decode_searched_cost = cost
        problems = run_strategy_validators(graph, views, ndev)
        if problems:
            warnings.warn(
                "decode-searched strategy failed structural validation "
                "(falling through to lowering, which demotes infeasible "
                "degrees to replicated): " + "; ".join(problems[:5]))
        if export_path:
            export_strategy(graph, SimpleNamespace(views=views, cost=cost),
                            export_path)
        # demotes every degree the one device cannot hold
        strategies.assign_mesh_axes(graph, ndev)
        # params stay keyed by op name, so the decode executor serves the
        # training state's weights; the batcher checks that before
        # swapping it in (runtime/serving.py)
        inputs, constants = self._graph_inputs(graph)
        t_phase = time.perf_counter()
        self.decode_executor = PCGExecutor(
            graph, self.device, optimizer=self.optimizer,
            loss_type=self.loss_type,
            metrics=Metrics(self.loss_type, self.metrics),
            compute_dtype=(torch.bfloat16 if cfg.allow_mixed_precision
                           else None),
            grad_dtype=None,  # decode never makes gradients
            seed=cfg.seed, input_order=inputs, constants=constants)
        self.decode_trajectory.phase("decode_executor_build", t_phase)
        return self.decode_executor

    def output_probability_like(self, output_index: int = -1
                                ) -> Optional[bool]:
        """Whether the model's output carries PROBABILITIES (its tail op is
        softmax/sigmoid or a fused sigmoid activation) rather than raw
        logits; None when undetermined (not compiled). Serving's beam
        scorer uses this instead of sniffing values."""
        if self.graph is None:
            return None
        outs = self.graph.output_tensors()
        if not outs:
            return None
        pt = outs[output_index]
        ops = [o for o in self.graph.ops
               if any(t.guid == pt.guid for t in o.outputs)]
        if not ops:
            return None
        return _probability_like_tail(*_resolve_value_tail(ops[0]))

    def _is_training_compile(self) -> bool:
        """A compile without a loss serves: it allocates no gradients or
        optimizer slots, so the memory check charges none."""
        return self.loss_type is not None

    def _grad_bytes_ratio(self) -> float:
        """Gradient-buffer width relative to the master weight: 0.5 under
        the bf16-grad recipe mixed precision uses, else 1.0."""
        return 0.5 if self.config.allow_mixed_precision else 1.0

    def _run_strategy_search(self, ndev: int) -> None:
        """Unity search over the lowered PCG (reference: compile's
        GRAPH_OPTIMIZE_TASK -> GraphSearchHelper::graph_optimize,
        substitution.cc:1898), then the winner's lowering onto `ndev`
        devices: every degree that does not fit is demoted to replicated
        (parallel/strategies.py assign_mesh_axes)."""
        import os

        from ..parallel import strategies
        from ..pcg.machine_view import MachineResource
        from ..search import (GraphSearchHelper, SearchHelper,
                              generate_all_pcg_xfers,
                              run_strategy_validators)
        from ..search.substitution_loader import (
            default_rules_path, load_rule_collection_from_path,
            rules_to_substitutions, zoo_rules_path)

        cfg = self.config
        cost_model = self._build_cost_model()
        self.search_cost_model = cost_model
        machine = cost_model.machine
        self.measurer = None
        if cfg.measure_operator_costs:
            # --measured-search: per-op device timing feeds the search
            from ..search.measure import attach_measured_mode

            self.measurer = attach_measured_mode(
                cost_model,
                compute_dtype=(torch.bfloat16
                               if cfg.allow_mixed_precision else None),
                device=self.device,
                cache_path=cfg.measured_cache_path or None)
        sh = SearchHelper(cost_model, trajectory=self.search_trajectory)
        degrees = []
        d = 2
        while d <= machine.num_workers:
            degrees.append(d)
            d *= 2
        budget = cfg.search_budget if cfg.search_budget > 0 else 10
        xfers = generate_all_pcg_xfers(degrees or [1], cfg)
        # declarative rules: --substitution-json, or the shipped ones
        if cfg.substitution_json_path:
            # an explicit file that is missing raises: no silent fallback
            # to the shipped rules
            rules = load_rule_collection_from_path(cfg.substitution_json_path)
            xfers = xfers + rules_to_substitutions(rules)
        else:
            for rp in (default_rules_path(), zoo_rules_path()):
                if os.path.exists(rp):
                    rules = load_rule_collection_from_path(rp)
                    xfers = xfers + rules_to_substitutions(rules)
        res = MachineResource(
            num_nodes=machine.num_nodes,
            all_procs_per_node=machine.workers_per_node,
            available_procs_per_node=machine.workers_per_node)
        gsh = GraphSearchHelper(sh, xfers, alpha=cfg.search_alpha,
                                budget=budget,
                                trajectory=self.search_trajectory)
        best_graph, result = gsh.graph_optimize(self.graph, res)
        self.graph = best_graph
        self.searched_views = result.views
        self.searched_cost = result.cost
        self._check_searched_memory(cost_model, result)
        problems = run_strategy_validators(self.graph, self.searched_views,
                                           ndev)
        if problems:
            warnings.warn(
                "searched strategy failed structural validation (falling "
                "through to lowering, which demotes infeasible degrees to "
                "replicated): " + "; ".join(problems[:5]))
        if cfg.export_strategy_file:
            from ..runtime.strategy_io import export_strategy

            export_strategy(self.graph, result, cfg.export_strategy_file)
        self.searched_op_costs = self._searched_op_costs(cost_model, result)
        self.searched_axes = strategies.assign_mesh_axes(self.graph, ndev)

    def _searched_op_costs(self, cost_model, result) -> List[dict]:
        """How the winner's compute ops were priced, in topo order: each
        op's view, whether its cost came from a measurement (and which),
        and the cost beside the analytic roofline's for the same op and
        view. Read before the lowering to one device changes the ops'
        degrees."""
        from ..search import CostModel

        analytic = CostModel(cost_model.machine, bf16=cost_model.bf16)
        meas = getattr(cost_model.measure_fn, "measurements", None)
        table = []
        for op in self.graph.topo_order():
            view = result.views.get(op.guid)
            if op.is_parallel_op or view is None:
                continue
            got = cost_model.measure_operator_cost(op, view)
            ref = analytic.measure_operator_cost(op, view)
            rec = (meas.get(cost_model.measure_fn.key_of(op, view))
                   if meas is not None else None)
            table.append({
                "name": op.name, "op_type": op.op_type.name,
                "view": (view.start_device_id, tuple(view.dim),
                         tuple(view.stride)),
                "measured": cost_model._key(op, view) in cost_model.measured,
                "measurement": rec,
                "fwd_s": got.forward_time, "bwd_s": got.backward_time,
                "analytic_fwd_s": ref.forward_time,
                "analytic_bwd_s": ref.backward_time})
        return table

    def _check_searched_memory(self, cost_model, result) -> None:
        """The head of the JAX package's _search_pipeline_degree: the
        winner's per-device training memory (weights, gradients,
        optimizer slots and activations) against the device's capacity.
        When it does not fit, the JAX package weighs pipeline stages and
        a memory-aware re-search; neither is ported, so this raises
        rather than pick a strategy the port cannot run."""
        from ..search.memory_optimization import measure_memory

        train = self._is_training_compile()
        mem = measure_memory(
            self.graph, result.views, cost_model, train=train,
            optimizer=self.optimizer,
            grad_bytes_ratio=self._grad_bytes_ratio()).max_bytes
        budget = cost_model.machine.chip.hbm_capacity
        self.search_trajectory.event("memory_check", bytes=mem,
                                     budget=budget)
        if mem > budget:
            raise NotImplementedError(
                f"the searched strategy needs {mem / 2 ** 20:.0f} MiB a "
                f"device, over the {budget / 2 ** 20:.0f} MiB budget; the "
                "pipeline search and the memory-aware search that would "
                "look for one that fits (the JAX package's "
                "_search_pipeline_degree, search/memory_optimization.py) "
                "are not ported to flexflow_tpu_torch yet")

    def _check_probability_tail(self) -> None:
        """Warn, as the JAX package does, when a cross-entropy loss is
        put on an output that is not a probability (its value-producing
        tail op, through --fusion chains and shape-only steps)."""
        if self.loss_type not in (
                LossType.LOSS_CATEGORICAL_CROSSENTROPY,
                LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY):
            return
        guid = self.graph.output_tensors()[-1].guid
        op = next(o for o in self.graph.ops
                  if any(t.guid == guid for t in o.outputs))
        tail_type, tail_params = _resolve_value_tail(op)
        if not _probability_like_tail(tail_type, tail_params):
            warnings.warn(
                "cross-entropy losses expect probability outputs (the "
                "reference's loss kernels take them; loss_functions.cc) but "
                f"the model's final op is {tail_type.name} — raw logits get "
                "clipped to [1e-12, 1] and gradients die. End the model "
                "with model.softmax(...).")

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
            epochs: Optional[int] = None, verbose: bool = True, *,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every_n_steps: Optional[int] = None,
            keep_last_n: int = 3, resume: bool = True,
            skip_nonfinite_steps: bool = False, step_guard=None,
            max_consecutive_skips: int = 10, fault_injector=None,
            preemption_signal=None, elastic: bool = False,
            health_monitor=None, verify_strategy=None, canary=None,
            lint: Optional[str] = None, telemetry=None, tuner=None):
        """Train on (x, y), arrays or data loaders (`create_data_loader`):
        one train step per full batch, `epochs` passes
        (config.epochs by default). The tail that does not fill a batch is
        dropped, with a warning. With config.iterations_per_dispatch N > 1
        the batches go N at a time through the train scan, the last
        shorter chunk through its own, with the same step seeds as one
        step per batch. Prints each epoch's loss and metrics when
        `verbose`, and the reference's ELAPSED TIME / THROUGHPUT line at
        the end. Returns the last epoch's PerfMetrics.

        The resilience keywords are the JAX package's, with its
        semantics; any of `checkpoint_dir`, `skip_nonfinite_steps`,
        `step_guard`, `fault_injector` or `preemption_signal` runs the
        resilient loop (`_fit_resilient`, stepwise). `elastic`,
        `health_monitor`, `verify_strategy`, `canary`, `tuner`, `lint`
        and `telemetry` need modules not ported yet and raise
        NotImplementedError naming them."""
        from ..runtime.verify import NotCompiledError

        if self.executor is None:
            raise NotCompiledError("fit: call compile() first")
        if lint not in (None, "off", "warn", "error"):
            raise ValueError(
                'fit(lint=...) accepts "error", "warn", or "off" '
                f"(got {lint!r})"
            )
        _refuse_unported_fit_keywords(
            elastic=bool(elastic), health_monitor=health_monitor is not None,
            verify_strategy=bool(verify_strategy), canary=canary is not None,
            tuner=tuner is not None, lint=lint in ("warn", "error"),
            telemetry=telemetry is not None)
        x, y = _unwrap_loaders(x, y)
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        bs = batch_size or self.config.batch_size
        ep = epochs or self.config.epochs
        n = xs[0].shape[0]
        if n < bs:
            raise ValueError(
                f"dataset has {n} samples < batch_size {bs}; nothing to train on")
        if n % bs != 0:
            obs.progress(
                f"[flexflow_tpu_torch] warning: dropping {n % bs} tail "
                f"samples (dataset {n} % batch {bs})",
                name="tail_samples_dropped", dropped=n % bs)
        tel = obs.active()
        if (checkpoint_dir is not None or skip_nonfinite_steps
                or step_guard is not None or fault_injector is not None
                or preemption_signal is not None):
            return self._fit_resilient(
                xs, y, bs, ep, verbose, checkpoint_dir=checkpoint_dir,
                checkpoint_every_n_steps=checkpoint_every_n_steps,
                keep_last_n=keep_last_n, resume=resume,
                skip_nonfinite_steps=skip_nonfinite_steps,
                step_guard=step_guard,
                max_consecutive_skips=max_consecutive_skips,
                fault_injector=fault_injector,
                preemption_signal=preemption_signal, tel=tel)
        # guard residue from a previous resilient fit would change the
        # step; drop it for the fast unguarded paths
        self.executor.set_step_guard(None)
        self.state.guard = None
        step_fn = self.executor.build_train_step()
        spd = max(1, self.config.iterations_per_dispatch)
        scan_fn = self.executor.build_train_scan() if spd > 1 else None
        start = time.time()
        num_samples = 0
        tstep = 0
        for epoch in range(ep):
            # per-epoch accumulator like the reference (model.cc
            # reset_metrics); partials stay on the device until the
            # epoch's end, so the host does not wait on every step
            self.perf_metrics = PerfMetrics()
            device_partials = []
            chunk: List[list] = []

            def flush(chunk, first_step):
                # one dispatch for the chunk's steps; one seed per step,
                # drawn exactly as the stepwise path draws them
                t0 = time.perf_counter()
                seeds = self.executor.seed_table(
                    [step_seed(self._rng) for _ in chunk])
                self.state, partials = scan_fn(
                    self.state, [[b[i] for b in chunk]
                                 for i in range(len(xs))],
                    [b[-1] for b in chunk], seeds)
                device_partials.append(partials)
                if tel is not None:
                    tel.record_chunk(first_step=first_step, steps=len(chunk),
                                     dur_s=time.perf_counter() - t0,
                                     batch_size=bs, n_chips=1, t0=t0)

            for batch in self._batches(xs + [y], bs):
                if scan_fn is not None:
                    chunk.append(batch)
                    if len(chunk) == spd:
                        flush(chunk, tstep - spd + 1)
                        chunk = []
                else:
                    t0 = time.perf_counter()
                    self.state, partials = step_fn(self.state, batch[:-1],
                                                   batch[-1], self._rng)
                    device_partials.append(partials)
                    if tel is not None:
                        tel.record_step(step=tstep,
                                        dur_s=time.perf_counter() - t0,
                                        batch_size=bs, n_chips=1, t0=t0)
                num_samples += bs
                tstep += 1
            if chunk:  # tail chunk shorter than spd (its own graph)
                flush(chunk, tstep - len(chunk))
            folded, last_loss = _fold_partials(device_partials)
            self.perf_metrics.update(folded)
            if tel is not None:
                tel.record_epoch(epoch=epoch, loss=last_loss,
                                 steps=len(device_partials))
            obs.progress(f"epoch {epoch}: loss={last_loss:.4f} "
                         + self.perf_metrics.report(), verbose=verbose,
                         name="epoch", epoch=epoch, loss=last_loss)
        self._sync()
        elapsed = time.time() - start
        # reference: transformer.cc:208-211 throughput print
        obs.progress(f"ELAPSED TIME = {elapsed:.4f}s, "
                     f"THROUGHPUT = {num_samples / elapsed:.2f} samples/s",
                     name="fit_done", elapsed_s=elapsed, samples=num_samples)
        return self.perf_metrics

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the resilient loop ---------------------------------------------------
    def _rng_state(self) -> list:
        """The step-seed generator's state as a JSON-serializable list
        (the checkpoint cursor)."""
        return self._rng.get_state().tolist()

    def _set_rng_state(self, data) -> None:
        self._rng.set_state(torch.tensor(data, dtype=torch.uint8))

    def _save_resilient_ckpt(self, manager, step, epoch, batch_index,
                             done=False) -> str:
        """Checkpoint + the data-loader cursor: `batch_index` is the NEXT
        batch to run in `epoch`, and `rng` the generator state that
        batch's step seed will be drawn from, so a resumed run replays
        the exact step sequence."""
        return manager.save(self, step, extra_meta={"train": {
            "epoch": epoch,
            "batch_index": batch_index,
            "rng": self._rng_state(),
            "done": done,
        }})

    def _fit_resilient(self, xs, y, bs, ep, verbose, *, checkpoint_dir,
                       checkpoint_every_n_steps, keep_last_n, resume,
                       skip_nonfinite_steps, step_guard,
                       max_consecutive_skips, fault_injector,
                       preemption_signal, tel=None):
        """The JAX package's resilient stepwise loop on one device:
        periodic atomic checkpoints and mid-epoch resume, the NaN/Inf step
        guard, preemption between steps (hard, graceful, and the drain
        protocol of a deadline-bearing notice) and deterministic fault
        injection. Each step draws its seed from the model's generator as
        the plain loop does, so a run without faults equals a plain run
        bit for bit."""
        from ..runtime import resilience as rz

        step_fn = self.executor.build_train_step()
        guard_cfg = step_guard
        if guard_cfg is None and skip_nonfinite_steps:
            guard_cfg = rz.StepGuardConfig(
                max_consecutive_skips=max_consecutive_skips
            )
        self.executor.set_step_guard(guard_cfg)
        if guard_cfg is not None and self.state.guard is None:
            self.state.guard = self.executor.init_guard_state()
        elif guard_cfg is None:
            self.state.guard = None

        steps_per_epoch = xs[0].shape[0] // bs
        manager = None
        if checkpoint_dir is not None:
            manager = rz.CheckpointManager(
                checkpoint_dir, keep_last_n=keep_last_n,
                fault_injector=fault_injector,
            )
        every = checkpoint_every_n_steps or steps_per_epoch
        preempt = preemption_signal or rz.PreemptionSignal()
        # drain-protocol state: how many steps ran inside a preemption
        # notice's grace window, whether the notice came from the fault
        # injector, and the last measured checkpoint-flush duration (feeds
        # the executor's drain-window estimate)
        drain_steps = 0
        drain_simulated = False
        drain_max_steps = None
        last_ckpt_dur_s = None

        start_epoch, start_batch, global_step = 0, 0, 0
        if manager is not None and resume:
            info = manager.restore_latest(self)
            if info is not None:
                tm = (info.meta or {}).get("train", {})
                start_epoch = int(tm.get("epoch", 0))
                start_batch = int(tm.get("batch_index", 0))
                if tm.get("rng") is not None:
                    self._set_rng_state(tm["rng"])
                global_step = info.step
                if start_batch >= steps_per_epoch:
                    start_epoch += 1
                    start_batch = 0
                obs.progress(
                    f"[resilience] resumed from step {info.step} "
                    f"(epoch {start_epoch}, batch {start_batch})",
                    verbose=verbose, name="checkpoint_resume",
                    cat="checkpoint", step=info.step, epoch=start_epoch,
                    batch=start_batch,
                )

        self.perf_metrics = PerfMetrics()
        start = time.time()
        num_samples = 0
        epoch, bi = start_epoch, start_batch
        try:
            for epoch in range(start_epoch, ep):
                self.perf_metrics = PerfMetrics()
                device_partials = []
                for bi, batch in enumerate(self._batches(xs + [y], bs)):
                    if epoch == start_epoch and bi < start_batch:
                        continue
                    # -- preemption check BETWEEN steps (SIGTERM-style) --
                    if fault_injector is not None:
                        plan = fault_injector.fire("preempt", global_step)
                        if plan is not None:
                            preempt.trigger(
                                graceful=plan.get("graceful", True)
                            )
                        plan = fault_injector.fire("preemption_notice",
                                                   global_step)
                        if plan is not None:
                            # deadline-bearing drain notice: arm the
                            # signal WITH its deadline; the drain protocol
                            # below uses the grace window instead of
                            # stopping immediately
                            preempt.trigger(
                                graceful=True,
                                deadline_s=plan.get("deadline_s", 30.0),
                                leaving_slice=plan.get("slice"),
                                surviving_devices=plan.get(
                                    "surviving_devices"
                                ),
                            )
                            drain_simulated = True
                            if plan.get("max_drain_steps") is not None:
                                drain_max_steps = int(
                                    plan["max_drain_steps"]
                                )
                    if preempt.triggered() and not preempt.draining:
                        raise rz.TrainingPreempted(
                            f"preempted before step {global_step}",
                            step=global_step, graceful=preempt.graceful,
                        )
                    if preempt.draining:
                        # -- drain protocol: keep training while the
                        # remaining grace comfortably exceeds one more
                        # step + a checkpoint flush, then flush a final
                        # checkpoint and leave BEFORE the deadline lands
                        remaining = preempt.deadline_remaining()
                        window = self.executor.drain_window_s(
                            checkpoint_s=last_ckpt_dur_s
                        )
                        if drain_steps == 0:
                            obs.event(
                                "preemption_notice", cat="runtime",
                                step=global_step,
                                deadline_s=preempt.deadline_s,
                                leaving_slice=preempt.leaving_slice,
                                surviving_devices=preempt.surviving_devices,
                            )
                            obs.progress(
                                f"[resilience] preemption notice: "
                                f"{preempt.deadline_s:.1f}s grace"
                                + (f", slice {preempt.leaving_slice} "
                                   "leaving"
                                   if preempt.leaving_slice is not None
                                   else "")
                                + f"; draining (window {window:.2f}s)",
                                verbose=verbose, name="preemption_notice",
                                cat="runtime", step=global_step,
                            )
                        if remaining <= window or (
                            drain_max_steps is not None
                            and drain_steps >= drain_max_steps
                        ):
                            exc = rz.SliceDrained(
                                f"drained {drain_steps} step(s) under a "
                                f"{preempt.deadline_s:.1f}s preemption "
                                f"deadline before step {global_step}",
                                step=global_step,
                                deadline_s=preempt.deadline_s,
                                drained_steps=drain_steps,
                                leaving_slice=preempt.leaving_slice,
                                surviving_devices=preempt.surviving_devices,
                            )
                            exc.simulated = drain_simulated
                            if manager is not None:
                                exc.checkpoint_path = \
                                    self._save_resilient_ckpt(
                                        manager, global_step, epoch, bi
                                    )
                            left = preempt.deadline_remaining()
                            exc.met_deadline = (left is None or left >= 0.0)
                            self.search_trajectory.event(
                                "slice_drain", step=global_step,
                                deadline_s=preempt.deadline_s,
                                drained_steps=drain_steps,
                                met_deadline=exc.met_deadline,
                                leaving_slice=preempt.leaving_slice,
                            )
                            obs.event(
                                "slice_drain", cat="runtime",
                                step=global_step,
                                drained_steps=drain_steps,
                                met_deadline=exc.met_deadline,
                                checkpoint=exc.checkpoint_path,
                            )
                            raise exc
                        drain_steps += 1
                    t0 = time.perf_counter()
                    args = [self.state, batch[:-1], batch[-1], self._rng]
                    if guard_cfg is not None:
                        poison = 1.0
                        if fault_injector is not None and \
                                fault_injector.fire("nan_grads", global_step):
                            poison = float("nan")
                        args.append(torch.full(
                            (), poison, dtype=torch.float32,
                            device=self.executor.device))
                    self.state, partials = step_fn(*args)
                    if preempt.draining:
                        # feed the executor's step-time EMA (drain-window
                        # estimate) only from synced steps, where the wall
                        # time measures the step and not a launch
                        self._sync()
                        self.executor.note_step_duration(
                            time.perf_counter() - t0)
                    if tel is not None:
                        loss_val = None
                        if tel.config.sync_per_step:
                            loss_val = float(partials["loss"])
                        tel.record_step(
                            step=global_step,
                            dur_s=time.perf_counter() - t0,
                            batch_size=bs, n_chips=1, loss=loss_val, t0=t0,
                        )
                    device_partials.append(partials)
                    num_samples += bs
                    global_step += 1
                    if guard_cfg is not None:
                        # skip monitor: a run stuck on non-finite grads
                        # must fail loudly, not silently stop learning
                        skips = int(self.state.guard.consecutive_skips)
                        if tel is not None:
                            tel.metrics.gauge(
                                "ff_loss_scale",
                                "dynamic loss scale (step guard)",
                            ).set(float(self.state.guard.loss_scale))
                        if skips >= guard_cfg.max_consecutive_skips:
                            raise rz.NonFiniteGradientsError(
                                f"{skips} consecutive non-finite gradient "
                                f"steps (step {global_step}); loss_scale="
                                f"{float(self.state.guard.loss_scale):g}"
                            )
                    if manager is not None and global_step % every == 0:
                        _ck0 = time.perf_counter()
                        self._save_resilient_ckpt(
                            manager, global_step, epoch, bi + 1
                        )
                        last_ckpt_dur_s = time.perf_counter() - _ck0
                if device_partials:
                    folded, last_loss = _fold_partials(device_partials)
                    skipped = folded.pop("skipped", 0.0)
                    gnorm_sum = folded.pop("grad_norm", None)
                    self.perf_metrics.update(folded)
                    if tel is not None:
                        tel.record_epoch(
                            epoch=epoch, loss=last_loss,
                            grad_norm_sum=gnorm_sum,
                            steps=len(device_partials), skipped=skipped,
                        )
                    extra = (f" skipped_steps={int(skipped)}"
                             if skipped else "")
                    obs.progress(
                        f"epoch {epoch}: loss={last_loss:.4f} "
                        + self.perf_metrics.report() + extra,
                        verbose=verbose, name="epoch", epoch=epoch,
                        loss=last_loss, skipped_steps=int(skipped),
                    )
        except rz.TrainingPreempted as e:
            if manager is not None and e.graceful \
                    and e.checkpoint_path is None:
                # SIGTERM grace period: flush a final checkpoint so the
                # resumed run continues exactly where this one stopped
                # (the drain protocol already wrote SliceDrained's —
                # don't save twice)
                e.checkpoint_path = self._save_resilient_ckpt(
                    manager, global_step, epoch, bi
                )
            raise
        except rz.CollectiveTimeout as e:
            # checkpoint-and-raise: flush the last good state, then exit
            # through the typed error so the orchestrator can restart
            if manager is not None:
                e.checkpoint_path = self._save_resilient_ckpt(
                    manager, global_step, epoch, bi
                )
            raise
        self._sync()
        if manager is not None:
            self._save_resilient_ckpt(manager, global_step, ep, 0, done=True)
        elapsed = time.time() - start
        if num_samples:
            obs.progress(
                f"ELAPSED TIME = {elapsed:.4f}s, "
                f"THROUGHPUT = {num_samples / elapsed:.2f} samples/s",
                name="fit_done", elapsed_s=elapsed, samples=num_samples,
            )
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


_SHAPE_ONLY_OPS = (OperatorType.OP_RESHAPE, OperatorType.OP_FLAT,
                   OperatorType.OP_NOOP, OperatorType.OP_IDENTITY)


def _resolve_value_tail(op):
    """(op type, params) of the step that produced an output's VALUES:
    --fusion chains unpacked and shape-only steps skipped (the JAX
    package's `_resolve_value_tail`)."""
    steps = ([(s[0], s[1]) for s in op.params.chain]
             if op.op_type == OperatorType.OP_FUSED and op.params.chain
             else [(op.op_type, op.params)])
    for op_type, params in reversed(steps):
        if op_type not in _SHAPE_ONLY_OPS:
            return op_type, params
    return steps[-1]


def _probability_like_tail(op_type, params) -> bool:
    """Does this value-producing tail op emit probabilities (in [0, 1])?
    A softmax or a sigmoid, or an op with a fused sigmoid activation
    (DLRM's last dense)."""
    if op_type in (OperatorType.OP_SOFTMAX, OperatorType.OP_SIGMOID):
        return True
    return getattr(params, "activation", None) == ActiMode.AC_MODE_SIGMOID


# fit keywords whose modules are not ported yet: (the JAX package's
# module, its ROADMAP queue 1 item)
_UNPORTED_FIT_KEYWORDS = {
    "elastic": ("runtime/elastic.py (restore_elastic, shrunk_devices)",
                "item 6"),
    "health_monitor": ("runtime/elastic.py HealthMonitor", "item 6"),
    "verify_strategy": ("runtime/verify.py verify_strategy", "item 5"),
    "canary": ("runtime/verify.py CanaryConfig", "item 5"),
    "tuner": ("runtime/tuner.py StrategyTuner", "items 5-6"),
    "lint": ("analysis/ (analyze_model)", "item 4"),
    "telemetry": ("obs/telemetry.py attach_model over "
                  "analysis/{collectives,memory}.py", "items 4-5"),
}


def _refuse_unported_fit_keywords(**given) -> None:
    """Raise NotImplementedError for the first unported fit keyword that
    is set (`given` maps each keyword to whether it is)."""
    for kw, is_set in given.items():
        if is_set:
            module, item = _UNPORTED_FIT_KEYWORDS[kw]
            raise NotImplementedError(
                f"fit({kw}=...): needs the JAX package's {module}, not "
                f"ported to flexflow_tpu_torch yet (ROADMAP queue 1 "
                f"{item})")


def _fold_partials(device_partials) -> Tuple[Dict[str, float], float]:
    """An epoch's per-step (or per-chunk) partials summed on the host in
    float64, without "loss", and the last step's loss."""
    folded = {k: float(torch.cat([p[k].reshape(-1)
                                  for p in device_partials])
                       .double().sum())
              for k in device_partials[0]}
    last_loss = float(device_partials[-1]["loss"].reshape(-1)[-1])
    folded.pop("loss")
    return folded, last_loss


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
