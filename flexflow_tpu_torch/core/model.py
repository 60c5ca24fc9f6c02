"""FFModel: the user-facing model container.

The PyTorch counterpart of flexflow_tpu/core/model.py: the builder methods
of the ported ops (the ones the served LM, the flagship Transformer, the
PyTorch frontend, the CNNs and the rest of the zoo call: the shape ops,
the reductions and top_k, batch_matmul, PReLU, the MoE family with its
`moe` composite and the LSTM; an op with several outputs returns their
list), `compile` (it creates the label tensor, `get_label_tensor`;
with `config.perform_fusion` it packs op chains into fused ops,
pcg/fusion.py), `init_layers`,
`create_data_loader`, `fit` and `eval` (training; both take arrays or
data loaders), `predict` (serving) and the stepwise API
(`set_iteration_batch`, `forward`, `zero_gradients`, `backward`,
`update`) and the native Python API that feeds it (a Tensor's
`get_tensor`/`set_tensor`/`attach_numpy_array`/`inline_map`, the layer
lookups, `compute_metrics`, `get_learning_rate`/`set_learning_rate`;
`set_tensor` writes a weight in place), constant inputs
(`create_constant`, `create_constant_tensor`), dense kernel regularizers
(`dense(kernel_regularizer=)`: L1 or L2, the penalty joining the training
loss),
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
numbers -- and then lowers the winner onto the live devices, demoting
what does not fit, as the JAX package does on a smaller mesh. The live
devices are the process group's, one per process
(runtime/distributed.py; one device without a group): with a group up,
compile builds a device mesh of the strategy's axes (the manual data and
tensor degrees, or the winner's) and the mesh executor
(parallel/executor.py MeshExecutor) runs the PCG as one SPMD program
over it; every rank must feed the same global batch and reach the same
winner, and a mismatch raises. Each compile records its phases and the
search's decisions in `self.search_trajectory`. `fit` is
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
resilient loop dispatches stepwise, as the JAX package's does.
`fit(lint=...)` runs the static analyzers (analysis/) first, and
`fit(telemetry=...)` a telemetry session over the fit (obs/telemetry.py;
with `step_profile`, the step observatory's capture after the loop,
obs/step_profile.py). `compile(calibration=...)` prices the search from a
measured CalibrationStore (obs/calibration.py), and the compiled strategy
is linted (analysis/perf.py, analysis/precision.py).
`compile(artifact_store=...)` replays a stored winner instead of
searching (runtime/artifact_store.py); `--memory-search` searches for a
winner that fits `device_mem` (search/memory_optimization.py) and
`--machine-model-version 1` prices the search on the topology-aware
machine (search/network.py). `fit(verify_strategy="preflight")` checks
the compiled graph against a serial reference first, and
`fit(canary=...)` re-executes steps and checks them (runtime/verify.py).
`fit(elastic=, health_monitor=, tuner=)` resume across a topology change
and fail over onto the survivors (runtime/elastic.py), watch for hung
steps, and hot-swap the strategy (runtime/tuner.py);
`recompile_for_topology` re-plans for the live world.
"""
from __future__ import annotations

import contextlib
import operator
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..config import FFConfig
from ..ff_types import (ActiMode, AggrMode, DataType, LossType, OperatorType,
                        PoolType, RegularizerMode, to_data_type)
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
from ..parallel.executor import (MeshExecutor, PCGExecutor, TrainState,
                                 truncate_labels)
from ..parallel.mesh import full, local, shard_like
from ..runtime import distributed as rdist
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
        # the static lints' findings of the last compile and
        # compile_decode ({"compile"|"decode": {"perf_lint"|
        # "precision_lint": {errors, warnings, codes}}})
        self.lint_events: Dict[str, dict] = {}
        # the strategy store compile() reads and writes through
        # (runtime/artifact_store.py), kept for the next compile
        self.artifact_store = None

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
        # any integral groups, as JAX's feature_group_count takes it (the
        # reference's MNIST CNN passes True there, which is 1)
        p = Conv2DParams(out_channels=out_channels, kernel_h=kernel_h,
                         kernel_w=kernel_w, stride_h=stride_h,
                         stride_w=stride_w, padding_h=padding_h,
                         padding_w=padding_w, groups=operator.index(groups),
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
              kernel_regularizer=None, name: str = "") -> Tensor:
        reg_type, reg_lambda = _to_regularizer(kernel_regularizer)
        p = LinearParams(out_channels=out_dim, use_bias=use_bias,
                         activation=ActiMode(activation),
                         data_type=to_data_type(datatype),
                         kernel_reg_lambda=reg_lambda,
                         kernel_reg_type=reg_type)
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

    def transformer_blocks(self, input: Tensor, hidden_size: int,
                           num_heads: int, num_layers: int,
                           name: str = "") -> Tensor:
        """`num_layers` flagship encoder blocks (MHA + 2 dense, the
        reference's transformer.cc:33-45 block) as ONE stacked op whose
        layer dim shards over the pipe mesh axis (ops/pipeline.py): the
        JAX package's pipeline parallelism as a sharding. The stage count
        is config.pipeline_parallel_degree, the micro-batches
        config.num_microbatches."""
        from ..ops.pipeline import BlockStackParams

        p = BlockStackParams(
            hidden=hidden_size, num_heads=num_heads, num_layers=num_layers,
            num_stages=max(1, self.config.pipeline_parallel_degree),
            num_microbatches=self.config.num_microbatches)
        return self._add_layer(OperatorType.OP_BLOCK_STACK, p, [input], name)

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
    optimizer_setter = set_optimizer  # the cffi property-style spelling

    def get_label_tensor(self) -> Tensor:
        """The label tensor, which compile() creates (the reference's cffi
        `label_tensor` property)."""
        if self.label_tensor is None:
            raise RuntimeError("the label tensor exists after compile(); "
                               "call compile() first")
        return self.label_tensor

    def get_learning_rate(self) -> float:
        """The optimizer's rate, whatever it calls it (SGDOptimizer.lr,
        AdamOptimizer.alpha; reference optimizer.h:36-117)."""
        opt = self.optimizer
        return opt.alpha if hasattr(opt, "alpha") else opt.lr

    def set_learning_rate(self, lr: float) -> None:
        """Set the compiled optimizer's rate. The eager step reads it at
        each update; a captured train scan holds the rate it was captured
        with, so a change drops the captures (the JAX package drops its
        jitted step), and the next scan captures with the new rate."""
        opt = self.optimizer
        field = "alpha" if hasattr(opt, "alpha") else "lr"
        if getattr(opt, field) == lr:
            return
        setattr(opt, field, lr)
        if self.executor is not None:
            self.executor.invalidate_step_cache()

    def compile(self, optimizer=None, loss_type=None, metrics: Sequence = (),
                calibration=None, artifact_store=None):
        """Lower the layers to a PCG, choose its strategy (the Unity search
        when config.search_budget >= 0 and not only_data_parallel) and
        initialize the weights and the optimizer state on
        `config.device`. A model compiled without a loss_type serves but
        cannot train. `calibration` is a CalibrationStore or its path
        (obs/calibration.py; None: the active telemetry session's store,
        if any): its measured per-op seconds price serial views in the
        search and in every cost model the model builds, unless the store
        was measured on another machine or runtime, then it is rejected
        with a warning. The winner is linted (analysis/perf.py FFA5xx)
        and the compiled graph's precision flow annotated and audited
        (analysis/precision.py FFA7xx); findings warn, fit(lint=...)
        re-checks. `artifact_store` (runtime/artifact_store.py
        ArtifactStore; None: the store of this model's previous compile,
        else the ambient one, `with store.ambient():`) replays a stored
        winner of the same graph, device and calibration instead of
        searching, and stores a fresh winner; a corrupt or stale entry
        degrades to a fresh search.

        The device count is the live machine's: numNodes x
        workersPerNode, which must equal the world size of the process
        group (runtime/distributed.py; 1 without one). Whenever a group is
        up, the model runs on the mesh executor (parallel/executor.py
        MeshExecutor) over a mesh of the strategy's axes: the manual
        degrees (tensor_parallel_degree, the data degree filling the
        rest) or the searched winner at the degrees it was searched for.
        Every rank searches and must reach the same winner: a hash of its
        views and degrees is compared across ranks, and a mismatch
        raises."""
        from ..obs.calibration import resolve_calibration

        ndev = self._live_device_count()
        if optimizer is not None:
            self.optimizer = optimizer
        if self.optimizer is None:
            # the JAX package's default, SGD at the config's rate
            self.optimizer = SGDOptimizer(lr=self.config.learning_rate)
        self.loss_type = (to_loss_type(loss_type) if loss_type is not None
                          else None)
        self.metrics = tuple(metrics)
        # persisted cost calibration: measured per-op (fwd, bwd) seconds +
        # cost-model globals, resolved BEFORE the search so it prices ops
        # from measurement; a rejected store resolves to nothing and the
        # analytic roofline stands
        calib_table, calib_globals = resolve_calibration(calibration)
        if calib_table is not None and len(calib_table):
            self._profiled_op_costs = calib_table
        if calib_globals:
            self._calibration_globals = calib_globals
        # every compile records its phases and the search's decisions
        self.search_trajectory = SearchTrajectory()
        self.compile_phase_s = {}
        self.lint_events = {}
        t_phase = time.perf_counter()
        self.graph, self._tensor_map = self._lower_layers()
        self._phase("lowering", t_phase, ops=len(self.graph.ops))
        # the artifact cache probe (runtime/artifact_store.py): a prior
        # compile of this exact (graph, topology, calibration) key already
        # paid for the search -- replay its winner instead. Store
        # resolution: the argument > the store a previous compile of this
        # model attached > the thread's ambient store. Corrupt or stale
        # entries degrade to a fresh search; the cause rides in
        # strategy_provenance.
        from ..runtime.artifact_store import get_ambient

        store = artifact_store or self.artifact_store or get_ambient()
        self.artifact_store = store
        search_enabled = (self.config.search_budget >= 0
                          and not self.config.only_data_parallel)
        self._artifact_key = None
        cache_entry, research_cause = None, "no_store"
        if store is not None and search_enabled:
            cache_entry, research_cause = self._probe_artifact_store(
                store, ndev)
        # the user's inputs by their position among the graph's inputs:
        # a search rewrite copies the graph with fresh tensors, and the
        # positions survive the copy
        tensor_map = self._tensor_map
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
        self.search_cost_model = None
        self.measurer = None
        # --memory-search's result: {"lambda", "bytes", "cost"} of the winner
        self.memory_search = None
        # the pipe degree the search (or a replayed winner) adopted
        self.searched_pipeline_degree = 1
        t_phase = time.perf_counter()
        from ..parallel import strategies

        if cache_entry is not None:
            # artifact-cache hit: the stored winner replayed onto the fresh
            # lowering (degrees and views set, validators passed), lowered
            # onto the live devices as a searched winner is
            views, stored_axes, cost = cache_entry
            self.searched_views = views
            self.searched_cost = cost
            self.searched_axes = strategies.assign_mesh_axes(self.graph,
                                                             ndev)
            if int(stored_axes.get("pipe", 1)) > 1:
                # a pipelined winner's axes replace the lowering's, as
                # when it was searched
                self.searched_axes = dict(stored_axes)
                self.searched_pipeline_degree = int(stored_axes["pipe"])
            self.strategy_provenance = {"source": "artifact_cache",
                                        "key": dict(self._artifact_key),
                                        "cost": cost}
            self._phase("strategy_cache_hit", t_phase, devices=ndev,
                        ops=len(self.graph.ops))
            axes = self.searched_axes
        elif search_enabled:
            self._run_strategy_search(ndev)
            self.strategy_provenance = {"source": "search",
                                        "cause": research_cause}
            self._phase("strategy_search", t_phase, devices=ndev)
            axes = self.searched_axes
        else:
            # the manual lowering (the JAX package's): the tensor,
            # sequence, expert and pipeline degrees over their axes, the
            # data degree filling the devices they leave
            cfg = self.config
            tp = max(1, cfg.tensor_parallel_degree)
            sp = max(1, cfg.sequence_parallel_degree)
            ep = max(1, cfg.expert_parallel_degree)
            pp = max(1, cfg.pipeline_parallel_degree)
            if ndev % (tp * sp * ep * pp):
                raise ValueError(
                    f"tensor_parallel_degree {tp} x sequence_parallel_"
                    f"degree {sp} x expert_parallel_degree {ep} x "
                    f"pipeline_parallel_degree {pp} does not divide the "
                    f"{ndev} devices")
            dp = ndev // (tp * sp * ep * pp)
            # FSDP/ZeRO: the fsdp axis is carved out of the data workers
            # (weights shard over it, the batch over ("data", "fsdp")
            # jointly), so it must divide the data degree: clamped down
            # otherwise, with the JAX package's warning
            fsdp = max(1, cfg.fsdp_degree)
            while fsdp > 1 and (fsdp > dp or dp % fsdp != 0):
                fsdp //= 2
            if fsdp != max(1, cfg.fsdp_degree):
                warnings.warn(
                    f"fsdp_degree {cfg.fsdp_degree} does not divide "
                    f"the data-parallel degree {dp}; clamped to {fsdp}")
            strategies.apply_data_parallel(self.graph, dp, axis_idx=0)
            strategies.apply_tensor_parallel(self.graph, tp, axis_idx=1)
            strategies.apply_sequence_parallel(self.graph, sp, axis_idx=2)
            strategies.apply_expert_parallel(self.graph, ep, axis_idx=3)
            strategies.apply_pipeline_parallel(self.graph, pp, axis_idx=4)
            axes = {"data": dp // fsdp, "model": tp, "seq": sp,
                    "expert": ep, "pipe": pp}
            if fsdp > 1:
                axes["fsdp"] = fsdp
                strategies.apply_weight_sharding(self.graph, fsdp,
                                                 axis_idx=5)
            self.strategy_provenance = {"source": "manual"}
        if search_enabled:
            self._assert_same_strategy()
        self.mesh_axes = self._mesh_axes(axes)
        # slice fault domains (runtime/fault_domains.py): on a multi-node
        # machine each node is a failure domain -- recorded on the model
        # so the checkpoint sidecar, the health monitor and fit()'s
        # failure classification share one map. None on single-node
        # machines (no boundary exists) or where the machine model does
        # not describe the devices the model runs on (its ranks)
        machine = self._build_cost_model().machine
        if machine.num_nodes > 1 and machine.num_workers == ndev:
            from ..runtime.fault_domains import FaultDomainMap

            self.fault_domains = FaultDomainMap.from_machine(machine)
        else:
            self.fault_domains = None
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
        bf16_grads = self._use_bf16_grads()
        self._precision_lint(self.graph, self.search_trajectory,
                             getattr(self, "searched_views", None),
                             grad_bf16=bf16_grads, what="compiled strategy")
        t_phase = time.perf_counter()
        inputs, constants = self._graph_inputs(self.graph)
        executor_cls, where = self._executor_where(self.mesh_axes)
        self.executor = executor_cls(
            self.graph, *where, optimizer=self.optimizer,
            loss_type=self.loss_type,
            metrics=Metrics(self.loss_type, self.metrics),
            compute_dtype=torch.bfloat16 if mixed else None,
            grad_dtype=torch.bfloat16 if bf16_grads else None,
            seed=self.config.seed, input_order=inputs,
            remat=self.config.remat, constants=constants,
            overlap_grad_sync=self.config.overlap_backward_update,
            # the stage plan's cost oracle, where a pipe axis asks for one
            plan_cost_model=(self._build_cost_model()
                             if self.mesh_axes.get("pipe", 1) > 1 else None))
        self._phase("executor_build", t_phase)
        t_phase = time.perf_counter()
        self.state = self.executor.init_state()
        self._phase("init_state", t_phase)
        self.perf_metrics = PerfMetrics()
        self._rng = torch.Generator().manual_seed(self.config.seed)

    def _executor_where(self, axes: Dict[str, int]):
        """(the executor class, its placement arguments) for a strategy of
        mesh `axes`: with a process group up, one SPMD program over a mesh
        of those axes (even at world size 1); else the one device."""
        if not rdist.is_initialized():
            return PCGExecutor, (self.device,)
        from ..parallel.mesh import build_mesh

        return MeshExecutor, (build_mesh(axes, self.device.type),
                              self.device)

    def _live_device_count(self) -> int:
        """The devices this compile runs on: numNodes x workersPerNode,
        which must equal the process group's world size (one process per
        device; 1 without a group)."""
        cfg = self.config
        n = max(1, cfg.numNodes) * max(1, cfg.workersPerNode)
        if not rdist.is_initialized():
            if n != 1:
                raise NotImplementedError(
                    f"{n} devices requested in one process: the port runs "
                    f"one process per device; start {n} processes "
                    "(torchrun --nproc-per-node N, or FF_COORDINATOR_"
                    "ADDRESS/FF_NUM_PROCESSES/FF_PROCESS_ID) and call "
                    "runtime.distributed.init_distributed first "
                    "(search_num_workers searches for a bigger machine)")
            return 1
        world = rdist.process_count()
        if n != world:
            raise ValueError(
                f"numNodes x workersPerNode = {cfg.numNodes} x "
                f"{cfg.workersPerNode} = {n} devices, but the process group "
                f"has {world} processes (one per device)")
        backend = torch.distributed.get_backend()
        if (backend == "nccl") != (self.device.type == "cuda"):
            raise ValueError(
                f"the config's device {self.device} does not match the "
                f"process group's {backend} backend (NCCL drives cards, "
                "gloo the CPU; neither stands in for the other)")
        return n

    def recompile_for_topology(self, num_devices: Optional[int] = None
                               ) -> None:
        """Re-plan the compiled model for the CURRENT device topology
        (runtime/elastic.py): point the machine description at
        `num_devices` (default: the live world's, runtime/distributed.py
        `process_count`: the survivors inside `shrunk_world`), then re-run
        compile() -- which re-runs the strategy search / manual lowering
        for the new machine, rebuilds the mesh + executor and
        re-initializes state. Weights do NOT carry over; restore from a
        checkpoint afterwards (restore_elastic / fit(elastic=True)). On a
        process group every rank of the live world calls it."""
        assert self.loss_type is not None, (
            "compile() the model once before recompile_for_topology"
        )
        from ..search import (MachineModel, for_device_count,
                              parse_machine_config)

        n = num_devices if num_devices is not None else rdist.process_count()
        cfg = self.config
        # hypothetical-machine overrides would pin the search to the OLD
        # topology; the whole point here is planning for the live one
        cfg.search_num_nodes = -1
        cfg.search_num_workers = -1
        override = getattr(self, "_machine_override", None)
        if cfg.machine_model_file:
            # the file describes the machine we LOST; keep its per-chip and
            # link constants (the hardware kind didn't change) but re-point
            # the topology at the surviving device count
            base = parse_machine_config(cfg.machine_model_file)
            self._machine_override = for_device_count(n, like=base)
            cfg.machine_model_file = ""
        elif override is not None:
            # a previous elastic recompile already lifted the file into an
            # override; re-target it again for this topology change
            self._machine_override = for_device_count(n, like=override)
        m = getattr(self, "_machine_override", None) or for_device_count(
            n, like=MachineModel(num_nodes=cfg.numNodes,
                                 workers_per_node=cfg.workersPerNode))
        # one process per device: the config's nodes x workers are the
        # live world's (compile checks them against the group)
        cfg.numNodes = m.num_nodes
        cfg.workersPerNode = m.workers_per_node
        self.compile(optimizer=self.optimizer, loss_type=self.loss_type,
                     metrics=self.metrics)

    def _mesh_axes(self, axes: Dict[str, int]) -> Dict[str, int]:
        """The mesh of a strategy's axes in the strategy's own order, as
        the JAX package builds it (a ParallelDim's `parallel_idx` indexes
        that order), size-1 axes kept."""
        return {k: int(v) for k, v in axes.items()}

    def _assert_same_strategy(self, graph=None, views=None) -> None:
        """Every rank searched; they must execute one strategy. With
        measured costs each rank times its own card and two may pick
        different winners: compare a hash of the winner's op sequence,
        views and degrees across ranks with one all-gather, and raise on
        every rank on a mismatch (never train on differing strategies).
        `graph` and `views` default to the training winner's."""
        if not rdist.is_initialized() or rdist.process_count() == 1:
            return
        import hashlib

        if graph is None:
            graph, views = self.graph, self.searched_views
        pos = {op.guid: i for i, op in enumerate(graph.topo_order())}
        views = sorted(
            (pos.get(g, -1), v.start_device_id, tuple(v.dim),
             tuple(v.stride))
            for g, v in (views or {}).items())
        dims = [(op.op_type.name, tuple(
            (d.size, d.degree, d.parallel_idx, d.is_replica_dim)
            for t in op.outputs + op.weights for d in t.dims))
            for op in graph.topo_order()]
        digest = hashlib.sha256(repr((views, dims)).encode()).hexdigest()
        rdist.assert_same(
            digest, "multi-process contract violated: the ranks' searches "
            "chose different strategies (every rank must execute the SAME "
            "strategy; measured costs differ by card: pass a shared "
            "calibration or strategy)")

    def _graph_inputs(self, graph):
        """(the batch inputs in creation order, the constants {guid:
        (tensor, value)}) of a lowering of this model's layers, by their
        positions among its inputs: a search rewrite copies the graph with
        fresh tensors, and the positions survive the copy."""
        cur = graph.input_tensors()
        return ([cur[i] for i in self._input_positions],
                {cur[i].guid: (cur[i], v)
                 for i, v in self._constant_positions.items()})

    def _lower_layers(self):
        """(a fresh PCG of the layer list, layer tensor guid -> PCG tensor):
        layers_to_pcg, then apply_fusion under --fusion (reference:
        model.cc:2495; the chains' weights move under their fused ops)."""
        graph, tensor_map = layers_to_pcg(self.layers)
        if self.config.perform_fusion:
            graph = apply_fusion(graph)
        return graph, tensor_map

    def _probe_artifact_store(self, store, ndev: int):
        """Look up + replay a stored strategy for the current lowering
        (the JAX package's `_probe_artifact_store`).

        Returns `((views, mesh_axes, cost), None)` on a usable hit, else
        `(None, cause)` where cause names why a search still runs
        ("cache_miss" / "cache_corrupt"). The key holds `ndev`, the live
        device count, as the JAX package's does. The replay checks the
        stored degrees and views against the machine the search runs for
        (search_num_workers may exceed the one device; compile demotes
        the replayed winner as it demotes a searched one). A replay that
        fails partway has already mutated tensor degrees, so the stale
        path re-lowers self.graph fresh before handing it to the search.
        Store failures of any kind degrade to a fresh search -- a
        poisoned cache is never worse than no cache."""
        from ..runtime.artifact_store import (
            ArtifactCorruptionError,
            calibration_fingerprint,
            graph_fingerprint,
            make_key,
            replay_strategy,
            topology_digest,
        )
        from ..runtime.elastic import topology_fingerprint
        from ..runtime.strategy_io import StrategyImportError

        parts = {
            "graph": graph_fingerprint(self.graph),
            # the live world on a process group (every rank), else the
            # one device
            "topology": topology_digest(topology_fingerprint(
                None if rdist.is_initialized() else self.device)),
            "calibration": calibration_fingerprint(
                getattr(self, "_profiled_op_costs", None),
                getattr(self, "_calibration_globals", None),
            ),
        }
        key = make_key(objective="train", num_devices=ndev, **parts)
        self._artifact_key = key
        try:
            payload = store.get(key)
        except ArtifactCorruptionError:
            return None, "cache_corrupt"
        except Exception as e:  # a broken store must not fail the compile
            warnings.warn(
                f"artifact store lookup failed ({e!r}); falling back to "
                "a fresh search")
            return None, "cache_corrupt"
        if payload is None:
            return None, "cache_miss"
        try:
            # the rebuilt graph REPLACES the fresh lowering, exactly as a
            # search would
            graph2, views, mesh_axes, cost = replay_strategy(
                self.graph, payload,
                num_devices=self._build_cost_model().machine.num_workers)
            self.graph = graph2
            return (views, mesh_axes, cost), None
        except StrategyImportError as e:
            warnings.warn(
                f"artifact store entry could not be replayed ({e}); "
                "quarantining it and falling back to a fresh search")
            try:
                store.note_stale(key, str(e))
            except OSError as qe:
                warnings.warn(
                    f"artifact store could not quarantine the stale "
                    f"entry ({qe!r}); the fresh search proceeds anyway")
            # the failed replay mutated tensor degrees in place -- the
            # search must start from an unmutated lowering
            self.graph, self._tensor_map = self._lower_layers()
            return None, "cache_miss"

    def _artifact_store_put(self, store, payload) -> None:
        """Write the freshly searched winner's payload through to the
        artifact store under the key _probe_artifact_store computed.
        Never fails the compile -- the strategy is already in hand."""
        try:
            store.put(self._artifact_key, payload)
        except Exception as e:  # a broken store must not fail the compile
            warnings.warn(
                f"artifact store write failed ({e!r}); continuing "
                "without caching the strategy")

    def _precision_lint(self, graph, trajectory, views, *, grad_bf16: bool,
                        what: str) -> None:
        """Precision as first-class PCG state (analysis/precision.py):
        stamp compute_dtype/accum_dtype on the graph's tensors from the
        registry rules, then run the FFA7xx audit over it — warn, don't
        block (fit(lint=...) re-checks and can hard-fail) — and record
        the "precision_lint" event, as the JAX package's compile does."""
        from ..analysis.precision import (annotate_graph_precision,
                                          precision_diagnostics)

        cfg = self.config
        annotate_graph_precision(
            graph, compute_dtype=(DataType.DT_BF16
                                  if cfg.allow_mixed_precision else None))
        rep = precision_diagnostics(
            graph, views=views, num_devices=1,
            drift_budget=cfg.precision_drift_budget,
            grad_dtype=DataType.DT_BF16 if grad_bf16 else None)
        if rep.errors:
            warnings.warn(
                f"static precision analysis flagged the {what} "
                "(fit(lint=...) re-checks; FFA7xx): "
                + "; ".join(d.format() for d in rep.errors[:5]))
        self._record_lint(trajectory, "precision_lint", rep)

    def _perf_lint(self, graph, trajectory, views, cost_model, *,
                   objective: str, what: str) -> None:
        """The static perf audit of a search winner (analysis/perf.py
        FFA5xx) against the SAME oracle the search scored with, recorded
        as the "perf_lint" event; findings warn."""
        from ..analysis.perf import perf_diagnostics

        rep = perf_diagnostics(graph, views=views, cost_model=cost_model,
                               num_devices=1, objective=objective)
        if rep.errors:
            warnings.warn(
                f"static perf analysis flagged the {what} (FFA5xx): "
                + "; ".join(d.format() for d in rep.errors[:5]))
        self._record_lint(trajectory, "perf_lint", rep)

    def _record_lint(self, trajectory, kind: str, rep) -> None:
        """A lint's event in `trajectory`, and in `lint_events` (the
        trajectory is bounded, and a long search can fill it before the
        lints land): {trajectory's kind: {kind: fields}}."""
        fields = {"errors": len(rep.errors), "warnings": len(rep.warnings),
                  "codes": sorted({d.code for d in rep})}
        trajectory.event(kind, **fields)
        which = ("decode" if trajectory is self.decode_trajectory
                 else "compile")
        self.lint_events.setdefault(which, {})[kind] = fields

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
        search_num_workers of them when set (numNodes x workersPerNode
        otherwise), or recompile_for_topology's re-targeted machine. On the
        H100's chip spec the cost model applies the shipped fit of the
        card (search/cost_model.py load_default_calibration); measurements
        ride on it through the refresh seam (search/cost_model.py
        apply_calibration): per-op timings from
        explain_strategy(...).apply(model) or a CalibrationStore price
        serial views, and the store's globals override the defaults.
        (--measured-search, attached after this, supersedes the per-op
        table.) --machine-model-version 1 wraps the machine in the
        topology-aware model (search/network.py), as the JAX package
        does. `objective` is what it prices (search/cost_model.py
        CostObjective): "train" or "decode", the one-token memory-roofline
        pricing of compile_decode's search."""
        from ..search import (CostModel, apply_calibration, h100_machine,
                              parse_machine_config)

        cfg = self.config
        override = getattr(self, "_machine_override", None)
        if override is not None:
            # recompile_for_topology re-targeted a machine description at
            # the live device count (elastic resume); it wins over the
            # stale file/config topology
            machine = override
        elif cfg.machine_model_file:
            machine = parse_machine_config(cfg.machine_model_file)
        else:
            nodes = (cfg.search_num_nodes if cfg.search_num_nodes > 0
                     else cfg.numNodes)
            workers = (cfg.search_num_workers if cfg.search_num_workers > 0
                       else cfg.workersPerNode)
            machine = h100_machine(nodes, workers)
        if cfg.machine_model_version >= 1 and not hasattr(machine,
                                                          "topology"):
            # the EnhancedMachineModel analog (search/network.py): the
            # same chip and links, collectives priced by torus hops
            from ..search.network import TopologyAwareMachineModel

            machine = TopologyAwareMachineModel(
                num_nodes=machine.num_nodes,
                workers_per_node=machine.workers_per_node,
                ici_bandwidth=machine.ici_bandwidth,
                dcn_bandwidth=machine.dcn_bandwidth,
                chip=machine.chip,
            )
        pen = cfg.search_survivability_penalty
        if pen < 0:
            # auto: a bias toward node-loss-survivable strategies only
            # where nodes exist as failure domains
            pen = 0.25 if machine.num_nodes > 1 else 0.0
        cm = CostModel(machine, bf16=cfg.allow_mixed_precision,
                       overlap_backward_update=(
                           cfg.search_overlap_backward_update),
                       survivability_penalty=pen, objective=objective)
        glb = getattr(self, "_calibration_globals", None) or {}
        return apply_calibration(
            cm,
            profiled=getattr(self, "_profiled_op_costs", None),
            overlap_efficiency=glb.get("overlap_efficiency"),
            collective_bandwidths=glb.get("collective_bytes_per_s"),
        )

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
        import. The winner is linted as the JAX package lints it: the
        perf pass under objective="decode" and the precision pass, each
        recorded in `decode_trajectory` ("perf_lint", "precision_lint").
        Returns the decode executor.

        On a process group (one process per device) the search runs for
        the group's devices, as the JAX package's runs for its mesh, and
        every rank must come to the same winner (checked, as `compile`
        checks the training one); the decode executor is a MeshExecutor
        over a mesh of the winner's axes (`assign_mesh_axes`), running the
        decode step at its degrees. Without a group (or at world 1) the
        winner is demoted to the one device."""
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
        ndev = self._live_device_count()
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
        if not strategy_path:
            self._assert_same_strategy(graph, views)
        problems = run_strategy_validators(graph, views, ndev)
        if problems:
            warnings.warn(
                "decode-searched strategy failed structural validation "
                "(falling through to lowering, which demotes infeasible "
                "degrees to replicated): " + "; ".join(problems[:5]))
        self._perf_lint(graph, self.decode_trajectory, views, cost_model,
                        objective="decode",
                        what="decode-searched strategy")
        # decode serves under the same AMP dtype as training compute
        self._precision_lint(graph, self.decode_trajectory, views,
                             grad_bf16=False,
                             what="decode-searched strategy")
        if export_path:
            export_strategy(graph, SimpleNamespace(views=views, cost=cost),
                            export_path)
        # the winner's mesh axes (demoting every degree the devices cannot
        # hold)
        axes = self._mesh_axes(strategies.assign_mesh_axes(graph, ndev))
        # params stay keyed by op name, so the decode executor serves the
        # training state's weights; the batcher checks that before
        # swapping it in (runtime/serving.py)
        inputs, constants = self._graph_inputs(graph)
        t_phase = time.perf_counter()
        executor_cls, where = self._executor_where(axes)
        self.decode_executor = executor_cls(
            graph, *where, optimizer=self.optimizer,
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

    def _use_bf16_grads(self) -> bool:
        """Gradients are stored in bf16: config.bf16_grads, or mixed
        precision where that is None (the JAX package's rule)."""
        cfg = self.config
        return (cfg.allow_mixed_precision if cfg.bf16_grads is None
                else bool(cfg.bf16_grads))

    def _grad_bytes_ratio(self) -> float:
        """Gradient-buffer width relative to the master weight: 0.5 under
        bf16 gradients, else 1.0."""
        return 0.5 if self._use_bf16_grads() else 1.0

    def _search_xfers(self, machine) -> list:
        """The substitutions the search rewrites with: the generated ones
        for every power-of-two degree up to the machine's workers, then
        the declarative rules of --substitution-json (a missing file
        raises: no silent fallback to the shipped rules), else the
        shipped collections (search/substitutions/*.json)."""
        import os

        from ..search import generate_all_pcg_xfers
        from ..search.substitution_loader import (
            default_rules_path, load_rule_collection_from_path,
            rules_to_substitutions, zoo_rules_path)

        degrees = []
        d = 2
        while d <= machine.num_workers:
            degrees.append(d)
            d *= 2
        xfers = generate_all_pcg_xfers(degrees or [1], self.config)
        if self.config.substitution_json_path:
            rules = load_rule_collection_from_path(
                self.config.substitution_json_path)
            xfers = xfers + rules_to_substitutions(rules)
        else:
            for rp in (default_rules_path(), zoo_rules_path()):
                if os.path.exists(rp):
                    rules = load_rule_collection_from_path(rp)
                    xfers = xfers + rules_to_substitutions(rules)
        return xfers

    def _run_strategy_search(self, ndev: int) -> None:
        """Unity search over the lowered PCG (reference: compile's
        GRAPH_OPTIMIZE_TASK -> GraphSearchHelper::graph_optimize,
        substitution.cc:1898), then the winner's lowering onto `ndev`
        devices: every degree that does not fit is demoted to replicated
        (parallel/strategies.py assign_mesh_axes). With --memory-search
        the lambda loop (search/memory_optimization.py) searches for a
        winner that fits the memory budget (`_memory_budget`)."""
        from ..parallel import strategies
        from ..pcg.machine_view import MachineResource
        from ..search import (GraphSearchHelper, SearchHelper,
                              run_strategy_validators)

        cfg = self.config
        cost_model = self._build_cost_model()
        self.search_cost_model = cost_model
        machine = cost_model.machine
        if cfg.measure_operator_costs:
            # --measured-search: per-op device timing feeds the search
            from ..search.measure import attach_measured_mode

            self.measurer = attach_measured_mode(
                cost_model,
                compute_dtype=(torch.bfloat16
                               if cfg.allow_mixed_precision else None),
                device=self.device,
                cache_path=cfg.measured_cache_path or None)
        budget = cfg.search_budget if cfg.search_budget > 0 else 10
        xfers = self._search_xfers(machine)
        res = MachineResource(
            num_nodes=machine.num_nodes,
            all_procs_per_node=machine.workers_per_node,
            available_procs_per_node=machine.workers_per_node)
        if cfg.perform_memory_search:
            # reference: --memory-search lambda loop (graph.cc:2060-2130)
            from ..search.memory_optimization import (
                graph_optimize_with_memory)

            best_graph, result, mem, lam = graph_optimize_with_memory(
                self.graph, cost_model, res, xfers,
                device_mem_budget=self._memory_budget(machine),
                alpha=cfg.search_alpha, budget=budget,
                train=self._is_training_compile(), optimizer=self.optimizer,
                grad_bytes_ratio=self._grad_bytes_ratio(),
                trajectory=self.search_trajectory)
            self.memory_search = {"lambda": lam, "bytes": mem.max_bytes,
                                  "cost": result.cost}
        else:
            sh = SearchHelper(cost_model, trajectory=self.search_trajectory)
            gsh = GraphSearchHelper(sh, xfers, alpha=cfg.search_alpha,
                                    budget=budget,
                                    trajectory=self.search_trajectory)
            best_graph, result = gsh.graph_optimize(self.graph, res)
        self.graph = best_graph
        self.searched_views = result.views
        self.searched_cost = result.cost
        # pipeline as a searched dimension: when the winner's per-device
        # training memory overflows the budget, GPipe candidates are
        # weighed against a memory-pressured re-search, and the cheaper
        # one replaces the winner
        pipe, alt = self._search_pipeline_degree(
            cost_model, result, ndev, self._memory_budget(machine),
            res=res, xfers=xfers)
        if alt is not None:
            self.graph, result = alt
            self.searched_views = result.views
            self.searched_cost = result.cost
        self.search_trajectory.event(
            "pipeline_search", degree=pipe,
            replaced_by_researched=alt is not None, cost=result.cost)
        problems = run_strategy_validators(self.graph, self.searched_views,
                                           ndev)
        if problems:
            warnings.warn(
                "searched strategy failed structural validation (falling "
                "through to lowering, which demotes infeasible degrees to "
                "replicated): " + "; ".join(problems[:5]))
        # the winner's static perf audit: the cost model here is the SAME
        # oracle the search scored with, so an FFA501 finding is the
        # search disagreeing with itself
        self._perf_lint(self.graph, self.search_trajectory,
                        self.searched_views, cost_model, objective="train",
                        what="searched strategy")
        if cfg.export_strategy_file:
            from ..runtime.strategy_io import export_strategy

            export_strategy(self.graph, result, cfg.export_strategy_file)
        if cfg.export_strategy_computation_graph_file:
            with open(cfg.export_strategy_computation_graph_file, "w") as f:
                f.write(self.graph.export_dot())
        self.searched_op_costs = self._searched_op_costs(cost_model, result)
        payload = self._strategy_payload_for_store()
        self.searched_axes = strategies.assign_mesh_axes(self.graph, ndev)
        if pipe > 1:
            # the pipeline candidate is a stage split with data
            # parallelism within each stage: it REPLACES the overflowing
            # winner's axes (as in the JAX package)
            self.searched_axes = {"data": max(1, ndev // pipe), "pipe": pipe}
            self.searched_pipeline_degree = pipe
        if payload is not None:
            payload["mesh_axes"] = dict(self.searched_axes)
            self._artifact_store_put(self.artifact_store, payload)

    def _strategy_payload_for_store(self) -> Optional[dict]:
        """The searched winner as an artifact-store payload
        (runtime/artifact_store.py strategy_payload), taken before the
        winner is demoted to the one device, so a replay demotes it as
        the search's is; None when no store waits for it or the graph is
        not serializable (warned: the write is best effort). The graph's
        precision is annotated first, as the JAX package's payload
        carries it."""
        if self.artifact_store is None or self._artifact_key is None:
            return None
        from ..analysis.precision import annotate_graph_precision
        from ..runtime.artifact_store import strategy_payload

        annotate_graph_precision(
            self.graph, compute_dtype=(DataType.DT_BF16
                                       if self.config.allow_mixed_precision
                                       else None))
        try:
            return strategy_payload(
                self.graph, self.searched_views, cost=self.searched_cost,
                mesh_axes={}, provenance={"writer": "compile"})
        except ValueError as e:
            warnings.warn(f"artifact store payload not written ({e}); "
                          "continuing without caching the strategy")
            return None

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

    def _memory_budget(self, machine) -> int:
        """Per-device bytes a strategy may use: config.device_mem, else
        the machine's chip capacity (the JAX package's mem_budget)."""
        return self.config.device_mem or machine.chip.hbm_capacity

    def _search_pipeline_degree(self, cost_model, result, ndev: int,
                                mem_budget: int, res=None, xfers=None):
        """The JAX package's `_search_pipeline_degree`: when the searched
        strategy does not fit a device under TRAINING memory accounting
        (weights, gradients, optimizer slots and activations), price
        GPipe candidates of S stages over the `ndev` live devices (dp =
        ndev / S within each stage, M micro-batches):

            T(S) ~ max_stage_time / dp * (M + S - 1) / M
                   + cut_bytes * 2 / ici_bandwidth / dp

        the bubble plus the forward and backward cut transfers, with per
        device memory the stage's weights (times the gradient and slot
        multiplier) plus its activations for all M micro-batches, and
        weigh them against the fitting unpipelined strategy a
        memory-pressured re-search finds, decided on cost.

        Returns (degree, alt): degree 1 when the winner fits (or fewer
        than 2 devices run); alt, when not None, is a fitting unpipelined
        (graph, result) that beats every pipeline candidate. The
        winner's memory is recorded as a "memory_check" event first."""
        from ..search.memory_optimization import (measure_memory,
                                                  weight_bytes_multiplier)
        from ..parallel.pipeline import balanced_linear_partition
        from ..pcg.machine_view import MachineView

        cfg = self.config
        train = self._is_training_compile()
        gratio = self._grad_bytes_ratio()
        mem = measure_memory(
            self.graph, result.views, cost_model, train=train,
            optimizer=self.optimizer, grad_bytes_ratio=gratio).max_bytes
        self.search_trajectory.event("memory_check", bytes=mem,
                                     budget=mem_budget)
        if ndev < 2 or mem <= mem_budget:
            return 1, None
        wmul = (weight_bytes_multiplier(
            self.optimizer, gratio,
            warn=any(op.weights for op in self.graph.ops))
            if train else 1.0)
        ops = [o for o in self.graph.ops if not o.is_parallel_op]
        order = {o.guid: i for i, o in enumerate(self.graph.topo_order())}
        ops.sort(key=lambda o: order[o.guid])
        v1 = MachineView(start_device_id=0, dim=(1,), stride=(1,))
        costs = [cost_model.measure_operator_cost(o, v1).total_time
                 for o in ops]
        w_bytes = [sum(t.get_volume() * t.data_type.size for t in o.weights)
                   for o in ops]
        a_bytes = [sum(t.get_volume() * t.data_type.size for t in o.outputs)
                   for o in ops]
        best_s, best_t = 1, float("inf")
        S = 2
        while S <= ndev and len(ops) >= S:
            if ndev % S == 0:
                dp = ndev // S
                M = max(cfg.num_microbatches, S)
                bounds = balanced_linear_partition(costs, S)
                stage_t = [sum(costs[bounds[i]:bounds[i + 1]])
                           for i in range(S)]
                stage_w = [sum(w_bytes[bounds[i]:bounds[i + 1]])
                           for i in range(S)]
                stage_a = [sum(a_bytes[bounds[i]:bounds[i + 1]])
                           for i in range(S)]
                cut_bytes = sum(a_bytes[bounds[i + 1] - 1]
                                for i in range(S - 1))
                t = (max(stage_t) / dp * (M + S - 1) / M
                     + cut_bytes * 2 / cost_model.machine.ici_bandwidth / dp)
                # stage weights replicate within the stage's dp group and
                # carry gradients and slots (wmul); the schedule keeps
                # every micro-batch's residuals for the backward: the
                # stage's whole batch shard of activations
                m_per_chip = max(w * wmul + a / dp
                                 for w, a in zip(stage_w, stage_a))
                if m_per_chip <= mem_budget and t < best_t:
                    best_s, best_t = S, t
            S *= 2
        if res is not None and xfers is not None \
                and not cfg.perform_memory_search:
            # the overflowing strategy was the cost winner: let the lambda
            # loop look for a fitting unpipelined one (parameter-parallel
            # sharding dividing the weight, gradient and slot bytes), and
            # adopt it when it fits and beats the pipeline estimate (or no
            # pipeline fits). Under --memory-search that loop already ran
            # and found nothing that fits.
            from ..search.memory_optimization import \
                graph_optimize_with_memory

            budget = cfg.search_budget if cfg.search_budget > 0 else 10
            g2, r2, mem2, _lam = graph_optimize_with_memory(
                self.graph, cost_model, res, xfers,
                device_mem_budget=mem_budget, alpha=cfg.search_alpha,
                budget=budget, train=train, optimizer=self.optimizer,
                grad_bytes_ratio=gratio, trajectory=self.search_trajectory)
            if mem2.max_bytes <= mem_budget and r2.cost < best_t:
                return 1, (g2, r2)
        if best_s == 1:
            warnings.warn(
                f"per-chip training memory {mem / 2 ** 20:.0f} MB exceeds "
                f"the {mem_budget / 2 ** 20:.0f} MB budget and no pipeline "
                "stage count or re-searched strategy fits; keeping the "
                "fastest (overflowing) strategy")
        return best_s, None

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
        `step_guard`, `fault_injector`, `preemption_signal` or `canary`
        runs the resilient loop (`_fit_resilient`, stepwise).

        `lint="warn"|"error"` runs the static analyzers over the compiled
        model (analysis.analyze_model) before any device time is spent:
        "error" raises StaticAnalysisError on an ERROR finding, "warn"
        warns. `telemetry=obs.TelemetryConfig(dir)` runs one telemetry
        session over the fit (the compile trajectory replayed, per-step
        events, metrics, with `step_profile` the step observatory's
        capture after the loop) and flushes it at the end; without it an
        active session is fed. An out-of-memory step under a session
        leaves ``oom_forensics.json`` in its directory. With
        config.profiling each op's forward and backward are timed on the
        first batch and printed.
        `verify_strategy="preflight"` runs the differential verifier
        (runtime/verify.py verify_strategy: 2 steps of the compiled graph
        against a serial reference, on copies) before training and raises
        StrategyDivergenceError naming the first diverging op.
        `canary=CanaryConfig(...)` runs the resilient loop with the
        SDC/determinism canary and the per-step invariants
        (`_canary_check`). `elastic=True` resumes across a topology
        change (runtime/elastic.py: a stale mesh re-searched and
        recompiled at entry, the checkpoint restored by name) and fails
        over in-process from a simulated slice loss or a drained slice
        onto the survivors (at most 3 times); `health_monitor=
        HealthMonitor(...)` runs the watchdog over every step (each step
        synchronised) and turns a hang into CollectiveTimeout after a
        checkpoint; `tuner=TunerConfig(...)` arms the strategy tuner
        (runtime/tuner.py StrategyTuner: background re-search and a
        transactional hot swap at a step boundary). Any of the three runs
        the resilient loop."""
        from ..runtime.verify import NotCompiledError

        if self.executor is None:
            raise NotCompiledError("fit: call compile() first")
        if lint not in (None, "off", "warn", "error"):
            raise ValueError(
                'fit(lint=...) accepts "error", "warn", or "off" '
                f"(got {lint!r})"
            )
        # -- telemetry session (obs/): fit(telemetry=TelemetryConfig(...))
        # runs one session end to end and flushes events.jsonl /
        # metrics.prom / trace.json on exit; a session the caller already
        # opened (obs.session(...)) is fed without being finished here
        own_session = False
        if telemetry is not None:
            if not isinstance(telemetry, obs.TelemetryConfig):
                raise ValueError(
                    "fit(telemetry=...) takes an obs.TelemetryConfig "
                    f"(got {telemetry!r})")
            tel = obs.start(telemetry)
            own_session = True
        else:
            tel = obs.active()
        if tel is not None:
            tel.attach_model(self)
        try:
            return self._fit_impl(
                x, y, batch_size, epochs, verbose, lint=lint, tel=tel,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every_n_steps=checkpoint_every_n_steps,
                keep_last_n=keep_last_n, resume=resume,
                skip_nonfinite_steps=skip_nonfinite_steps,
                step_guard=step_guard,
                max_consecutive_skips=max_consecutive_skips,
                fault_injector=fault_injector,
                preemption_signal=preemption_signal,
                verify_strategy=verify_strategy, canary=canary,
                elastic=elastic, health_monitor=health_monitor, tuner=tuner)
        except Exception as e:
            # OOM forensics (obs/step_profile.py): the static memory
            # prediction, the allocator's stats and the top allocations
            # stay behind, so the post-mortem answers "what ate the
            # memory" offline
            if tel is not None and isinstance(e, torch.cuda.OutOfMemoryError):
                from ..obs.step_profile import dump_oom_forensics

                try:
                    path = dump_oom_forensics(self, tel.config.dir,
                                              error=str(e))
                    obs.event("oom_forensics", cat="obs", path=path)
                except Exception as dump_err:  # forensics must not mask the OOM
                    warnings.warn(f"oom forensics dump failed: {dump_err}")
            # flight recorder (obs/flight_recorder.py): typed failures
            # (non-finite grads, strategy divergence, KV exhaustion, slice
            # loss, ...) dump the recent event and metric tail plus the
            # live-state providers; a no-op for untyped exceptions or
            # without an armed recorder
            obs.record_failure(e, where="fit")
            raise
        finally:
            if own_session:
                obs.finish()

    def _assert_same_global_batch(self, xs, y, bs: int) -> None:
        """The multi-process contract (the JAX package's): every process
        feeds the SAME global batch. A diverging feed would silently
        corrupt training (each rank keeps its shard of what it believes is
        the global batch) and an uneven batch count would hang a
        collective: a cheap signature (dataset size, batch size, the first
        batch's sums) is compared across ranks with one all-gather, and a
        mismatch raises on every rank."""
        if not rdist.is_initialized() or rdist.process_count() == 1:
            return
        first = next(self._batches(list(xs) + [y], bs), [])
        sig = [float(bs), float(np.shape(xs[0])[0])]
        for a in first:
            arr = np.asarray(a)
            head = arr.reshape(-1)[:4096]
            sig += [float(np.sum(arr.astype(np.float64))),
                    float(np.sum(np.abs(head.astype(np.float64))))]
        rdist.assert_same(
            sig, "multi-process contract violated: every process must feed "
            "the SAME global batch and dataset (runtime/distributed.py) — "
            "rank data/batch signatures differ")

    def _fit_impl(self, x, y, batch_size, epochs, verbose, *, lint, tel,
                  checkpoint_dir, checkpoint_every_n_steps, keep_last_n,
                  resume, skip_nonfinite_steps, step_guard,
                  max_consecutive_skips, fault_injector, preemption_signal,
                  verify_strategy, canary, elastic=False,
                  health_monitor=None, tuner=None):
        if lint in ("warn", "error"):
            # static preflight (analysis/): shape/sharding inference,
            # collective consistency, precision flow, memory fit and the
            # perf lints over the compiled PCG — rejects a broken
            # strategy before ANY device time is spent
            from ..analysis import StaticAnalysisError, analyze_model

            report = analyze_model(self)
            if not report.ok:
                if lint == "error":
                    raise StaticAnalysisError(report)
                warnings.warn("static analysis found problems "
                              "(fit(lint='warn')):\n" + report.summary())
            elif verbose and len(report):
                obs.progress(f"[analysis] {report!r}", name="analysis",
                             cat="compile")
        x, y = _unwrap_loaders(x, y)
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        bs = batch_size or self.config.batch_size
        ep = epochs or self.config.epochs
        n = xs[0].shape[0]
        self._assert_same_global_batch(xs, y, bs)
        if n < bs:
            raise ValueError(
                f"dataset has {n} samples < batch_size {bs}; nothing to train on")
        if n % bs != 0:
            obs.progress(
                f"[flexflow_tpu_torch] warning: dropping {n % bs} tail "
                f"samples (dataset {n} % batch {bs})",
                name="tail_samples_dropped", dropped=n % bs)
        tel = obs.active()
        if verify_strategy:
            # differential preflight (runtime/verify.py): 2 steps of the
            # compiled graph vs a serial reference from identical weights
            # and seeds; divergence raises StrategyDivergenceError naming
            # the first diverging op BEFORE any training is spent on it
            from ..runtime import verify as vfy

            if verify_strategy not in (True, "preflight"):
                raise ValueError(
                    "fit(verify_strategy=...) accepts 'preflight' "
                    f"(got {verify_strategy!r})")
            verdict = vfy.verify_strategy(
                self, (xs, y), steps=2, batch_size=bs,
                raise_on_divergence=True)
            obs.progress(
                "[verify] preflight: " + verdict.summary().split("\n")[0],
                verbose=verbose, name="verify_preflight", cat="runtime",
                ok=verdict.ok)
        if (checkpoint_dir is not None or skip_nonfinite_steps
                or step_guard is not None or fault_injector is not None
                or preemption_signal is not None or canary is not None
                or elastic or health_monitor is not None
                or tuner is not None):
            return self._fit_failover(
                xs, y, bs, ep, verbose, checkpoint_dir=checkpoint_dir,
                checkpoint_every_n_steps=checkpoint_every_n_steps,
                keep_last_n=keep_last_n, resume=resume,
                skip_nonfinite_steps=skip_nonfinite_steps,
                step_guard=step_guard,
                max_consecutive_skips=max_consecutive_skips,
                fault_injector=fault_injector,
                preemption_signal=preemption_signal, canary=canary, tel=tel,
                elastic=elastic, health_monitor=health_monitor, tuner=tuner)
        # guard residue from a previous resilient fit would change the
        # step; drop it for the fast unguarded paths
        self.executor.set_step_guard(None)
        self.state.guard = None
        step_fn = self.executor.build_train_step()
        if self.config.profiling:
            self._print_op_profile(xs, y, bs)
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
                                     batch_size=bs,
                                     n_chips=rdist.process_count(), t0=t0)

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
                        loss_val = None
                        if tel.config.sync_per_step:
                            loss_val = float(partials["loss"])
                        tel.record_step(step=tstep,
                                        dur_s=time.perf_counter() - t0,
                                        batch_size=bs,
                                        n_chips=rdist.process_count(),
                                        loss=loss_val, t0=t0)
                num_samples += bs
                tstep += 1
            if chunk:  # tail chunk shorter than spd (its own graph)
                flush(chunk, tstep - len(chunk))
            folded, last_loss = _fold_partials(device_partials)
            gnorm_sum = folded.pop("grad_norm", None)
            self.perf_metrics.update(folded)
            if tel is not None:
                tel.record_epoch(epoch=epoch, loss=last_loss,
                                 grad_norm_sum=gnorm_sum,
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
        if tel is not None and getattr(tel.config, "step_profile", False):
            self._capture_step_profile(tel, xs, y, bs)
        return self.perf_metrics

    def _capture_step_profile(self, tel, xs, y, bs) -> None:
        """The in-situ step observatory (obs/step_profile.py) after the
        loop — the step is warm, the batch shapes live — into the
        session. Observability never fails training: a failed capture
        warns and records a "step_profile_failed" event."""
        from ..obs.step_profile import capture_into_session

        try:
            capture_into_session(self, tel, xs, y, bs)
        except Exception as e:  # observability must not fail training
            warnings.warn(f"step-profile capture failed: {e}")
            obs.event("step_profile_failed", cat="obs", error=str(e)[:500])

    def _print_op_profile(self, xs, y, bs) -> None:
        """--profiling: each op's forward and backward on the first batch
        (runtime/profiler.py profile_ops; reference: per-op event timing,
        kernels/linear_kernels.cu:94-117), slowest first."""
        from ..runtime.profiler import profile_ops

        first = next(self._batches(list(xs) + [y], bs))
        cast = [np.asarray(a, pt.data_type.np_dtype)
                for pt, a in zip(self.executor.input_pts, first[:-1])]
        profs = profile_ops(self, cast, backward=True)
        for op_name, p in sorted(profs.items(),
                                 key=lambda kv: -kv[1].total_s):
            obs.progress(
                f"[profiling] {op_name}: {p.forward_s * 1e3:.3f} ms fwd"
                f" + {p.backward_s * 1e3:.3f} ms bwd",
                name="op_profile", cat="runtime", op=op_name,
                forward_s=p.forward_s, backward_s=p.backward_s)

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

    def _canary_check(self, vfy, canary, prev_state, kept, rng_before,
                      args, step_fn, partials, fault_injector, manager,
                      global_step, epoch, bi, pnorm_fn, prev_pnorm,
                      prev_loss):
        """SDC/determinism canary + per-step invariants (the JAX
        package's `_canary_check`; runtime/verify.py CanaryConfig). At the
        canary cadence the step is re-executed on the SAME inputs and
        seed (`args`) from the SAME pre-step state (`kept`, the executor's
        snapshot, written back in place) and the two results compared;
        the model is then left where the FIRST execution left it. The
        per-step invariants bound param-norm drift and loss deltas. Any
        violation reverts to the pre-step state (and the seed generator to
        its pre-step state), flushes it as a checkpoint (the state AFTER
        the step is untrusted) and raises. Returns the updated
        (prev_pnorm, prev_loss) trackers."""
        ex = self.executor

        def escalate(exc):
            obs.event("canary_violation", cat="runtime", step=global_step,
                      error=type(exc).__name__, detail=str(exc)[:500])
            obs.count("ff_canary_violations_total",
                      help="canary / invariant violations")
            ex.restore_state(self.state, kept)
            self.state = prev_state
            self._rng.set_state(rng_before)
            if manager is not None:
                exc.checkpoint_path = self._save_resilient_ckpt(
                    manager, global_step, epoch, bi)
            raise exc

        if canary.every_n_steps > 0 \
                and global_step % canary.every_n_steps == 0:
            if fault_injector is not None:
                # SDC simulation: flip one bit in one weight of the FIRST
                # execution's result, as a faulty core would have
                # (target=None leaves disk-targeted plans to
                # CheckpointManager.save)
                plan = fault_injector.fire("bitflip", global_step,
                                           target=None)
                if plan is not None:
                    # on a mesh, in this rank's shard alone
                    flipped, name = vfy.bitflip_params(
                        _local_tree(self.state.params), op=plan.get("op"),
                        weight=plan.get("weight"),
                        bit=plan.get("bit", 6),
                        index=plan.get("index", 3))
                    opn, wn = name.rsplit("/", 1)
                    with torch.no_grad():
                        local(self.state.params[opn][wn]).copy_(
                            flipped[opn][wn])
            obs.count("ff_canary_checks_total",
                      help="canary step re-executions")
            first = ex.snapshot_state(self.state)
            first_params = _params_of_snapshot(self.state.params, first)
            ex.restore_state(self.state, kept)
            state2, partials2 = step_fn(*args)
            # each rank compares its own shards; a mismatch on any rank is
            # every rank's
            bad = vfy.compare_step_results(
                {"params": first_params, "loss": partials["loss"]},
                {"params": _local_tree(state2.params),
                 "loss": partials2["loss"]},
                mode=canary.mode, rtol=canary.rtol, atol=canary.atol)
            if rdist.any_rank(bool(bad)):
                bad = bad or [f"rank {rdist.process_index()} agreed; another "
                              "rank's re-execution disagreed"]
                escalate(vfy.CanaryMismatchError(
                    f"step {global_step}: canary re-execution disagrees "
                    f"({canary.mode} mode) — non-deterministic step or "
                    "silent data corruption: " + "; ".join(bad),
                    step=global_step, mismatches=bad))
            ex.restore_state(self.state, first)
        if pnorm_fn is not None:
            loss = float(partials["loss"].reshape(-1)[-1])
            if not np.isfinite(loss) and ex.step_guard is None:
                escalate(vfy.InvariantViolationError(
                    f"step {global_step}: non-finite loss {loss} (enable "
                    "skip_nonfinite_steps for skip-and-rescale instead)",
                    step=global_step, invariant="finite_loss"))
            if (canary.max_loss_delta is not None and prev_loss is not None
                    and abs(loss - prev_loss) > canary.max_loss_delta):
                escalate(vfy.InvariantViolationError(
                    f"step {global_step}: loss moved "
                    f"{abs(loss - prev_loss):.3g} in one step "
                    f"(bound {canary.max_loss_delta:g})",
                    step=global_step, invariant="loss_delta"))
            pn = float(pnorm_fn(self.state.params))
            if not np.isfinite(pn) or (
                    prev_pnorm is not None and prev_pnorm > 0
                    and pn > prev_pnorm * canary.max_param_norm_ratio):
                escalate(vfy.InvariantViolationError(
                    f"step {global_step}: global param norm {pn:.3g} "
                    f"drifted past {canary.max_param_norm_ratio:g}x the "
                    f"previous step's ({prev_pnorm})",
                    step=global_step, invariant="param_norm_drift"))
            return pn, loss
        return prev_pnorm, prev_loss

    def _fit_failover(self, xs, y, bs, ep, verbose, *, preemption_signal,
                      elastic, checkpoint_dir, resume, **kw):
        """The resilient loop under slice-granular failover (the JAX
        package's loop around `_fit_resilient`): a SIMULATED whole-slice
        loss or drained preemption carries the surviving device count,
        so an elastic fit shrinks the live world in-process
        (runtime/distributed.py `shrunk_world`: every rank enters, the
        survivors go on in a group of their own), re-searches for them
        and resumes from the checkpoint the handler just flushed. A rank
        left out of the survivors is a lost device: it re-raises. Real
        (non-simulated) losses, a fit without a checkpoint directory and
        a fourth failover re-raise for the orchestrator, whose restart
        lands in restore_elastic."""
        from ..runtime import resilience as rz

        failover_stack = contextlib.ExitStack()
        failovers = 0
        try:
            while True:
                try:
                    return self._fit_resilient(
                        xs, y, bs, ep, verbose,
                        preemption_signal=preemption_signal,
                        elastic=elastic, checkpoint_dir=checkpoint_dir,
                        resume=resume, **kw)
                except (rz.SliceLossError, rz.SliceDrained) as e:
                    surv = getattr(e, "surviving_devices", None)
                    if (not elastic or checkpoint_dir is None
                            or surv is None
                            or not getattr(e, "simulated", False)
                            or failovers >= 3):
                        raise
                    failovers += 1
                    # even a HANDLED slice loss leaves a forensics bundle:
                    # the post-incident review wants the pre-failover tail
                    obs.record_failure(e, where="slice_failover",
                                       surviving_devices=surv,
                                       attempt=failovers)
                    obs.event("slice_failover", cat="runtime", step=e.step,
                              kind=type(e).__name__,
                              surviving_devices=surv, attempt=failovers)
                    obs.count("ff_slice_failovers_total",
                              help="in-process shrink-onto-survivors "
                                   "failovers (fit elastic=True)")
                    obs.progress(
                        f"[elastic] {type(e).__name__} at step {e.step}: "
                        f"shrinking onto {surv} device(s), re-searching and "
                        "resuming from "
                        f"{e.checkpoint_path or 'last checkpoint'}",
                        verbose=verbose, name="slice_failover",
                        cat="runtime", step=e.step, surviving_devices=surv)
                    if surv < rdist.process_count():
                        if not failover_stack.enter_context(
                                rdist.shrunk_world(surv)):
                            # this rank's device is among the lost
                            raise
                    if preemption_signal is not None:
                        preemption_signal.clear()
                    # the drain checkpoint is the resume point; re-entry
                    # sees mesh_is_live() False -> recompile_for_topology
                    # + checkpoint restore
                    resume = True
        finally:
            failover_stack.close()

    def _fit_resilient(self, xs, y, bs, ep, verbose, *, checkpoint_dir,
                       checkpoint_every_n_steps, keep_last_n, resume,
                       skip_nonfinite_steps, step_guard,
                       max_consecutive_skips, fault_injector,
                       preemption_signal, canary=None, tel=None,
                       elastic=False, health_monitor=None, tuner=None):
        """The JAX package's resilient stepwise loop, on one device or a
        mesh (every stop, skip count, canary verdict, fault and hang
        agreed across the ranks): periodic atomic checkpoints and
        mid-epoch resume, the NaN/Inf step guard, preemption between
        steps (hard, graceful, and the drain protocol of a
        deadline-bearing notice), deterministic fault injection (the
        ``slice_loss``, ``host_loss`` and ``hung_step`` sites among
        them), the SDC/determinism canary (`_canary_check`), the elastic
        recompile and resume, the health watchdog and the strategy tuner.
        Each step draws its seed from the model's generator as the plain
        loop does, so a run without faults equals a plain run bit for
        bit, canaried, monitored or not."""
        from ..core.seeds import step_seed
        from ..parallel.executor import global_grad_norm
        from ..runtime import resilience as rz
        from ..runtime import verify as vfy

        if elastic and not self.executor.mesh_is_live():
            # devices disappeared since compile(): any dispatch onto the
            # stale mesh would wait forever for the lost ranks. Re-search
            # the strategy for the surviving world and recompile; the
            # checkpoint restore below reshards the weights onto it.
            n = rdist.process_count()
            obs.progress(
                f"[elastic] device topology changed; re-searching "
                f"strategy for {n} device(s) and recompiling",
                verbose=verbose, name="elastic_recompile", cat="runtime",
                devices=n)
            self.recompile_for_topology(n)
            if tel is not None:
                # the recompile minted a fresh trajectory/executor --
                # replay the re-search into the event log too
                tel._attached_models = [
                    m for m in tel._attached_models if m is not self]
                tel.attach_model(self)
        # refuses a model compiled without a loss before anything is made
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
        # the canary's per-step invariants: the global param norm and the
        # loss of the previous step
        pnorm_fn = (global_grad_norm
                    if canary is not None and canary.check_invariants
                    else None)
        prev_pnorm = prev_loss = None
        # drain-protocol state: how many steps ran inside a preemption
        # notice's grace window, whether the notice came from the fault
        # injector, and the last measured checkpoint-flush duration (feeds
        # the executor's drain-window estimate)
        drain_steps = 0
        drain_simulated = False
        drain_max_steps = None
        last_ckpt_dur_s = None
        mon = health_monitor
        own_monitor = mon is not None and not mon.running
        if mon is not None:
            if getattr(mon, "fault_domains", None) is None:
                # share compile()'s fault-domain map so peer staleness
                # classifies per slice (host loss vs whole-slice loss)
                mon.fault_domains = getattr(self, "fault_domains", None)
            mon.start()
        # -- the strategy tuner (runtime/tuner.py): it observes the synced
        # step durations below and acts between steps; when it swaps
        # (commit or rollback) the live executor changes and the step
        # function is rebuilt after the boundary hook
        tuner_obj = None
        if tuner is not None:
            from ..runtime.tuner import StrategyTuner, TunerConfig

            tuner_obj = (tuner if isinstance(tuner, StrategyTuner)
                         else StrategyTuner(
                             self, tuner if isinstance(tuner, TunerConfig)
                             else TunerConfig(),
                             fault_injector=fault_injector))
            # persisted quarantines (runtime/artifact_store.py): a
            # candidate rolled back by a previous process is never
            # re-proposed; committed winners write through for reuse
            tuner_obj.attach_artifact_store(
                getattr(self, "artifact_store", None))
            self._tuner = tuner_obj

        start_epoch, start_batch, global_step = 0, 0, 0
        if manager is not None and resume:
            info = manager.restore_latest(self, elastic=elastic)
            if info is not None and elastic:
                from ..runtime.elastic import model_topology, topology_matches

                saved_topo = (info.meta or {}).get("topology")
                live_topo = model_topology(self)
                if not topology_matches(saved_topo, live_topo):
                    obs.progress(
                        f"[elastic] resumed step {info.step} across a "
                        f"topology change "
                        f"({(saved_topo or {}).get('num_devices', '?')} -> "
                        f"{live_topo['num_devices']} devices); strategy "
                        "re-searched and parameters resharded",
                        verbose=verbose, name="elastic_resume",
                        cat="runtime", step=info.step,
                        saved_devices=(saved_topo or {}).get("num_devices"),
                        live_devices=live_topo["num_devices"])
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
                    slice_plan = host_plan = None
                    if fault_injector is not None:
                        slice_plan = fault_injector.fire("slice_loss",
                                                         global_step)
                        host_plan = fault_injector.fire("host_loss",
                                                        global_step)
                        if mon is not None and fault_injector.fire(
                                "hung_step", global_step):
                            # simulated dead collective: blocks until the
                            # watchdog detects the stall and releases us
                            mon.simulate_hang()
                    # on a process group every rank stops, loses a slice
                    # or hangs where any does (a graceful stop only where
                    # every signal was)
                    stop = preempt.triggered() and not preempt.draining
                    (stop, hard, draining, slice_lost, host_lost,
                     hung) = rdist.any_ranks(
                        [stop, stop and not preempt.graceful,
                         preempt.draining, slice_plan is not None,
                         host_plan is not None,
                         mon is not None and mon.hang_detected])
                    if stop:
                        raise rz.TrainingPreempted(
                            f"preempted before step {global_step}",
                            step=global_step, graceful=not hard,
                        )
                    if draining:
                        # -- drain protocol: keep training while the
                        # remaining grace comfortably exceeds one more
                        # step + a checkpoint flush, then flush a final
                        # checkpoint and leave BEFORE the deadline lands
                        remaining = preempt.deadline_remaining()
                        window = self.executor.drain_window_s(
                            checkpoint_s=last_ckpt_dur_s
                        )
                        if drain_steps == 0 and preempt.draining:
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
                        if rdist.any_rank(preempt.draining and (
                            remaining <= window or (
                                drain_max_steps is not None
                                and drain_steps >= drain_max_steps))):
                            exc = rz.SliceDrained(
                                f"drained {drain_steps} step(s) under a "
                                f"{preempt.deadline_s or 0.0:.1f}s preemption "
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
                    if slice_lost:
                        # an entire fault domain vanished at once -- the
                        # slice-granular analog of host_loss. The
                        # TrainingPreempted handler below flushes the
                        # final checkpoint; fit(elastic=True) then
                        # shrinks onto the survivors and resumes.
                        plan = _agreed_plan(slice_plan)
                        lost = plan.get("slice")
                        surv = plan.get("surviving_devices")
                        if surv is None and lost is not None and \
                                getattr(self, "fault_domains", None):
                            surv = len(self.fault_domains
                                       .surviving_devices([lost]))
                        err = rz.SliceLossError(
                            f"slice {lost} lost before step {global_step}",
                            step=global_step,
                            graceful=plan.get("graceful", True),
                            lost_slice=lost, surviving_devices=surv)
                        err.simulated = True
                        self.search_trajectory.event(
                            "slice_lost", step=global_step, slice=lost,
                            surviving_devices=surv)
                        obs.event("slice_lost", cat="runtime",
                                  step=global_step, slice=lost,
                                  surviving_devices=surv)
                        obs.count("ff_slice_losses_total",
                                  help="whole-slice losses (real + injected)")
                        if lost is not None:
                            obs.gauge_set(
                                "ff_slice_healthy", 0.0,
                                help="1 while a fault domain's hosts all "
                                     "heartbeat, 0 once lost", slice=lost)
                        raise err
                    if host_lost:
                        # a host dropped out: flush-and-exit (the
                        # TrainingPreempted handler below writes the final
                        # checkpoint) so the orchestrator can restart
                        # elastically on the survivors
                        plan = _agreed_plan(host_plan)
                        raise rz.HostLossError(
                            f"host lost before step {global_step}",
                            step=global_step,
                            graceful=plan.get("graceful", True),
                            surviving_devices=plan.get("surviving_devices"))
                    if mon is not None:
                        if hung:
                            info = _agreed_plan(mon.hang_info
                                                if mon.hang_detected
                                                else None)
                            if info.get("kind") == "slice_loss":
                                # every host of a slice stopped
                                # heartbeating: whole-slice loss, not a
                                # straggler -- flush-and-exit through the
                                # slice-granular error so recovery shrinks
                                # onto the survivors
                                lost = (info.get("lost_slices")
                                        or [None])[0]
                                self.search_trajectory.event(
                                    "slice_lost", step=global_step,
                                    slice=lost,
                                    surviving_devices=info.get(
                                        "surviving_devices"))
                                raise rz.SliceLossError(
                                    "health watchdog: whole-slice loss "
                                    f"detected before step {global_step} "
                                    f"({info.get('classification', info)})",
                                    step=global_step, lost_slice=lost,
                                    surviving_devices=info.get(
                                        "surviving_devices"))
                            raise rz.CollectiveTimeout(
                                "health watchdog: "
                                f"{info.get('kind', 'hang')} "
                                f"detected before step {global_step} "
                                f"({info})", step=global_step, info=info)
                        mon.step_started(global_step)
                    t0 = time.perf_counter()
                    if canary is not None:
                        # the optimizers update in place: keep the
                        # pre-step state (and the seed generator's) for
                        # the canary's re-execution and its escalation
                        rng_before = self._rng.get_state()
                        prev_state = self.state
                        kept = self.executor.snapshot_state(self.state)
                    # the step's seed, drawn as the step itself would draw
                    # it (a canary re-execution reuses it)
                    args = [self.state, batch[:-1], batch[-1],
                            step_seed(self._rng)]
                    if guard_cfg is not None:
                        poison = 1.0
                        if fault_injector is not None and \
                                fault_injector.fire("nan_grads", global_step):
                            poison = float("nan")
                        args.append(torch.full(
                            (), poison, dtype=torch.float32,
                            device=self.executor.device))
                    self.state, partials = step_fn(*args)
                    if canary is not None:
                        prev_pnorm, prev_loss = self._canary_check(
                            vfy, canary, prev_state, kept, rng_before, args,
                            step_fn, partials, fault_injector, manager,
                            global_step, epoch, bi, pnorm_fn, prev_pnorm,
                            prev_loss)
                    if mon is not None:
                        # the watchdog can only observe completion if we
                        # wait for it -- per-step sync is the price of
                        # hang detection
                        self._sync()
                        mon.step_finished(global_step)
                    if mon is not None or draining or tuner_obj is not None:
                        # feed the executor's step-time EMA (drain-window
                        # estimate) and the tuner's drift watch -- only
                        # from synced steps, where the wall time measures
                        # the step and not a launch
                        if mon is None:
                            self._sync()
                        dur = time.perf_counter() - t0
                        self.executor.note_step_duration(dur)
                        if tuner_obj is not None:
                            tuner_obj.observe_step(dur)
                    if tel is not None:
                        loss_val = None
                        if tel.config.sync_per_step:
                            loss_val = float(partials["loss"])
                        tel.record_step(
                            step=global_step,
                            dur_s=time.perf_counter() - t0,
                            batch_size=bs,
                            n_chips=rdist.process_count(), loss=loss_val,
                            t0=t0,
                        )
                    device_partials.append(partials)
                    num_samples += bs
                    global_step += 1
                    if guard_cfg is not None:
                        # skip monitor: a run stuck on non-finite grads
                        # must fail loudly, not silently stop learning
                        # the most any rank counts: no rank stops alone
                        skips = rdist.max_over_ranks(
                            int(self.state.guard.consecutive_skips))
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
                    if tuner_obj is not None and not draining:
                        # the tuner's step boundary: probe, trigger,
                        # collect the background search, a pending swap
                        # (transactional), the guard window. True means
                        # the LIVE EXECUTOR changed (commit or rollback):
                        # rebuild the step. No swap during a preemption
                        # drain: the grace window is for checkpointing
                        if tuner_obj.on_step_boundary(
                                global_step, batch=(batch[:-1], batch[-1])):
                            step_fn = self.executor.build_train_step()
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
        finally:
            if own_monitor:
                # a monitor this fit started stops with it (every rank
                # here: a collective heartbeat ends its beats in step)
                mon.stop()
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
        if tel is not None and getattr(tel.config, "step_profile", False):
            # the same in-situ capture epilogue as the plain loop
            self._capture_step_profile(tel, xs, y, bs)
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
        self._assert_same_global_batch(
            xs, y, batch_size or self.config.batch_size)
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
        self.executor.update_weights(self.state, self._pending_grads)
        with torch.no_grad():
            for op, bufs in (self._pending_net_state or {}).items():
                for k, v in bufs.items():
                    self.state.net_state[op][k].copy_(v)
        self.state.step += 1
        self._pending_grads = None
        self._pending_net_state = None

    # -- the native Python API (reference: flexflow_cffi.py) ---------------
    def get_perf_metrics(self) -> Optional[PerfMetrics]:
        return self.perf_metrics

    def reset_metrics(self) -> None:
        """reference: flexflow_cffi.py:1968 reset_metrics."""
        self.perf_metrics = PerfMetrics()

    def compute_metrics(self) -> PerfMetrics:
        """Fold the metrics of the bound batch's last `forward` into
        perf_metrics (reference: flexflow_cffi.py:2004 compute_metrics)."""
        if self._last_logits is None or self._current_batch is None:
            raise RuntimeError("compute_metrics: set_iteration_batch and "
                               "forward first")
        _, label = self._current_batch
        ex = self.executor
        with torch.no_grad():
            labels = truncate_labels(ex._as_labels(label), self._last_logits)
            partials = ex.metrics.compute(self._last_logits, labels)
        self.perf_metrics.update({k: float(full(v)) for k, v
                                  in partials.items() if k != "loss"})
        return self.perf_metrics

    def prefetch(self) -> None:
        """No-op: a weight lives on the device from compile on; kept for
        the reference's scripts (flexflow_cffi.py:1982)."""

    def map_tensor(self, tensor, parallel_op=None) -> None:
        """No-op: a tensor is placed at its first use (reference:
        flexflow_cffi.py:937 maps Legion regions)."""

    def get_layers(self) -> Dict[int, Layer]:
        return dict(enumerate(self.layers))

    def get_layer_by_id(self, idx: int) -> Layer:
        return self.layers[idx]

    def get_layer_by_name(self, name: str) -> Layer:
        for layer in self.layers:
            if layer.name == name:
                return layer
        raise KeyError(f"no layer named {name!r}")

    def get_last_layer(self) -> Layer:
        return self.layers[-1]

    def print_layers(self, id: int = -1) -> None:
        """reference: flexflow_cffi.py print_layers; the JAX package's
        lines."""
        for i, layer in enumerate(self.layers):
            if id in (-1, i):
                shapes = [tuple(t.dims) for t in layer.outputs]
                # a user-facing inspection call: printing is its contract
                print(f"layer {i}: {layer.name} ({layer.op_type.name}) "
                      f"-> {shapes}")

    # -- weight and batch access (reference: parallel_tensor.cc
    #    set_tensor/get_tensor) ---------------------------------------------
    def _find_weight_slot(self, t: Tensor) -> Optional[Tuple[str, str]]:
        """(op name, weight name) of weight tensor `t` in the compiled
        graph, else None."""
        layer = t.owner_layer
        if layer is None or self.state is None:
            return None
        for i, wt in enumerate(layer.weights):
            if wt.guid == t.guid:
                for op in self.graph.ops:
                    if op.layer_guid == layer.guid:
                        return op.name, op.weight_names[i]
        return None

    def _get_tensor_value(self, t: Tensor) -> np.ndarray:
        """A host copy of a weight (the whole of it on a device mesh), or
        of the bound batch's input or label array."""
        slot = self._find_weight_slot(t)
        if slot is not None:
            w = full(self.params[slot[0]][slot[1]]).detach()
            if w.dtype == torch.bfloat16:
                w = w.float()
            return w.cpu().numpy().copy()
        if self._current_batch is not None:
            ins, lab = self._current_batch
            if (self.label_tensor is not None
                    and t.guid == self.label_tensor.guid and lab is not None):
                return np.asarray(lab)
            for i, ft in enumerate(self._fit_input_tensors):
                if ft.guid == t.guid and ins[i] is not None:
                    return np.asarray(ins[i])
        raise KeyError(f"tensor {t} is not a weight; activations are not "
                       "retained")

    def _set_tensor_value(self, t: Tensor, value: np.ndarray) -> None:
        """Write a weight in place: its storage stays where it is, so the
        captured graphs that read it by address (the train scan, the
        decode step) read the new value, and its version moves, so the
        serving caches refresh. On a device mesh each rank writes its
        shard of the whole value. An input or the label binds the
        stepwise loop's batch instead."""
        slot = self._find_weight_slot(t)
        if slot is None:
            # reference: mnist_mlp_attach.py input.set_tensor per batch
            return self._attach_array(t, value)
        dst = self.params[slot[0]][slot[1]]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch {tuple(value.shape)} vs "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            # a copy only where the array is strided or read-only
            src = torch.from_numpy(np.require(value, requirements="CW"))
            src = src.to(dst.dtype)
            dst.copy_(shard_like(src, dst))

    def _attach_array(self, t: Tensor, arr) -> None:
        """Bind a numpy array to an input or the label for the stepwise
        forward/backward/update loop (reference: attach_numpy_array, a
        zero-copy Legion attach; here the array feeds the next step)."""
        if self.executor is None:
            raise RuntimeError("attach needs compile() first")
        arr = np.asarray(arr)
        n = len(self.executor.input_pts)
        ins, lab = self._current_batch or ([None] * n, None)
        ins = list(ins)
        if self.label_tensor is not None and t.guid == self.label_tensor.guid:
            self._current_batch = (ins, arr)
            return
        for i, ft in enumerate(self._fit_input_tensors):
            if ft.guid == t.guid:
                ins[i] = arr
                self._current_batch = (ins, lab)
                return
        raise KeyError(
            f"tensor {t} is neither a weight, a graph input, nor the label")


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


def _agreed_plan(plan) -> dict:
    """A fault plan (or a hang's info) that every rank acts on: this
    rank's where it has one, else the first rank's that has one (one
    all-gather; every rank calls it once the ranks agreed that some rank
    fired)."""
    got = rdist.gather_objects(plan)
    mine = plan if plan is not None else next(
        (p for p in got if p is not None), None)
    return dict(mine or {})


def _local_tree(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """A params tree with each DTensor replaced by this rank's shard."""
    return {op: {n: local(w) for n, w in ws.items()}
            for op, ws in params.items()}


def _params_of_snapshot(params, kept) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights of an executor's `snapshot_state` as a params tree:
    the snapshot's leading tensors, in the order the state's tensors are
    listed (params first, op by op, weight by weight)."""
    it = iter(kept)
    return {op: {n: next(it) for n in ws} for op, ws in params.items()}


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


def _to_regularizer(reg) -> Tuple[RegularizerMode, float]:
    """A kernel_regularizer as (RegularizerMode, lambda), as the JAX
    package reads it: a Keras-style object with `.type`/`._lambda`
    (frontends/keras/regularizers.py), an ("l1"|"l2", lambda) tuple, or a
    bare number (L2, as the reference's kernel_reg_lambda, linear.cc:41)."""
    if reg is None:
        return RegularizerMode.REG_MODE_NONE, 0.0
    if isinstance(reg, (int, float)):
        return RegularizerMode.REG_MODE_L2, float(reg)
    if isinstance(reg, tuple):
        kind, lam = reg
        mode = {"l1": RegularizerMode.REG_MODE_L1,
                "l2": RegularizerMode.REG_MODE_L2}[str(kind).lower()]
        return mode, float(lam)
    return RegularizerMode(reg.type), float(reg._lambda)


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
