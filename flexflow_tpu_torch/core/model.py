"""FFModel: the user-facing model container.

The PyTorch counterpart of flexflow_tpu/core/model.py: the builder methods
the served LM and the flagship Transformer use, `compile` on the manual
single-device branch, `fit` and `eval` (training), and `forward`/`predict`
(serving). Op names follow the JAX package
(`f"{op_type.name.lower()}_{len(self.layers)}"`), so weights carry across
by (op name, weight name) (runtime/weights.py).

`compile` builds the loss, the metrics and the optimizer state into
`self.state` (a TrainState); `self.params` is `self.state.params`, the one
dict that training updates and serving reads. It refuses a strategy search
(search_budget >= 0) and more than one device, neither of which is ported
yet. `fit` is the JAX package's stepwise loop (one train step per batch,
per-epoch metrics, the reference's throughput line); the multi-step scan,
the step guard, checkpointing and telemetry are not ported.
"""
from __future__ import annotations

import time
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
from ..parallel.executor import PCGExecutor, TrainState
from ..pcg.lowering import layers_to_pcg
from .losses import to_loss_type
from .metrics import Metrics, PerfMetrics
from .optimizers import SGDOptimizer
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
        self._fit_input_tensors: List[Tensor] = []
        self._rng: Optional[torch.Generator] = None

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
                         for t in self._fit_input_tensors])
        self.state = self.executor.init_state()
        self.perf_metrics = PerfMetrics()
        self._rng = torch.Generator().manual_seed(self.config.seed)

    # -- training -----------------------------------------------------------
    @staticmethod
    def _batches(arrays: List[np.ndarray], batch_size: int):
        for i in range(arrays[0].shape[0] // batch_size):
            yield [a[i * batch_size:(i + 1) * batch_size] for a in arrays]

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, verbose: bool = True):
        """Train on (x, y): one train step per full batch, `epochs` passes
        (config.epochs by default). The tail that does not fill a batch is
        dropped, with a warning. Prints each epoch's loss and metrics when
        `verbose`, and the reference's ELAPSED TIME / THROUGHPUT line at the
        end. Returns the last epoch's PerfMetrics."""
        if self.executor is None:
            raise RuntimeError("fit: call compile() first")
        step_fn = self.executor.build_train_step()
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
            for batch in self._batches(xs + [y], bs):
                self.state, partials = step_fn(self.state, batch[:-1],
                                               batch[-1], self._rng)
                device_partials.append(partials)
                num_samples += bs
            folded = {k: float(torch.stack([p[k] for p in device_partials])
                               .double().sum())
                      for k in device_partials[0]}
            last_loss = float(device_partials[-1]["loss"])
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
        (x, y); prints the metrics line and returns the PerfMetrics."""
        if self.executor is None:
            raise RuntimeError("eval: call compile() first")
        step_fn = self.executor.build_eval_step()
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        pm = PerfMetrics()
        for batch in self._batches(xs + [y],
                                   batch_size or self.config.batch_size):
            _, partials = step_fn(self.params, batch[:-1], batch[-1])
            pm.update({k: float(v) for k, v in partials.items()})
        print(pm.report())
        return pm

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
