"""PCG executor: weights, the forward walk, the train step and the
serving decode step.

The PyTorch counterpart of flexflow_tpu/parallel/executor.py on one
device: `init_params`/`init_state`, `apply`/`build_forward`, the training
steps (`build_train_step`, `build_grad_step`, `build_eval_step`) and
`build_decode`, with `compute_dtype` (bf16 compute over f32 master weights
under mixed precision) and `grad_dtype` (gradients rounded to bf16 before
the update, the JAX package's default under mixed precision). Meshes and
sharding are not ported. PyTorch runs eagerly, so the "built" functions
are plain closures. `apply` records an autograd graph when its weights
require grad; the serving entry points (`build_forward`'s closure and
the decode step) run under `torch.inference_mode`, so serving records
none.

The train step differentiates through detached copies of the weights
(`detach().requires_grad_()` leaves, `torch.autograd.grad`) and then
updates the weight tensors themselves in place under no_grad, so the
params dict a model serves from is the one training updates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.initializers import get_initializer
from ..core.losses import get_loss_fn
from ..ff_types import LossType, OperatorType
from ..ops.attention import init_decode_cache
from ..ops.registry import FwdCtx, get_op_def
from ..pcg.graph import Graph

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class TrainState:
    """The training state of a compiled model: weights, optimizer state
    and the step count."""

    params: Params
    opt_state: Any
    step: int = 0


class PCGExecutor:
    """Runs a PCG on one device."""

    def __init__(self, graph: Graph, device: torch.device, *,
                 optimizer=None, loss_type: Optional[LossType] = None,
                 metrics=None, compute_dtype: Optional[torch.dtype] = None,
                 grad_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 input_order: Optional[List] = None):
        self.graph = graph
        self.device = torch.device(device)
        self.optimizer = optimizer
        self.loss_fn = get_loss_fn(loss_type) if loss_type is not None else None
        self.metrics = metrics
        self.compute_dtype = compute_dtype
        self.grad_dtype = grad_dtype
        self.seed = seed
        self.topo = graph.topo_order()
        # user-facing input order is tensor creation order
        self.input_pts = (list(input_order) if input_order is not None
                          else graph.input_tensors())
        outs = graph.output_tensors()
        if not outs:
            raise ValueError("graph has no output tensor")
        self.logits_pt = outs[-1]
        # labels: class ids for sparse CE, else the output's dtype
        self.label_dtype = (
            torch.int32
            if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
            else self.logits_pt.data_type.torch_dtype)
        self._decode_builds = {}

    # -- parameter init ----------------------------------------------------
    def init_params(self) -> Params:
        """Every op's weights from its initializers, drawn in topo order
        from one CPU generator seeded by `seed`, then moved to the device."""
        gen = torch.Generator().manual_seed(self.seed)
        params: Params = {}
        for op in self.topo:
            if not op.weights:
                continue
            params[op.name] = {
                name: get_initializer(op.initializers.get(
                    name, "glorot_uniform"))(
                    gen, wpt.material_shape(), wpt.data_type.torch_dtype
                ).to(self.device)
                for name, wpt in zip(op.weight_names, op.weights)
            }
        return params

    def init_state(self) -> TrainState:
        params = self.init_params()
        opt_state = (self.optimizer.init_state(params)
                     if self.optimizer is not None else None)
        return TrainState(params=params, opt_state=opt_state)

    def _ctx(self, op_name: str = "", training: bool = False,
             rng: Optional[torch.Generator] = None) -> FwdCtx:
        return FwdCtx(training=training, compute_dtype=self.compute_dtype,
                      op_name=op_name, rng=rng)

    def _as_input(self, pt, array) -> torch.Tensor:
        return torch.as_tensor(array, dtype=pt.data_type.torch_dtype,
                               device=self.device)

    def _input_vals(self, batch_inputs) -> Dict[int, torch.Tensor]:
        if len(batch_inputs) != len(self.input_pts):
            raise ValueError(f"model takes {len(self.input_pts)} inputs, "
                             f"got {len(batch_inputs)}")
        return {pt.guid: self._as_input(pt, a)
                for pt, a in zip(self.input_pts, batch_inputs)}

    def _as_labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(labels, dtype=self.label_dtype,
                               device=self.device)

    # -- forward -----------------------------------------------------------
    def apply(self, params: Params, inputs: Dict[int, torch.Tensor], *,
              training: bool = False,
              rng: Optional[torch.Generator] = None
              ) -> Dict[int, torch.Tensor]:
        """Walk the PCG and compute every tensor. Returns guid -> value."""
        vals = dict(inputs)
        for op in self.topo:
            opdef = get_op_def(op.op_type)
            outs = opdef.forward(op.params, params.get(op.name, {}),
                                 [vals[t.guid] for t in op.inputs],
                                 self._ctx(op.name, training, rng))
            for t, o in zip(op.outputs, outs):
                vals[t.guid] = o
        return vals

    def build_forward(self) -> Callable:
        """fwd(params, batch_inputs) -> the graph output."""

        @torch.inference_mode()
        def fwd(params, batch_inputs):
            vals = self.apply(params, self._input_vals(batch_inputs))
            return vals[self.logits_pt.guid]

        return fwd

    # -- training ------------------------------------------------------------
    def _require_training(self, what: str) -> None:
        if self.loss_fn is None or self.optimizer is None:
            raise RuntimeError(f"{what}: compile() the model with a loss_type "
                               "(and an optimizer) to train it")

    def _cast_grads(self, grads: Params) -> Params:
        """Half-width gradient storage: every gradient rounded to
        grad_dtype (bf16 under mixed precision) before the update."""
        if self.grad_dtype is None:
            return grads
        return {op: {n: g.to(self.grad_dtype) for n, g in gs.items()}
                for op, gs in grads.items()}

    def _loss_and_grads(self, params: Params, batch_inputs, labels,
                        rng: Optional[torch.Generator]):
        """(loss, logits, grads) of the training forward; grads are cast
        by `_cast_grads`. The weights themselves are not touched."""
        names = [(op, n) for op, ws in params.items() for n in ws]
        leaves = {op: {n: w.detach().requires_grad_() for n, w in ws.items()}
                  for op, ws in params.items()}
        flat = [leaves[op][n] for op, n in names]
        with torch.enable_grad():
            vals = self.apply(leaves, self._input_vals(batch_inputs),
                              training=True, rng=rng)
            logits = vals[self.logits_pt.guid]
            loss = self.loss_fn(logits, labels)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
        grads: Params = {}
        for (op, n), w, g in zip(names, flat, gs):
            grads.setdefault(op, {})[n] = torch.zeros_like(w) if g is None else g
        return loss.detach(), logits.detach(), self._cast_grads(grads)

    def build_train_step(self) -> Callable:
        """step(state, batch_inputs, labels, rng=None) -> (state,
        partials): one forward, backward and optimizer update. The weights
        and optimizer buffers are updated in place, so the returned state
        holds the same params dict; partials are the metrics' summed
        partials plus "loss", 0-d tensors left on the device."""
        self._require_training("build_train_step")

        def step(state: TrainState, batch_inputs, labels, rng=None):
            labels = self._as_labels(labels)
            loss, logits, grads = self._loss_and_grads(
                state.params, batch_inputs, labels, rng)
            params, opt_state = self.optimizer.update(state.params, grads,
                                                      state.opt_state)
            with torch.no_grad():
                partials = self.metrics.compute(logits, labels)
            partials["loss"] = loss
            return TrainState(params=params, opt_state=opt_state,
                              step=state.step + 1), partials

        return step

    def build_grad_step(self) -> Callable:
        """grad_of(params, batch_inputs, labels) -> grads: the train step's
        gradients (cast as it casts them) without the update. As in the JAX
        package it passes no rng, so no op draws random numbers."""
        self._require_training("build_grad_step")

        def grad_of(params, batch_inputs, labels):
            return self._loss_and_grads(params, batch_inputs,
                                        self._as_labels(labels), None)[2]

        return grad_of

    def build_eval_step(self) -> Callable:
        """step(params, batch_inputs, labels) -> (logits, partials), the
        inference forward (no dropout, no graph) plus metrics and loss."""
        self._require_training("build_eval_step")

        @torch.no_grad()
        def step(params, batch_inputs, labels):
            labels = self._as_labels(labels)
            logits = self.apply(params, self._input_vals(batch_inputs))[
                self.logits_pt.guid]
            partials = self.metrics.compute(logits, labels)
            partials["loss"] = self.loss_fn(logits, labels)
            return logits, partials

        return step

    # -- incremental decode (serving KV cache) -----------------------------
    def build_decode(self, batch: int, max_len: int):
        """(init_caches, step) for KV-cache decoding of a causal decoder.

        init_caches(params=None) zero-fills one (k, v) cache per
        self-attention op: {"mha": {op_name: (k, v)}}. step(params,
        caches, t, [token_block]) runs the block's positions: t is an int
        (every row at the same position) or a (batch,) int array of
        per-row positions (continuous batching). Returns (logits, caches);
        the caches are updated in place."""
        from . import decode as dec

        key = (batch, max_len)
        if key in self._decode_builds:
            return self._decode_builds[key]
        plan = dec.build_plan(self.topo, self.input_pts)
        if plan.static_ops or len(self.input_pts) != 1:
            raise dec.DecodeExactnessError(
                "graphs with static (non-decode) inputs or ops are not "
                "ported yet: decoder-only graphs with one input decode")
        if not plan.info.get(self.logits_pt.guid, dec.AxisInfo()).is_live:
            raise NotImplementedError(
                "the graph output does not depend on the decode input")
        cdt = self.compute_dtype or torch.float32
        mha = [op for op in plan.live_ops
               if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]

        def init_caches(params=None):
            return {"mha": {op.name: init_decode_cache(
                op.params, batch, max_len, cdt, self.device) for op in mha}}

        @torch.inference_mode()
        def step(params, caches, t, batch_inputs):
            (tok,) = batch_inputs
            tok = self._as_input(plan.decode_pt, tok)
            if not isinstance(t, int):
                t = torch.as_tensor(t, dtype=torch.int32)
                if t.dim() == 0:
                    t = int(t)
                elif t.shape[0] != tok.shape[0]:
                    raise ValueError(f"per-row positions: {t.shape[0]} "
                                     f"positions for {tok.shape[0]} rows")
                else:
                    t = t.to(self.device)  # once, not once per layer
            vals = {plan.decode_pt.guid: tok}
            for op in plan.live_ops:
                d = get_op_def(op.op_type)
                w = params.get(op.name, {})
                ins = [vals[x.guid] for x in op.inputs]
                if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
                    outs, caches["mha"][op.name] = d.forward_decode(
                        op.params, w, ins, self._ctx(op.name),
                        caches["mha"][op.name], t)
                else:
                    outs = d.forward(op.params, w, ins, self._ctx(op.name))
                for x, v in zip(op.outputs, outs):
                    vals[x.guid] = v
            return vals[self.logits_pt.guid], caches

        built = (init_caches, step)
        self._decode_builds[key] = built
        return built
