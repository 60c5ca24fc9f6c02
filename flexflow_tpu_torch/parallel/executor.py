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

Ops with a loss term of their own (MoE's load balance, ops/moe.py) put
it in the walk's `aux_out` list; every training objective (the eager
step, the scan, the grad step and so the stepwise `backward`) adds those
terms to the loss, and the reported loss includes them, as in JAX.

Stateful ops (BatchNorm's running statistics, Cache) keep their state in
`TrainState.net_state` ({op name: {buffer name: tensor}},
`init_net_state`). `apply` hands each such op its state and collects
what it returns in `net_out`; the train step writes that back into the
same buffers in place (a captured scan updates them at replay), and eval,
`build_forward` and `predict` read them.

Randomness (dropout) follows the JAX package's key structure on host
integers (core/seeds.py): a training step draws one seed from the
caller's CPU generator, and each compute op that draws gets the two
dropout seeds of `fold_in(step seed, compute index)`, so an op's draws do
not depend on the order in which other ops draw. A compute index counts
compute ops only: the parallel ops a searched graph carries
(parallel/parallel_ops.py, the identity on one device) take none, as in
the JAX package, so a searched graph draws the masks of the unsearched
one. The seeds reach the ops as rows of a seed table on the device
(`seed_table`), one row per step.

Constant inputs (FFModel.create_constant / create_constant_tensor) are
materialized once on the device and fed into every walk; `build_decode`
decodes any graph parallel/decode.py can prove exact: decoder-only or
encoder-decoder, fused or primitive-op attention, static inputs.

The NaN/Inf step guard (runtime/resilience.py StepGuardConfig,
`set_step_guard`) runs inside the eager train step, on the device, as
the JAX package's runs inside its jitted step: the loss scaled by the
dynamic loss scale, the gradients unscaled (and poisoned by fit's
`nan_grads` fault site), one global gradient norm, the update kept only
where that norm is finite, and the scale and skip counters advanced in
`TrainState.guard`, with no host sync. The optimizers update in place,
so a guarded step snapshots the weights and optimizer buffers first and
writes the snapshot back where the norm is not finite: a skipped step
leaves them bit for bit as they were. The train scan refuses an armed
guard, as the JAX package's does: fit with the guard dispatches
stepwise.

Where the JAX package jits a program, the port captures a CUDA graph on
a card (parallel/graphs.py): `build_train_scan` runs N train steps as one
captured graph over staged batches (JAX: one lax.scan program), and the
decode step's one-token blocks replay a graph captured once per (batch,
max_len) and cache set (JAX: the jitted decode step). On the CPU both are
the same steps run eagerly. `remat` recomputes each attention op in the
backward (torch.utils.checkpoint; JAX: jax.checkpoint).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.initializers import get_initializer
from ..core.losses import get_loss_fn
from ..core.seeds import seed_table, step_seed
from ..ff_types import LossType, OperatorType
from ..ops.attention import init_decode_cache
from ..ops.common import WeightCache
from ..ops.registry import FwdCtx, get_op_def
from ..pcg.graph import Graph
from . import parallel_ops

Params = Dict[str, Dict[str, torch.Tensor]]

# ops recomputed in the backward under config.remat (the JAX package's
# _REMAT_OPS): attention, whose internals dominate the saved residuals.
# No op that adds an aux loss (MoE) may join: the recompute would run
# its forward, and so add its loss, a second time
_REMAT_OPS = frozenset({OperatorType.OP_MULTIHEAD_ATTENTION})
# captured graphs kept: train scans per executor (one per chunk length
# and batch shapes, on the live state), decode steps per (batch, max_len)
# build (one per cache set, on the live weights); the least recently used
# goes first
_GRAPHS_KEPT = 4


def _keep_recent(graphs: collections.OrderedDict, key, graph) -> None:
    """Put a captured graph at the recent end of `graphs`. A key starts
    with the addresses of the weights (decode) or the state (scan) the
    graph was captured on: graphs whose key starts otherwise were captured
    on tensors since replaced, and go (a decode graph would pin a retired
    weight set and its compute-dtype copies), as do the least recently
    used beyond _GRAPHS_KEPT (and their memory pools)."""
    for k in [k for k in graphs if k[0] != key[0]]:
        del graphs[k]
    graphs[key] = graph
    graphs.move_to_end(key)
    while len(graphs) > _GRAPHS_KEPT:
        graphs.popitem(last=False)


def truncate_labels(labels, logits):
    """The JAX package's `truncate_labels`: with forward(seq_length=N) the
    logits lose positions, so every label axis longer than the logits'
    is sliced to it (a sparse label's trailing 1 stays)."""
    if labels.dim() != logits.dim():
        return labels
    for ax in range(1, labels.dim()):
        if labels.shape[ax] > logits.shape[ax]:
            labels = labels.narrow(ax, 0, logits.shape[ax])
    return labels


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _mark_moved(params) -> None:
    """Bump the version counters of weights that a graph replay updated.
    A replay runs no ATen dispatch, so without this nothing would tell the
    serving weight cache (ops/common.py) that they moved."""
    for t in _tensors(params):
        torch.autograd.graph.increment_version(t)


def _stage_rows(pinned: torch.Tensor, rows) -> None:
    """Write N per-step arrays (or one (N, ...) array or tensor) into a
    pinned host buffer, cast to its dtype."""
    for j in range(pinned.shape[0]):
        row = rows[j]
        if not isinstance(row, torch.Tensor):
            row = torch.from_numpy(np.ascontiguousarray(row))
        pinned[j].copy_(row)


def _constant_tensor(pt, value, shape, device) -> torch.Tensor:
    """A constant's value on `device` in its tensor's dtype: a baked
    array as it is, a float filled to `shape`."""
    dtype = pt.data_type.torch_dtype
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, dtype=dtype, device=device)
    return torch.full(shape, value, dtype=dtype, device=device)


@dataclasses.dataclass
class GuardState:
    """Device-resident step-guard counters (runtime/resilience.py
    StepGuardConfig): dynamic loss scale + skip bookkeeping, 0-d tensors
    advanced in place inside the train step, so the guarded step needs
    no host sync."""

    loss_scale: torch.Tensor        # f32: the dynamic loss scale
    good_steps: torch.Tensor        # i32: consecutive finite steps (regrowth)
    consecutive_skips: torch.Tensor  # i32: fit() hard-fails past the max
    total_skips: torch.Tensor       # i32: run-lifetime skipped steps

    FIELDS = ("loss_scale", "good_steps", "consecutive_skips", "total_skips")

    @classmethod
    def create(cls, loss_scale: float, device) -> "GuardState":
        """A fresh guard on `device`: the scale, no steps counted."""
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return cls(loss_scale=torch.full((), loss_scale, dtype=torch.float32,
                                         device=device),
                   good_steps=zero.clone(), consecutive_skips=zero.clone(),
                   total_skips=zero.clone())

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.FIELDS}


@dataclasses.dataclass
class TrainState:
    """The training state of a compiled model: weights, optimizer state,
    the step count, the stateful ops' buffers (net_state) and the step
    guard's counters (None when the guard is off, the default)."""

    params: Params
    opt_state: Any
    step: int = 0
    net_state: Params = dataclasses.field(default_factory=dict)
    guard: Optional[GuardState] = None


def global_grad_norm(grads) -> torch.Tensor:
    """L2 norm over every gradient tensor, accumulated in f32 (bf16 grads
    would overflow the squares). NaN/Inf anywhere in any gradient
    surfaces here as a non-finite norm: one scalar finiteness check
    covers them all."""
    leaves = _tensors(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(leaves, 2, dtype=torch.float32)))


class PCGExecutor:
    """Runs a PCG on one device."""

    def __init__(self, graph: Graph, device: torch.device, *,
                 optimizer=None, loss_type: Optional[LossType] = None,
                 metrics=None, compute_dtype: Optional[torch.dtype] = None,
                 grad_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 input_order: Optional[List] = None, remat: bool = False,
                 constants: Optional[Dict] = None):
        self.graph = graph
        self.device = torch.device(device)
        self.optimizer = optimizer
        self.loss_fn = get_loss_fn(loss_type) if loss_type is not None else None
        self.metrics = metrics
        self.compute_dtype = compute_dtype
        self.grad_dtype = grad_dtype
        self.seed = seed
        self.topo = graph.topo_order()
        # each compute op's index among the compute ops (parallel ops
        # take none)
        self.compute_index = {
            op.guid: i for i, op in enumerate(
                o for o in self.topo if not o.is_parallel_op)}
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
        self.remat = remat
        # guid -> (ParallelTensor, float OR baked np.ndarray): graph inputs
        # that are not batch inputs (FFModel.create_constant /
        # create_constant_tensor; reference: flexflow_constant_create,
        # flexflow_cffi.py:941). Materialized once on the device, so every
        # walk (and every captured graph) reads the same tensors
        self.constants = constants or {}
        self._const_vals = {
            guid: _constant_tensor(pt, value, tuple(pt.material_shape()),
                                   self.device)
            for guid, (pt, value) in self.constants.items()}
        self._decode_builds = {}
        self._scan_graphs = collections.OrderedDict()
        # the NaN/Inf step guard (set_step_guard) and the synced step-time
        # EMA behind drain_window_s
        self.step_guard = None
        self._step_dur_ema: Optional[float] = None
        # serving's compute-dtype weight copies (ops/common.py)
        self.weight_cache = WeightCache()
        # compute indices of the ops that draw random numbers in training
        self.drawing_ops = [
            self.compute_index[op.guid] for op in self.topo
            if not op.is_parallel_op
            and get_op_def(op.op_type).draws is not None
            and get_op_def(op.op_type).draws(op.params)]

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
        # a merge substitution (search/substitution_loader.py) builds its
        # merged op's weights afresh: it refuses a graph whose weights
        # exist
        self.graph.weights_materialized = True
        return params

    def init_net_state(self) -> Params:
        """Zero- or one-filled buffers of the stateful ops, on the device
        (reference: cuDNN BN's running statistics at init)."""
        net: Params = {}
        for op in self.topo:
            d = get_op_def(op.op_type)
            if d.state_spec is None:
                continue
            specs = d.state_spec(op.params,
                                 [t.material_shape() for t in op.inputs],
                                 [t.data_type for t in op.inputs])
            net[op.name] = {
                spec.name: torch.full(
                    tuple(spec.shape), 1.0 if spec.initializer == "one"
                    else 0.0, dtype=spec.dtype.torch_dtype,
                    device=self.device)
                for spec in specs}
        return net

    def init_state(self) -> TrainState:
        params = self.init_params()
        opt_state = (self.optimizer.init_state(params)
                     if self.optimizer is not None else None)
        return TrainState(params=params, opt_state=opt_state,
                          net_state=self.init_net_state())

    # -- the step guard and the drain window -------------------------------
    def set_step_guard(self, cfg) -> None:
        """Enable/disable the NaN/Inf step guard (a
        resilience.StepGuardConfig or None). A change drops the captured
        train scans: they were captured without it."""
        if cfg != self.step_guard:
            self.step_guard = cfg
            self._scan_graphs.clear()

    def init_guard_state(self) -> GuardState:
        if self.step_guard is None:
            raise RuntimeError("init_guard_state: set_step_guard() first")
        return GuardState.create(self.step_guard.init_loss_scale, self.device)

    def note_step_duration(self, dur_s: float) -> None:
        """Feed the step-time EMA behind `drain_window_s`. fit() calls
        this only for SYNCED steps (drain mode), where the wall time
        measured a whole step rather than an asynchronous launch."""
        if dur_s <= 0:
            return
        ema = self._step_dur_ema
        self._step_dur_ema = (dur_s if ema is None
                              else 0.5 * ema + 0.5 * dur_s)

    @property
    def step_dur_ema(self) -> Optional[float]:
        """The measured synced-step wall-time EMA (None until fed)."""
        return self._step_dur_ema

    def drain_window_s(self, checkpoint_s: Optional[float] = None,
                       safety: float = 2.0) -> float:
        """How much of a preemption deadline must remain for fit() to
        risk ONE more step: the expected step time plus the expected
        checkpoint flush, with a safety factor (steps and flushes
        jitter; blowing the deadline means a hard kill mid-write, which
        costs a whole checkpoint interval of replay). The drain protocol
        keeps training while deadline_remaining() > this window, then
        flushes and leaves."""
        step = self._step_dur_ema or 0.0
        ckpt = checkpoint_s or 0.0
        return safety * (step + ckpt) + 0.25

    def _ctx(self, op_name: str = "", training: bool = False, rng=None,
             seq_length: int = -1, weight_cache=None,
             aux_losses=None) -> FwdCtx:
        return FwdCtx(training=training, compute_dtype=self.compute_dtype,
                      op_name=op_name, rng=rng, seq_length=seq_length,
                      weight_cache=weight_cache, aux_losses=aux_losses)

    def seed_table(self, step_seeds) -> torch.Tensor:
        """The (N, n_ops, 2) int32 CPU seed table of N steps' seeds
        (core/seeds.py)."""
        return seed_table(step_seeds, self.drawing_ops,
                          len(self.compute_index))

    def _seed_row(self, rng) -> Optional[torch.Tensor]:
        """One step's (n_ops, 2) row of seeds on the device: `rng` is None
        (no op draws), a step seed (an int; its row is built and copied
        over) or a row already on the device."""
        if rng is None or isinstance(rng, torch.Tensor):
            return rng
        if not self.drawing_ops:
            return None
        row = self.seed_table([rng])[0]
        if self.device.type == "cuda":
            # pinned and non_blocking: the host does not wait for the
            # card to drain before the step's launches
            row = row.pin_memory()
        return row.to(self.device, non_blocking=True)

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
              training: bool = False, rng=None, seq_length: int = -1,
              weight_cache: Optional[WeightCache] = None,
              net_state: Optional[Params] = None,
              net_out: Optional[Params] = None,
              aux_out: Optional[list] = None) -> Dict[int, torch.Tensor]:
        """Walk the PCG and compute every tensor. Returns guid -> value.
        `rng` is the step's seed (an int) or its seed-table row on the
        device: op i of the walk that draws gets row[i], the seeds of
        fold_in(step seed, i). Under `remat` in training each attention op
        is recomputed in the backward; the recompute reads the same row,
        so it rebuilds the same dropout mask. Stateful ops read their
        buffers from `net_state` (none: batch statistics) and, when
        `net_out` is a dict, put their new buffers there, detached. Ops'
        differentiable aux losses are appended to `aux_out` (a list)."""
        row = self._seed_row(rng)
        drawing = set(self.drawing_ops) if row is not None else ()
        vals = dict(inputs)
        vals.update(self._const_vals)
        for op in self.topo:
            ins = [vals[t.guid] for t in op.inputs]
            if op.is_parallel_op:
                for t, o in zip(op.outputs, parallel_ops.execute(op, ins)):
                    vals[t.guid] = o
                continue
            compute_idx = self.compute_index[op.guid]
            opdef = get_op_def(op.op_type)
            ctx = self._ctx(op.name, training,
                            row[compute_idx] if compute_idx in drawing
                            else None, seq_length, weight_cache, aux_out)
            w = params.get(op.name, {})
            if training and self.remat and op.op_type in _REMAT_OPS:
                # preserve_rng_state off: no op draws from torch's RNG
                outs = checkpoint(
                    lambda w_, *ins_, _d=opdef, _p=op.params, _c=ctx:
                    _d.forward(_p, w_, list(ins_), _c),
                    w, *ins, use_reentrant=False, preserve_rng_state=False)
            elif opdef.forward_stateful is not None:
                outs, new_st = opdef.forward_stateful(
                    op.params, w, (net_state or {}).get(op.name, {}), ins,
                    ctx)
                if net_out is not None:
                    # statistics, not a gradient path
                    net_out[op.name] = {k: v.detach()
                                        for k, v in new_st.items()}
            else:
                outs = opdef.forward(op.params, w, ins, ctx)
            for t, o in zip(op.outputs, outs):
                vals[t.guid] = o
        return vals

    def build_forward(self, seq_length: int = -1) -> Callable:
        """fwd(params, batch_inputs, net_state=None) -> the graph output.
        Ops read their compute-dtype weights from the executor's weight
        cache, and stateful ops their buffers from `net_state` (none:
        batch statistics). `seq_length` >= 0 reaches the ops' context
        (JAX: the iteration config's seq_length; batch_matmul slices its
        a/b_seq_length_dim axes to it)."""

        @torch.inference_mode()
        def fwd(params, batch_inputs, net_state=None):
            vals = self.apply(params, self._input_vals(batch_inputs),
                              seq_length=seq_length,
                              weight_cache=self.weight_cache,
                              net_state=net_state)
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
                        rng, seq_length: int = -1, net_state=None,
                        net_out=None, loss_scale=None):
        """(loss, logits, grads) of the training forward under `rng` (a
        step seed, its seed-table row on the device, or None: no op
        draws); grads are cast by `_cast_grads`. The loss includes the
        ops' aux losses. Stateful ops read `net_state` and put their new
        buffers in `net_out`. With `loss_scale` (a 0-d device tensor) the
        gradients are those of the loss times it (dynamic loss scaling:
        the step guard unscales them); the loss returned stays unscaled.
        The weights themselves are not touched."""
        names = [(op, n) for op, ws in params.items() for n in ws]
        leaves = {op: {n: w.detach().requires_grad_() for n, w in ws.items()}
                  for op, ws in params.items()}
        flat = [leaves[op][n] for op, n in names]
        aux: list = []
        with torch.enable_grad():
            vals = self.apply(leaves, self._input_vals(batch_inputs),
                              training=True, rng=rng, seq_length=seq_length,
                              net_state=net_state, net_out=net_out,
                              aux_out=aux)
            logits = vals[self.logits_pt.guid]
            loss = self.loss_fn(logits, truncate_labels(labels, logits))
            for a in aux:
                loss = loss + a
            gs = torch.autograd.grad(
                loss if loss_scale is None else loss * loss_scale, flat,
                allow_unused=True)
        grads: Params = {}
        for (op, n), w, g in zip(names, flat, gs):
            grads.setdefault(op, {})[n] = torch.zeros_like(w) if g is None else g
        return loss.detach(), logits.detach(), self._cast_grads(grads)

    def _train(self, state: TrainState, batch_inputs, labels: torch.Tensor,
               row, poison=None) -> Dict[str, torch.Tensor]:
        """One train step's device work: forward, backward and the
        in-place update under seed row `row`, and the stateful ops' new
        buffers copied into state.net_state; returns the partials. The
        eager step, the scan and its captured graph all run this. With
        the step guard armed, the guarded step (`_guarded_update`), whose
        `poison` (a 0-d f32 device tensor, NaN to simulate a bad batch;
        None: 1.0) multiplies the unscaled gradients."""
        guard = self.step_guard
        if guard is not None and state.guard is None:
            raise RuntimeError("the step guard is armed but the state has "
                               "no guard counters: init_guard_state()")
        net_out: Params = {}
        loss, logits, grads = self._loss_and_grads(
            state.params, batch_inputs, labels, row,
            net_state=state.net_state, net_out=net_out,
            loss_scale=state.guard.loss_scale if guard is not None else None)
        finite = None
        if guard is None:
            self.optimizer.update(state.params, grads, state.opt_state)
        else:
            finite, gnorm = self._guarded_update(state, grads, poison)
        with torch.no_grad():
            for op, bufs in net_out.items():
                for k, v in bufs.items():
                    state.net_state[op][k].copy_(v)
        with torch.no_grad():
            partials = self.metrics.compute(logits, labels)
        partials["loss"] = loss
        if finite is not None:
            # skipped steps contribute nothing to epoch metrics (their
            # logits/loss are NaN — summing would poison the epoch)
            partials = {k: torch.where(finite, v, torch.zeros_like(v))
                        for k, v in partials.items()}
            partials["skipped"] = 1.0 - finite.to(torch.float32)
            partials["grad_norm"] = torch.where(finite, gnorm, 0.0)
        return partials

    @torch.no_grad()
    def _guarded_update(self, state: TrainState, grads: Params, poison):
        """The step guard (the JAX package's guarded `_make_step`, in its
        order): unscale the gradients (and poison them) in f32, take the
        global norm, apply the update only where it is finite, then back
        the loss scale off or grow it and advance the counters, all on
        the device. Returns (finite, grad norm), 0-d device tensors."""
        cfg, g = self.step_guard, state.guard
        if poison is None:
            poison = torch.ones((), dtype=torch.float32, device=self.device)
        inv = (poison / g.loss_scale).to(torch.float32)
        # unscale (and poison) in f32, then round back to the gradient's
        # dtype, in place. The foreach calls launch a few kernels for the
        # whole list where per-tensor calls launch one each: the eager
        # step is bound by the host's launches
        flat = _tensors(grads)
        wide = [t if t.dtype == torch.float32 else t.to(torch.float32)
                for t in flat]
        torch._foreach_mul_(wide, inv)
        for t, w in zip(flat, wide):
            if w is not t:
                t.copy_(w)
        gnorm = global_grad_norm(grads).to(self.device)
        finite = torch.isfinite(gnorm)
        # a skipped step carries params AND optimizer state through
        # unchanged — momentum/bias-correction (Adam's beta_t too) must
        # not advance on a discarded gradient. The update is in place,
        # so snapshot first and write the snapshot back where not finite
        live = _tensors((state.params, state.opt_state))
        kept = [torch.empty_like(t) for t in live]
        torch._foreach_copy_(kept, live)
        self.optimizer.update(state.params, grads, state.opt_state)
        for t, old in zip(live, kept):
            torch.where(finite, t, old, out=t)
        cap = (cfg.max_loss_scale if cfg.max_loss_scale is not None
               else cfg.init_loss_scale)
        good = torch.where(finite, g.good_steps + 1, 0)
        grow = finite & (good >= cfg.growth_interval)
        backed = torch.clamp_min(g.loss_scale * cfg.backoff_factor,
                                 cfg.min_loss_scale)
        scale = torch.where(
            finite,
            torch.where(grow,
                        torch.clamp_max(g.loss_scale * cfg.growth_factor,
                                        cap),
                        g.loss_scale),
            backed)
        g.loss_scale.copy_(scale)
        g.good_steps.copy_(torch.where(grow, 0, good))
        g.consecutive_skips.copy_(
            torch.where(finite, 0, g.consecutive_skips + 1))
        g.total_skips.add_((~finite).to(torch.int32))
        return finite, gnorm

    def build_train_step(self) -> Callable:
        """step(state, batch_inputs, labels, rng=None, poison=None) ->
        (state, partials): one forward, backward and optimizer update, run
        eagerly. `rng` is a CPU torch.Generator the step draws its seed
        from (the JAX step's key), or that seed as an int; None draws
        nothing. The weights and optimizer buffers are updated in place,
        so the returned state holds the same params dict; partials are the
        metrics' summed partials plus "loss", 0-d tensors left on the
        device. With the step guard armed (set_step_guard), `poison` is
        fit's fault-injection seam (a 0-d f32 device tensor, 1.0 or NaN)
        and the partials also carry "skipped" and "grad_norm"."""
        self._require_training("build_train_step")

        def step(state: TrainState, batch_inputs, labels, rng=None,
                 poison=None):
            partials = self._train(state, batch_inputs,
                                   self._as_labels(labels), step_seed(rng),
                                   poison)
            return dataclasses.replace(state, step=state.step + 1), partials

        return step

    def build_train_scan(self) -> Callable:
        """scan(state, stacked_inputs, stacked_labels, seed_table) ->
        (state, partials): N train steps in one dispatch, the port of the
        JAX package's `build_train_scan`. Every input and the labels carry
        a leading steps axis (an (N, ...) array, or a sequence of N batch
        arrays); `seed_table` is `self.seed_table(step seeds)` (N rows, as
        the stepwise path draws them) or None (no op draws). Partials come
        back stacked, (N,) per key, on the device.

        On a card the N steps are captured in one CUDA graph per (N, batch
        shapes, state) and replayed: each chunk is staged in reused pinned
        host buffers and copied (non_blocking) into the graph's static
        input, label and seed buffers, and each step writes its partials
        into slot j of static (N,) buffers. The first call of a shape
        warms the step up on a side stream from a snapshot of the state
        (restored after), then captures. A failed capture raises. On the
        CPU the scan is a loop over the same step. An armed step guard
        is refused, as the JAX package refuses it."""
        self._require_training("build_train_scan")
        if self.step_guard is not None:
            raise RuntimeError(
                "the fused multi-step scan does not take the step "
                "guard's per-step poison/skip monitoring; resilient fit() "
                "dispatches stepwise (build_train_step)")

        def scan(state: TrainState, stacked_inputs, stacked_labels,
                 seed_table=None):
            if len(stacked_inputs) != len(self.input_pts):
                raise ValueError(f"model takes {len(self.input_pts)} inputs, "
                                 f"got {len(stacked_inputs)}")
            n = len(stacked_labels)
            if self.device.type != "cuda":
                parts = [self._train(
                    state, [a[j] for a in stacked_inputs],
                    self._as_labels(stacked_labels[j]),
                    None if seed_table is None else seed_table[j])
                    for j in range(n)]
                stacked = {k: torch.stack([p[k] for p in parts])
                           for k in parts[0]}
            else:
                stacked = self._scan_graph(state, stacked_inputs,
                                           stacked_labels, seed_table)
            return dataclasses.replace(state, step=state.step + n), stacked

        return scan

    def _scan_graph(self, state, stacked_inputs, stacked_labels, table):
        n = len(stacked_labels)
        shapes = tuple((n,) + tuple(np.shape(a[0])) for a in stacked_inputs)
        label_shape = (n,) + tuple(np.shape(stacked_labels[0]))
        tensors = _tensors((state.params, state.opt_state, state.net_state))
        key = (tuple(t.data_ptr() for t in tensors), shapes, label_shape,
               table is None)
        g = self._scan_graphs.get(key) or _ScanGraph(
            self, shapes, label_shape, table is not None)
        g.stage(stacked_inputs, stacked_labels, table)
        if g.graph is None:
            g.capture(state, tensors)
        _keep_recent(self._scan_graphs, key, g)
        out = {k: v.clone() for k, v in g.graph.replay().items()}
        _mark_moved(state.params)
        return out

    def build_grad_step(self, seq_length: int = -1) -> Callable:
        """grad_of(params, batch_inputs, labels, net_state=None,
        net_out=None) -> grads: the train step's gradients (cast as it
        casts them) without the update. As in the JAX package it passes no
        rng, so no op draws random numbers. Stateful ops read `net_state`
        and, when `net_out` is a dict, put their new buffers there (the
        JAX step returns them beside the gradients). `seq_length` >= 0
        reaches the ops' context and truncates the labels to the logits
        (JAX's seq_length variant)."""
        self._require_training("build_grad_step")

        def grad_of(params, batch_inputs, labels, net_state=None,
                    net_out=None):
            return self._loss_and_grads(params, batch_inputs,
                                        self._as_labels(labels), None,
                                        seq_length, net_state, net_out)[2]

        return grad_of

    def build_eval_step(self) -> Callable:
        """step(params, batch_inputs, labels, net_state=None) -> (logits,
        partials), the inference forward (no dropout, no graph; stateful
        ops read `net_state`) plus metrics and loss."""
        self._require_training("build_eval_step")

        @torch.no_grad()
        def step(params, batch_inputs, labels, net_state=None):
            labels = self._as_labels(labels)
            logits = self.apply(params, self._input_vals(batch_inputs),
                                net_state=net_state)[self.logits_pt.guid]
            partials = self.metrics.compute(logits, labels)
            partials["loss"] = self.loss_fn(logits, labels)
            return logits, partials

        return step

    # -- incremental decode (serving KV cache) -----------------------------
    def build_decode(self, batch: int, max_len: int, cache_dtype=None,
                     decode_input: Optional[int] = None,
                     assume_causal: bool = False):
        """(init_caches, step) for KV-cache autoregressive decoding over an
        arbitrary causal decoder or encoder-decoder PCG (the liveness/
        prefix analysis of parallel/decode.py: attention built from
        primitive batch_matmul/softmax/mask ops decodes O(1)/token too).

        init_caches(params=None, static_inputs=()) computes the static
        (encoder-side) subgraph once and zero-fills the prefix and KV
        caches: {"static": {guid: value}, "prefix": {guid: cache},
        "mha": {op: (k, v)}, "mha_static": {op: (k, v)}} ("mha_static"
        holds the cross-attention ops' encoder K/V). step(params, caches,
        t, [token_block]) runs the block's positions: seq-pointwise ops
        execute on the (batch, s0, ...) slice, self-attention appends this
        block's K/V and attends against the prefix, cross-attention attends
        the precomputed encoder K/V, and static/constant operands (position
        tables, masks) are sliced per step. t is an int (every row at the
        same position) or a (batch,) int array of per-row positions
        (continuous batching). Returns (logits, caches); the caches are
        updated in place, and ops read their compute-dtype weights from
        the executor's weight cache.

        On a card a one-token block with per-row positions replays a CUDA
        graph (the JAX package's jitted decode step), captured at the first
        such step for each cache set and weight set (the key holds the
        address and shape of every cache tensor the step reads): token ids
        and positions go into static device buffers, and the logits
        returned are the graph's output buffer, which the next step
        overwrites, so consume or clone them first. Keep the caches (and
        the weights) between steps if you want replays: new tensors at new
        addresses capture a new graph. Prefill (blocks longer than one
        token) and int positions run eagerly, as does every step given
        `_eager=True`.

        Build-time validation rejects graphs the scheme can't prove exact:
        ops mixing sequence positions without a decode rule, non-causal
        self-attention, softmax over the live axis."""
        from ..ops.attention import (_forward_decode_cross, cross_decode_kv,
                                     init_decode_cache)
        from . import decode as dec

        key = (batch, max_len, cache_dtype, decode_input, assume_causal)
        if key in self._decode_builds:
            return self._decode_builds[key]
        plan = dec.build_plan(self.topo, self.input_pts, self.constants,
                              decode_input, assume_causal=assume_causal)
        # prefix caches patch ONLY axis 0 to the decode batch; a graph that
        # folds batch with heads on axis 0 (B*H, ...) would get a
        # wrong-sized cache when decoding at a different batch than
        # compile (beam search at num_beams) -- reject at build like the
        # other exactness checks
        compile_batch = plan.decode_pt.material_shape()[0]
        produced = {x.guid: x for op in plan.live_ops for x in op.outputs}
        for g in plan.cached_guids:
            pt = produced[g]
            if plan.info[g].live != 0 and \
                    pt.material_shape()[0] != compile_batch:
                raise NotImplementedError(
                    f"cached tensor guid {g} has axis-0 size "
                    f"{pt.material_shape()[0]} != compiled batch "
                    f"{compile_batch}: its batch dim is folded with "
                    "another axis, so decoding at a different batch "
                    "would mis-size the cache")
        if plan.requires_cap_le_live_len and max_len > plan.live_len:
            raise NotImplementedError(
                f"max_len {max_len} > compiled decoder length "
                f"{plan.live_len}: the graph bakes full-length constants "
                "(masks/position tables) that can't be extended")
        if not plan.info.get(self.logits_pt.guid, dec.AxisInfo()).is_live:
            raise NotImplementedError(
                "the graph output does not depend on the decode input")
        cdt = cache_dtype or self.compute_dtype or torch.float32
        static_pts = [pt for pt in self.input_pts
                      if pt.guid != plan.decode_pt.guid]

        # MHA classification: self-attention (live k/v -> per-op KV cache)
        # vs cross-attention (static k/v -> precomputed encoder K/V)
        mha_self, mha_cross = set(), set()
        for op in plan.live_ops:
            if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
                if plan.info.get(op.inputs[1].guid, dec.AxisInfo()).is_live:
                    mha_self.add(op.name)
                else:
                    mha_cross.add(op.name)

        # Baked constants, with batch-uniform leading axes collapsed to 1:
        # decode may run at another batch than compile (beam search runs
        # at num_beams), and a constant carrying the compiled batch whose
        # rows are all equal is exact as a broadcastable row. Made once,
        # so captured steps read stable tensors.
        consts = {}
        for guid, (pt, value) in self.constants.items():
            shape = tuple(pt.material_shape())
            if isinstance(value, np.ndarray):
                if (value.ndim >= 1 and value.shape[0] not in (1, batch)
                        and np.array_equal(value, np.broadcast_to(
                            value[:1], value.shape), equal_nan=True)):
                    value = value[:1]
            elif len(shape) >= 1 and shape[0] not in (1, batch):
                shape = (1,) + shape[1:]
            consts[guid] = _constant_tensor(pt, value, shape, self.device)

        def compute_statics(params, static_arrays):
            vals = dict(consts)
            for pt, arr in zip(static_pts, static_arrays):
                vals[pt.guid] = self._as_input(pt, arr)
            for op in plan.static_ops:
                ins = [vals[x.guid] for x in op.inputs]
                if op.is_parallel_op:
                    outs = parallel_ops.execute(op, ins)
                elif (op.op_type == OperatorType.OP_RESHAPE
                        and tuple(ins[0].shape)
                        != tuple(op.inputs[0].material_shape())):
                    # the reshape's params bake the compiled batch size;
                    # decode may run at another batch (beam search):
                    # recompute the batch axis
                    target = list(op.outputs[0].material_shape())
                    target[0] = -1
                    outs = [ins[0].reshape(target)]
                else:
                    outs = get_op_def(op.op_type).forward(
                        op.params, (params or {}).get(op.name, {}), ins,
                        self._ctx(op.name, weight_cache=self.weight_cache))
                for x, v in zip(op.outputs, outs):
                    vals[x.guid] = v
            return vals

        needs_params = bool(mha_cross) or any(
            op.weights for op in plan.static_ops)
        # static values whose ONLY live consumers are cross-attention k/v
        # slots are folded into the precomputed K/V -- keeping the raw
        # encoder hidden states in the cache would waste memory per layer
        cross_ops = [op for op in plan.live_ops if op.name in mha_cross]
        cross_kv_guids = {op.inputs[i].guid for op in cross_ops
                          for i in (1, 2)}
        other_uses = {op.inputs[0].guid for op in cross_ops}
        for op in plan.live_ops:
            if op.name not in mha_cross:
                other_uses.update(x.guid for x in op.inputs)
        static_kept = [g for g in plan.static_needed
                       if g not in cross_kv_guids or g in other_uses]

        def init_caches(params=None, static_inputs=()):
            if len(static_inputs) != len(static_pts):
                raise AssertionError(
                    f"need {len(static_pts)} static (non-decode) input "
                    f"arrays, got {len(static_inputs)}")
            if params is None and needs_params:
                raise AssertionError(
                    "this graph has encoder-side ops: call "
                    "init_caches(params, static_inputs)")
            caches = {"static": {}, "prefix": {}, "mha": {},
                      "mha_static": {}}
            # the zero-filled caches are ordinary tensors (the serving
            # loop writes them in place outside inference mode); the
            # statics are only ever read
            for g in plan.cached_guids:
                pt = produced[g]
                shape = list(pt.material_shape())
                shape[plan.info[g].live] = max_len
                if plan.info[g].live != 0:
                    shape[0] = batch  # decode batch, not compile batch
                caches["prefix"][g] = torch.zeros(
                    shape, dtype=pt.data_type.torch_dtype,
                    device=self.device)
            for op in plan.live_ops:
                if op.name in mha_self:
                    caches["mha"][op.name] = init_decode_cache(
                        op.params, batch, max_len, cdt, self.device)
            with torch.inference_mode():
                svals = compute_statics(params, static_inputs)
                caches["static"] = {g: svals[g] for g in static_kept}
                for op in cross_ops:
                    caches["mha_static"][op.name] = cross_decode_kv(
                        op.params, params.get(op.name, {}),
                        svals[op.inputs[1].guid], svals[op.inputs[2].guid],
                        self._ctx(op.name, weight_cache=self.weight_cache))
            return caches

        info = plan.info
        cached_set = set(plan.cached_guids)

        def walk(params, caches, t, tok):
            s0 = tok.shape[1]
            per_row_t = isinstance(t, torch.Tensor) and t.dim() == 1
            statics = caches["static"]
            vals = {plan.decode_pt.guid: tok}

            def get_static(g):
                return statics[g] if g in statics else consts[g]

            def aligned_input(x, out_rank, out_info, site):
                """A live op's input value: live tensors yield their
                current slice; static/constant operands are sliced where
                their full-length axes align with the live/prefix axes."""
                if x.guid in vals:
                    return vals[x.guid]
                full = get_static(x.guid)
                # the runtime shape, not the compiled tensor's: a
                # batch-collapsed constant differs on axis 0
                amap = dec._static_alignment(
                    tuple(full.shape), out_rank, out_info, plan.live_len)
                return dec._slice_aligned(full, amap, t, s0, max_len,
                                          out_rank=out_rank, site=site)

            for op in plan.live_ops:
                if op.is_parallel_op:
                    vals[op.outputs[0].guid] = vals[op.inputs[0].guid]
                    continue
                d = get_op_def(op.op_type)
                w = params.get(op.name, {})
                ot = op.op_type
                out_info = info.get(op.outputs[0].guid, dec.AxisInfo())
                ctx = self._ctx(op.name, weight_cache=self.weight_cache)
                if op.name in mha_self:
                    outs, caches["mha"][op.name] = d.forward_decode(
                        op.params, w, [vals[x.guid] for x in op.inputs],
                        ctx, caches["mha"][op.name], t)
                elif op.name in mha_cross:
                    outs = _forward_decode_cross(
                        op.params, w, vals[op.inputs[0].guid], ctx,
                        caches["mha_static"][op.name])
                elif ot == OperatorType.OP_BATCHMATMUL:
                    a_pt, b_pt = op.inputs
                    # the lhs may itself be static (live operand on the rhs)
                    a = (vals[a_pt.guid] if a_pt.guid in vals
                         else get_static(a_pt.guid))
                    if b_pt.guid in cached_set:
                        b = caches["prefix"][b_pt.guid]
                    elif info.get(b_pt.guid, dec.AxisInfo()).is_live:
                        b = vals[b_pt.guid]
                    else:
                        b = get_static(b_pt.guid)
                        a_info = info.get(a_pt.guid, dec.AxisInfo())
                        if a_info.prefix == len(a_pt.material_shape()) - 1:
                            # probs @ static V of compiled length: keep
                            # only the cap positions the cache covers
                            b = b.narrow(b.dim() - 2, 0, max_len)
                    outs = d.forward(op.params, w, [a, b], ctx)
                elif ot == OperatorType.OP_SOFTMAX:
                    x = vals[op.inputs[0].guid]
                    dim = op.params.dim % x.dim()
                    a_info = info[op.inputs[0].guid]
                    if a_info.prefix is not None and dim == a_info.prefix:
                        # attention row softmax over the prefix axis:
                        # inject the causality/validity mask (hides the
                        # cache's unwritten tail; for causal models this
                        # matches the graph's own mask)
                        if a_info.live is None:
                            raise NotImplementedError(
                                "prefix softmax without a live query axis")
                        kv = _iota(x, dim)
                        q = _iota(x, a_info.live)
                        if per_row_t:
                            if x.shape[0] != t.shape[0]:
                                raise NotImplementedError(
                                    f"per-row positions: attention scores "
                                    f"fold batch with another axis "
                                    f"(axis 0 is {x.shape[0]}, batch "
                                    f"{t.shape[0]})")
                            qp = t.to(torch.long).view(
                                (t.shape[0],) + (1,) * (x.dim() - 1)) + q
                        else:
                            qp = int(t) + q
                        x = torch.where(kv <= qp, x, dec.NEG_INF)
                    outs = [torch.softmax(x, dim=dim)]
                elif ot in (OperatorType.OP_RESHAPE, OperatorType.OP_FLAT):
                    x = vals[op.inputs[0].guid]
                    target = list(op.outputs[0].material_shape())
                    if out_info.live is not None:
                        target[out_info.live] = s0
                    if out_info.live != 0:
                        target[0] = -1  # batch may differ from compile
                    outs = [x.reshape(target)]
                else:
                    out_rank = len(op.outputs[0].material_shape())
                    outs = d.forward(op.params, w, [
                        aligned_input(x, out_rank, out_info, op.name)
                        for x in op.inputs], ctx)
                for x, v in zip(op.outputs, outs):
                    vals[x.guid] = v
                    if x.guid in cached_set:
                        _write_prefix(caches["prefix"][x.guid], v,
                                      info[x.guid].live, t, per_row_t, x.guid)
            return vals[self.logits_pt.guid]

        graphs = collections.OrderedDict()

        def replay(params, caches, t, tok):
            weights = [w for op in plan.live_ops
                       for w in params.get(op.name, {}).values()]
            gkey = (tuple(w.data_ptr() for w in weights),
                    tuple((x.data_ptr(), tuple(x.shape))
                          for x in _tensors(caches)),
                    tuple(np.shape(tok)))
            g = graphs.get(gkey) or _DecodeGraph(
                np.shape(tok), plan.decode_pt.data_type.torch_dtype,
                self.device, weights)
            g.tok.copy_(torch.as_tensor(tok))
            g.t.copy_(torch.as_tensor(t, dtype=torch.int32))
            # a replay runs no Python: weights that training moved since
            # are copied into the cached compute-dtype copies first
            self.weight_cache.refresh()
            if g.graph is None:
                g.capture(lambda: walk(params, caches, g.t, g.tok))
            _keep_recent(graphs, gkey, g)
            return g.graph.replay()

        @torch.inference_mode()
        def step(params, caches, t, batch_inputs, *, _eager=False):
            (tok,) = batch_inputs
            per_row = not isinstance(t, int) and np.ndim(t) == 1
            if per_row and len(t) != np.shape(tok)[0]:
                raise ValueError(f"per-row positions: {len(t)} positions "
                                 f"for {np.shape(tok)[0]} rows")
            if (per_row and not _eager and self.device.type == "cuda"
                    and np.shape(tok)[1] == 1):
                return replay(params, caches, t, tok), caches
            tok = self._as_input(plan.decode_pt, tok)
            if not isinstance(t, int):
                t = torch.as_tensor(t, dtype=torch.int32)
                # once, not once per layer
                t = int(t) if t.dim() == 0 else t.to(self.device)
            return walk(params, caches, t, tok), caches

        built = (init_caches, step)
        self._decode_builds[key] = built
        return built


def _iota(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Positions along `axis` of x, shaped to broadcast against x."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return torch.arange(x.shape[axis], device=x.device).view(shape)


def _write_prefix(cache: torch.Tensor, v: torch.Tensor, ax: int, t,
                  per_row_t: bool, guid: int) -> None:
    """Write a block's values `v` into a prefix cache in place at live axis
    `ax`, from position t (an int), or per row from t[i] (a (b,) tensor:
    a device-side scatter, no host sync, so the step captures)."""
    s0 = v.shape[ax]
    v = v.to(cache.dtype)
    if not per_row_t:
        cache.narrow(ax, t, s0).copy_(v)
        return
    if ax == 0 or cache.shape[0] != t.shape[0]:
        raise NotImplementedError(
            f"per-row positions: prefix cache guid {guid} has no "
            f"batch-leading axis (live axis {ax}, axis 0 {cache.shape[0]})")
    from .decode import _per_row_positions

    rows = torch.arange(t.shape[0], device=cache.device)[:, None]
    cache.movedim(ax, 1)[rows, _per_row_positions(t, s0)] = v.movedim(ax, 1)


class _ScanGraph:
    """The captured graph of N train steps for one (batch shapes, state)
    and its static buffers: device inputs, labels and seed table, and the
    pinned host buffers each chunk is staged in."""

    def __init__(self, ex: PCGExecutor, shapes, label_shape,
                 with_seeds: bool):
        self.ex = ex
        dev = ex.device
        dtypes = [pt.data_type.torch_dtype for pt in ex.input_pts]
        self.xs = [torch.empty(s, dtype=dt, device=dev)
                   for s, dt in zip(shapes, dtypes)]
        self.y = torch.empty(label_shape, dtype=ex.label_dtype, device=dev)
        n = label_shape[0]
        self.seeds = (torch.zeros((n, len(ex.compute_index), 2),
                                  dtype=torch.int32, device=dev)
                      if with_seeds else None)
        self.pinned = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                       for b in self.xs + [self.y]]
        self.pinned_seeds = (torch.empty(self.seeds.shape, dtype=torch.int32,
                                         pin_memory=True)
                             if with_seeds else None)
        # recorded after the last chunk's copies: the pinned buffers are
        # not rewritten before those copies have read them
        self.staged: Optional[torch.cuda.Event] = None
        self.graph = None

    def stage(self, stacked_inputs, stacked_labels, table) -> None:
        if self.staged is not None:
            self.staged.synchronize()
        for buf, rows in zip(self.pinned, list(stacked_inputs)
                             + [stacked_labels]):
            _stage_rows(buf, rows)
        for dev, host in zip(self.xs + [self.y], self.pinned):
            dev.copy_(host, non_blocking=True)
        if self.seeds is not None:
            self.pinned_seeds.copy_(table)
            self.seeds.copy_(self.pinned_seeds, non_blocking=True)
        self.staged = torch.cuda.Event()
        self.staged.record()

    def _steps(self, state, count: int):
        parts = [self.ex._train(
            state, [x[j] for x in self.xs], self.y[j],
            None if self.seeds is None else self.seeds[j])
            for j in range(count)]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def capture(self, state, tensors) -> None:
        from .graphs import CapturedGraph, warm_up

        # the warm-up is a real step: run it from a snapshot and put the
        # state back, so the scan's first replay starts where it should
        snapshot = [t.clone() for t in tensors]
        warm_up(lambda: self._steps(state, 1))
        with torch.no_grad():
            for t, s in zip(tensors, snapshot):
                t.copy_(s)
        del snapshot
        graph = CapturedGraph()
        graph.capture(lambda: self._steps(state, self.y.shape[0]))
        self.graph = graph


class _DecodeGraph:
    """The captured one-token decode step for one cache set and weight
    set, with its static token and position buffers. It holds the weights
    it was captured with: while they live, no other weight can take their
    addresses (the graph's key), and their cached compute-dtype copies,
    which the graph reads, stay where they are. Once other weights are
    served the graph is dropped (`_keep_recent`), and the retired weights
    with it. A cache set needs no such hold: caches at the key's addresses
    are the caches the graph reads."""

    def __init__(self, shape, dtype, device, weights):
        self.tok = torch.empty(shape, dtype=dtype, device=device)
        self.t = torch.empty((shape[0],), dtype=torch.int32, device=device)
        self.weights = weights
        self.graph = None

    def capture(self, fn) -> None:
        """Warm up (a real step: it writes the caches exactly as the
        replay after it rewrites them) and capture in the caller's thread
        (the continuous batcher's serving thread)."""
        from .graphs import CapturedGraph, warm_up

        warm_up(fn)
        graph = CapturedGraph()
        graph.capture(fn, capture_error_mode="thread_local")
        self.graph = graph
