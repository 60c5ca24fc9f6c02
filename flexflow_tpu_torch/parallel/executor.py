"""PCG executor: weights, the forward walk, the train step and the
serving decode step.

The PyTorch counterpart of flexflow_tpu/parallel/executor.py:
`init_params`/`init_state`, `apply`/`build_forward`, the training steps
(`build_train_step`, `build_grad_step`, `build_eval_step`) and
`build_decode`, with `compute_dtype` (bf16 compute over f32 master weights
under mixed precision) and `grad_dtype` (gradients rounded to bf16 before
the update, the JAX package's default under mixed precision).
`PCGExecutor` runs on one device; `MeshExecutor` runs the same walk as
one SPMD program over a device mesh of one process per device (see its
docstring). PyTorch runs eagerly, so the "built" functions
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
import contextlib
import dataclasses
import functools
import time
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.weak import WeakIdKeyDictionary

from ..core.initializers import get_initializer
from ..core.losses import get_loss_fn
from ..core.seeds import seed_table, step_seed
from ..ff_types import LossType, OperatorType, RegularizerMode
from ..ops.attention import init_decode_cache
from ..ops.common import WeightCache
from ..ops.registry import FwdCtx, get_op_def
from ..pcg.graph import Graph
from . import parallel_ops
from .mesh import distribute, full, is_dtensor, like, local, version

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
# the profiler ranges' stand-in when no profile is being taken
_NO_RANGE = contextlib.nullcontext()


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
    # a DTensor's norm is partial over its shards: each is reduced to the
    # norm of the global gradient
    return torch.linalg.vector_norm(torch.stack(
        [full(n) for n in torch._foreach_norm(leaves, 2,
                                               dtype=torch.float32)]))


class PCGExecutor:
    """Runs a PCG on one device."""

    # the device mesh (MeshExecutor); None: one device
    mesh = None
    # the generalized pipeline's stage plan (MeshExecutor on a "pipe"
    # axis without a block-stack op); None: the graph runs unpipelined
    pipeline_plan = None
    # the plan's GPipe ticks: the seed table holds one seed an op a tick
    _pipe_ticks = 1
    # the grad mode of the serving forward: no autograd record at all
    _serving_mode = torch.inference_mode

    def __init__(self, graph: Graph, device: torch.device, *,
                 optimizer=None, loss_type: Optional[LossType] = None,
                 metrics=None, compute_dtype: Optional[torch.dtype] = None,
                 grad_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 input_order: Optional[List] = None, remat: bool = False,
                 constants: Optional[Dict] = None,
                 overlap_grad_sync: bool = True, plan_cost_model=None):
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
        # extra per-step outputs in the partials (set_step_metrics; the
        # telemetry feed, e.g. "grad_norm")
        self.step_metrics: tuple = ()
        # torch.profiler ranges around each op of the walk and each phase
        # of the train step (set_profile_ranges): on only while the step
        # observatory traces a step, never inside a CUDA graph capture
        self._profile_ranges = False
        # serving's compute-dtype weight copies (ops/common.py)
        self.weight_cache = WeightCache()
        # one-token decode steps captured (`_DecodeGraph.capture`): a
        # capture's warm-up is a real step, so a caller that counts a
        # decode run's kernel launches reads this beside them
        self.decode_captures = 0
        # the overlapped gradient sync (set_overlap_grad_sync; inert on
        # one device) and its eligible weights, once computed
        self.overlap_grad_sync = bool(overlap_grad_sync)
        self._overlap_cache: Optional[Dict] = None
        # the cost oracle a pipeline plan cuts stages by (None: the
        # analytic roofline of the default machine)
        self._plan_cost_model = plan_cost_model
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
        """Fresh weights, their optimizer slots (made from `_owned`, so
        on a mesh the overlap-eligible weights' slots live sharded:
        ZeRO-1) and the stateful ops' buffers."""
        params = self.init_params()
        opt_state = (self.optimizer.init_state(self._owned(params))
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

    def set_step_metrics(self, names) -> None:
        """Request extra per-step outputs in the metric partials (the
        obs telemetry feed). Supported: ``"grad_norm"`` — the global
        gradient norm, already present whenever the step guard is armed,
        computed on demand otherwise. A change drops the captured train
        scans: they were captured without it."""
        names = tuple(names or ())
        unknown = [n for n in names if n != "grad_norm"]
        if unknown:
            raise ValueError(f"unsupported step metrics: {unknown}")
        if names != self.step_metrics:
            self.step_metrics = names
            self._scan_graphs.clear()

    def set_profile_ranges(self, on: bool) -> None:
        """Open a torch.profiler range around each op of the walk (its
        name; the backward of its autograd nodes is linked to it by the
        profiler's sequence numbers) and around the train step's other
        phases ("inputs", "loss", "metrics", "grad_cast", "optimizer"),
        so a device trace attributes every kernel (obs/step_profile.py
        "cuda_trace"). Off by default: the hot paths open no range."""
        if on and self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("profiler ranges inside a CUDA graph capture")
        self._profile_ranges = bool(on)

    def _range(self, name: str):
        """The profiler range `name` while ranges are on, else a no-op."""
        if self._profile_ranges:
            return torch.profiler.record_function(name)
        return _NO_RANGE

    # -- the overlapped gradient sync ------------------------------------
    def set_overlap_grad_sync(self, flag: bool) -> None:
        """Enable/disable the reduce-scatter + sharded-update + all-gather
        step (MeshExecutor; the reference's overlap_backward_update). A
        change drops the eligible weights found so far and the captured
        train scans: they were built for the other step."""
        flag = bool(flag)
        if flag != self.overlap_grad_sync:
            self.overlap_grad_sync = flag
            self._overlap_cache = None
            self._scan_graphs.clear()

    def _overlap_specs(self) -> Dict:
        """(op name, weight name) -> (its owned-shard placements, the
        dim it shards) of every weight the overlapped step updates on
        owned shards (MeshExecutor). None on one device: there is no data
        axis."""
        return {}

    def overlap_schedule(self):
        """Schedule-introspection hook of the static analyzer
        (analysis/schedule.py): the per-weight task chains of the
        overlapped step this executor runs (backward -> reduce-scatter of
        the gradient -> update of the owned shard -> all-gather of the
        updated weight), for the FFA502 race detector. None where the
        overlapped path is off or inert (no weight eligible, as at data
        degree 1), as the JAX executor returns."""
        from ..analysis.schedule import build_overlap_schedule

        omap = self._overlap_specs()
        if not omap:
            return None
        return build_overlap_schedule(self.graph, set(omap))

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

    def reset_step_duration(self) -> None:
        """Forget the measured step time (a swapped-in strategy starts
        its own EMA)."""
        self._step_dur_ema = None

    def mesh_is_live(self) -> bool:
        """Whether every device this executor runs on is still in the
        live world (runtime/elastic.py): the plain executor's one device
        always is."""
        return True

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
                      weight_cache=weight_cache, aux_losses=aux_losses,
                      profile_ranges=self._profile_ranges, mesh=self.mesh,
                      n_devices=1 if self.mesh is None else self.mesh.size)

    def seed_table(self, step_seeds) -> torch.Tensor:
        """The (N, n_ops * ticks, 2) int32 CPU seed table of N steps'
        seeds (core/seeds.py; ticks: the pipeline plan's, else 1)."""
        return seed_table(step_seeds, self.drawing_ops,
                          len(self.compute_index), self._pipe_ticks)

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

    def place_param(self, wpt, value) -> torch.Tensor:
        """A whole weight (an array or tensor) as this executor holds
        tensor `wpt`: on its device in its dtype (MeshExecutor: this
        rank's shard of it)."""
        return torch.as_tensor(value, dtype=wpt.data_type.torch_dtype,
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
        if self.pipeline_plan is not None:
            if seq_length >= 0:
                raise NotImplementedError(
                    "per-iteration seq_length truncation changes the cut "
                    "tensor shapes and is not supported with the "
                    "generalized pipeline (pipeline_parallel_degree > 1 on "
                    "a non-block-stack graph)")
            # the GPipe schedule over the stage-partitioned graph; only
            # the output comes back (stage internals live per rank)
            return self._apply_pipelined(params, inputs, training=training,
                                         row=row)
        drawing = set(self.drawing_ops) if row is not None else ()
        vals = dict(inputs)
        vals.update(self._const_vals)
        for op in self.topo:
            ins = [vals[t.guid] for t in op.inputs]
            if op.is_parallel_op:
                for t, o in zip(op.outputs, self._parallel_op(op, ins)):
                    vals[t.guid] = self._constrain(o, t)
                continue
            compute_idx = self.compute_index[op.guid]
            opdef = get_op_def(op.op_type)
            ctx = self._ctx(op.name, training,
                            row[compute_idx] if compute_idx in drawing
                            else None, seq_length, weight_cache, aux_out)
            w = self._op_weights(op, params.get(op.name, {}))
            with self._range(op.name):
                outs = self._op_forward(op, opdef, w, ins, ctx, training,
                                        net_state, net_out)
            for t, o in zip(op.outputs, outs):
                vals[t.guid] = self._constrain(o, t)
        return vals

    def _constrain(self, val, pt):
        """The value of tensor `pt` as the strategy places it: on one
        device, as it is (MeshExecutor redistributes)."""
        return val

    # -- the generalized pipeline --------------------------------------------
    def _plan_pcg_pipeline(self, n_stages: int):
        """Partition the compute graph into `n_stages` contiguous stages
        balanced by op cost (the JAX package's `_plan_pcg_pipeline`: "the
        search proposes the cut"), and describe each cut's boundary
        tensors. None, with JAX's warning, where the graph cannot be
        pipelined exactly (it then runs unpipelined)."""
        from ..search.cost_model import op_bytes, op_flops
        from ..search.machine_model import MachineModel
        from .pipeline import PcgPipelinePlan, balanced_linear_partition

        ops = [o for o in self.topo if not o.is_parallel_op]
        if len(ops) < n_stages:
            warnings.warn("pipeline: fewer compute ops than stages — "
                          "running unpipelined")
            return None
        for op in ops:
            d = get_op_def(op.op_type)
            if d.state_spec is not None or op.op_type in (
                    OperatorType.OP_GROUP_BY, OperatorType.OP_AGGREGATE,
                    OperatorType.OP_AGG_SPEC, OperatorType.OP_CACHE):
                warnings.warn(
                    f"pipeline: {op.op_type.name} (stateful/aux-loss op) "
                    "can't cross the GPipe schedule — running unpipelined")
                return None
        if self._plan_cost_model is not None:
            from ..pcg.machine_view import MachineView

            v1 = MachineView(start_device_id=0, dim=(1,), stride=(1,))
            costs = [self._plan_cost_model.measure_operator_cost(
                o, v1).total_time for o in ops]
        else:
            machine = MachineModel()
            costs = [machine.compute_cost(op_flops(o), op_bytes(o))
                     for o in ops]
        bounds = balanced_linear_partition(costs, n_stages)
        stages = [ops[bounds[i]:bounds[i + 1]]
                  for i in range(len(bounds) - 1)]
        stages = [st for st in stages if st]
        if len(stages) < n_stages:
            warnings.warn("pipeline: degenerate stage partition — "
                          "running unpipelined")
            return None
        stage_of = {o.guid: si for si, sops in enumerate(stages)
                    for o in sops}
        # parallel ops (degree bookkeeping) are the identity on local
        # values: their outputs resolve to the producing compute tensor
        alias: Dict[int, int] = {}
        for op in self.topo:
            if op.is_parallel_op:
                src = alias.get(op.inputs[0].guid, op.inputs[0].guid)
                for t in op.outputs:
                    alias[t.guid] = src

        def resolve(g):
            return alias.get(g, g)

        # graph inputs all enter at stage 0 (they are injected there)
        input_guids = {p.guid for p in self.input_pts}
        for op in ops:
            for t in op.inputs:
                if resolve(t.guid) in input_guids \
                        and stage_of[op.guid] != 0:
                    warnings.warn(
                        "pipeline: a graph input is consumed past stage 0 "
                        "— running unpipelined")
                    return None
        batch = self.input_pts[0].material_shape()[0]
        consumers_stage: Dict[int, int] = {}
        for op in ops:
            for t in op.inputs:
                g = resolve(t.guid)
                consumers_stage[g] = max(consumers_stage.get(g, -1),
                                         stage_of[op.guid])
        cuts = []
        buf_elems = 0
        for si in range(len(stages) - 1):
            cut, total = [], 0
            for op in ops:
                if stage_of[op.guid] > si:
                    continue
                for t in op.outputs:
                    if consumers_stage.get(t.guid, -1) <= si:
                        continue
                    shape = tuple(t.material_shape())
                    if not shape or shape[0] != batch:
                        warnings.warn(
                            "pipeline: a cut tensor is not batch-leading "
                            "— running unpipelined")
                        return None
                    if not t.data_type.torch_dtype.is_floating_point:
                        warnings.warn(
                            "pipeline: non-float cut tensor — running "
                            "unpipelined")
                        return None
                    cut.append((t.guid, shape[1:],
                                t.data_type.torch_dtype))
                    total += int(np.prod(shape[1:], dtype=np.int64))
            cuts.append(cut)
            buf_elems = max(buf_elems, total)
        out_pt = self.logits_pt
        return PcgPipelinePlan(
            stages=stages, cuts=cuts, buf_elems=buf_elems,
            out_guid=resolve(out_pt.guid),
            out_shape=tuple(out_pt.material_shape()),
            out_dtype=out_pt.data_type.torch_dtype,
            n_stages=len(stages), alias=alias)

    def _pipeline_stage_runners(self, training: bool, row) -> list:
        """One runner a stage, `run(params, vals, tick) -> vals`: that
        stage's ops as `apply` walks them, on local values with no mesh
        (the JAX package's runners run inside shard_map with mesh=None).
        In training an op that draws reads its seed for this tick from
        `row` (`seed_table`: every (op, tick) draws its own masks, so no
        two micro-batches share one)."""
        alias = self.pipeline_plan.alias
        ticks = self._pipe_ticks
        drawing = set(self.drawing_ops) if row is not None else ()
        consts = {g: local(v) for g, v in self._const_vals.items()}

        def make_runner(sops):
            def run(params, vals, tick):
                vals = dict(vals)
                for op in sops:
                    d = get_op_def(op.op_type)
                    ins = []
                    for t in op.inputs:
                        g = alias.get(t.guid, t.guid)
                        ins.append(vals[g] if g in vals else consts[g])
                    i = self.compute_index[op.guid]
                    ctx = FwdCtx(
                        training=training, compute_dtype=self.compute_dtype,
                        op_name=op.name,
                        rng=row[i * ticks + tick] if i in drawing else None,
                        profile_ranges=self._profile_ranges)
                    outs = d.forward(op.params, params.get(op.name, {}),
                                     ins, ctx)
                    for t, v in zip(op.outputs, outs):
                        vals[t.guid] = v
                return vals
            return run

        return [make_runner(st) for st in self.pipeline_plan.stages]

    def _apply_pipelined(self, params, inputs: Dict[int, torch.Tensor], *,
                         training: bool, row) -> Dict[int, torch.Tensor]:
        """The forward through the generalized GPipe schedule
        (parallel/pipeline.py `gpipe_pcg`; the weights replicated over
        the pipe axis): {output guid: value}."""
        from .pipeline import gpipe_pcg

        plan = self.pipeline_plan
        guids = [pt.guid for pt in self.input_pts]
        out = gpipe_pcg(plan, self._pipeline_stage_runners(training, row),
                        params, [inputs[g] for g in guids], guids,
                        self.mesh)
        return {plan.out_guid: out, self.logits_pt.guid: out}

    def _parallel_op(self, op, ins) -> list:
        """A parallel op's outputs (parallel/parallel_ops.py)."""
        return parallel_ops.execute(op, ins, self.mesh)

    def _op_weights(self, op, w):
        """The weights op `op` reads: on one device, as they are
        (MeshExecutor gathers the fsdp-sharded ones)."""
        return w

    def _op_forward(self, op, opdef, w, ins, ctx, training, net_state,
                    net_out):
        """One compute op of the walk (`apply`): its outputs."""
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
        return outs

    def build_forward(self, seq_length: int = -1) -> Callable:
        """fwd(params, batch_inputs, net_state=None) -> the graph output.
        Ops read their compute-dtype weights from the executor's weight
        cache, and stateful ops their buffers from `net_state` (none:
        batch statistics). `seq_length` >= 0 reaches the ops' context
        (JAX: the iteration config's seq_length; batch_matmul slices its
        a/b_seq_length_dim axes to it)."""

        def fwd(params, batch_inputs, net_state=None):
            with self._serving_mode():
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

    def _watch_leaves(self, names, leaves) -> None:
        """Called with the autograd leaves of a training forward, before
        it runs: on one device nothing (MeshExecutor hooks the overlapped
        sync onto them)."""

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
        self._watch_leaves(names, flat)
        aux: list = []
        with self._range("inputs"):
            inputs = self._input_vals(batch_inputs)
        with torch.enable_grad():
            vals = self.apply(leaves, inputs,
                              training=True, rng=rng, seq_length=seq_length,
                              net_state=net_state, net_out=net_out,
                              aux_out=aux)
            logits = vals[self.logits_pt.guid]
            with self._range("loss"):
                loss = self.loss_fn(logits, truncate_labels(labels, logits))
                for a in aux:
                    loss = loss + a
                for r in self._reg_penalty(leaves):
                    loss = loss + r
                if loss_scale is not None:
                    scaled = loss * loss_scale
            gs = torch.autograd.grad(
                loss if loss_scale is None else scaled, flat,
                allow_unused=True)
        with self._range("grad_cast"):
            grads: Params = {}
            for (op, n), w, g in zip(names, flat, gs):
                grads.setdefault(op, {})[n] = (torch.zeros_like(w)
                                               if g is None else g)
            grads = self._cast_grads(grads)
        return loss.detach(), logits.detach(), grads

    def _reg_penalty(self, params: Params) -> List[torch.Tensor]:
        """The dense kernels' regularizer terms that join the training
        loss, as the JAX package computes them: lambda * sum|w| for L1,
        lambda / 2 * sum w^2 for L2 (whose gradient lambda * w is the
        reference's linear_kernels.cu:333-350 grad += lambda * w), in f32."""
        terms = []
        for op in self.topo:
            lam = getattr(op.params, "kernel_reg_lambda", 0.0)
            if not lam:
                continue
            w = params.get(op.name, {}).get("kernel")
            if w is None:
                continue
            wf = w.float()
            if op.params.kernel_reg_type == RegularizerMode.REG_MODE_L1:
                terms.append(lam * wf.abs().sum())
            else:
                terms.append(0.5 * lam * (wf * wf).sum())
        return terms

    def invalidate_step_cache(self) -> None:
        """Drop the captured train scans, so the next scan captures afresh
        (the JAX package drops its jitted steps): a captured update holds
        the optimizer's hyperparameters, the learning rate among them, as
        the constants it was captured with. The eager step reads them at
        each call; the forward and decode captures read none."""
        self._scan_graphs.clear()

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
        finite = gnorm = None
        with self._range("optimizer"):
            if guard is None:
                if "grad_norm" in self.step_metrics:
                    # the telemetry feed (set_step_metrics): the guard
                    # path always computes it; here it is opt-in
                    with torch.no_grad():
                        gnorm = global_grad_norm(grads).to(self.device)
                self.update_weights(state, grads)
            else:
                finite, gnorm = self._guarded_update(state, grads, poison)
            with torch.no_grad():
                for op, bufs in net_out.items():
                    for k, v in bufs.items():
                        state.net_state[op][k].copy_(v)
        with torch.no_grad(), self._range("metrics"):
            partials = self.metrics.compute(logits, labels)
        partials["loss"] = loss
        if finite is None and gnorm is not None:
            partials["grad_norm"] = gnorm
        if finite is not None:
            # skipped steps contribute nothing to epoch metrics (their
            # logits/loss are NaN — summing would poison the epoch)
            partials = {k: torch.where(finite, v, torch.zeros_like(v))
                        for k, v in partials.items()}
            partials["skipped"] = 1.0 - finite.to(torch.float32)
            partials["grad_norm"] = torch.where(finite, gnorm, 0.0)
        return partials

    def update_weights(self, state: TrainState, grads: Params) -> None:
        """The optimizer's in-place update of state's weights and slots
        from `grads` (the train step's and the stepwise `update`'s).
        MeshExecutor updates the shards each rank owns under the
        overlapped sync and then gathers the updated weights."""
        self._update_shards(state, grads)
        self._gather_updated(state.params)

    def _update_shards(self, state: TrainState, grads: Params) -> None:
        self.optimizer.update(self._owned(state.params), grads,
                              state.opt_state)

    def _owned(self, tree: Params) -> Params:
        """The weights each rank updates: on one device all of `tree`
        (MeshExecutor: the slices it owns under the overlapped sync)."""
        return tree

    def _gather_updated(self, params: Params) -> None:
        """After `_update_shards`: nothing on one device."""

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
        # step is bound by the host's launches. On a mesh they act on
        # each rank's shards
        flat = [local(t) for t in _tensors(grads)]
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
        live = [local(t) for t in _tensors((state.params, state.opt_state))]
        kept = [torch.empty_like(t) for t in live]
        torch._foreach_copy_(kept, live)
        self._update_shards(state, grads)
        for t, old in zip(live, kept):
            torch.where(finite, t, old, out=t)
        self._gather_updated(state.params)
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
            with self._range("inputs"):
                labels = self._as_labels(labels)
            partials = self._train(state, batch_inputs, labels,
                                   step_seed(rng), poison)
            return dataclasses.replace(state, step=state.step + 1), partials

        return step

    def time_train_step(self, state: TrainState, batch_inputs, labels,
                        rng=0, *, repeats: int = 3, warmup: int = 1) -> float:
        """Wall-clock the REAL eager training step (the step
        observatory's in-situ probe, obs/step_profile.py): mean seconds
        per step over `repeats` timed runs after `warmup` untimed ones,
        each run synchronized with the device. The optimizers update in
        place, so the weights, optimizer buffers, stateful buffers and
        guard counters are snapshotted first and written back after:
        the caller's state (and the model's live params) leave the
        measurement bit for bit as they were. `rng` is the steps' seed
        (an int, 0 by default as the JAX package's PRNGKey(0)): the
        model's own seed generator is not drawn from."""
        step = self.build_train_step()
        kept = self.snapshot_state(state)
        try:
            for _ in range(max(1, warmup)):
                step(state, batch_inputs, labels, rng)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(max(1, repeats)):
                step(state, batch_inputs, labels, rng)
            self._sync()
            return (time.perf_counter() - t0) / max(1, repeats)
        finally:
            self.restore_state(state, kept)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _state_tensors(state: TrainState) -> List[torch.Tensor]:
        """Every tensor of the state, each rank's shard of a DTensor."""
        return [local(t) for t in _tensors(
            (state.params, state.opt_state, state.net_state,
             state.guard.as_dict() if state.guard is not None else {}))]

    def snapshot_state(self, state: TrainState) -> List[torch.Tensor]:
        """Copies of every tensor a train step updates in place (weights,
        optimizer buffers, stateful buffers, guard counters), for
        `restore_state`."""
        live = self._state_tensors(state)
        kept = [torch.empty_like(t) for t in live]
        if live:
            torch._foreach_copy_(kept, live)
        return kept

    @torch.no_grad()
    def restore_state(self, state: TrainState, kept) -> None:
        """Write a `snapshot_state` back into the live tensors, in place
        (the addresses captured graphs and the serving weight cache hold
        stay valid)."""
        live = self._state_tensors(state)
        if live:
            torch._foreach_copy_(live, kept)

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
        # each rank's shard of a DTensor: what the graph reads and writes
        tensors = [local(t) for t in _tensors(
            (state.params, state.opt_state, state.net_state))]
        key = (tuple(t.data_ptr() for t in tensors), shapes, label_shape,
               table is None)
        g = self._scan_graphs.get(key) or _ScanGraph(
            self, shapes, label_shape, table is not None)
        g.stage(stacked_inputs, stacked_labels, table)
        if g.graph is None:
            g.capture(state, tensors)
        _keep_recent(self._scan_graphs, key, g)
        out = {k: v.clone() for k, v in g.graph.replay().items()}
        self._add_counters(g.counters)
        _mark_moved(state.params)
        return out

    def _counters(self) -> collections.Counter:
        """The executor's running counts that a replayed graph's launches
        would advance if they ran eagerly (MeshExecutor: its collectives
        and gradient syncs); none on one device."""
        return collections.Counter()

    def _add_counters(self, delta: collections.Counter,
                      times: int = 1) -> None:
        """Advance the counts of `_counters` by `times` a replay's
        `delta`."""

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
    # -- the decode step's hooks (MeshExecutor places them on its mesh) --
    def _decode_params(self, params):
        """The weights the decode step reads."""
        return params

    def _decode_input(self, pt, array) -> torch.Tensor:
        """A decode step's input value (a token block, a static input)."""
        return self._as_input(pt, array)

    def _decode_whole(self, t):
        """A value every rank holds whole (a constant, a static, a prefix
        cache)."""
        return t

    def _decode_reduce(self, pt, v):
        """Value `v` of op output `pt` as the walk passes it on."""
        return v

    def _decode_result(self, logits):
        """The step's logits as the caller reads them."""
        return logits

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
            consts[guid] = self._decode_whole(
                _constant_tensor(pt, value, shape, self.device))

        def compute_statics(params, static_arrays):
            vals = dict(consts)
            for pt, arr in zip(static_pts, static_arrays):
                vals[pt.guid] = self._decode_input(pt, arr)
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
                caches["prefix"][g] = self._decode_whole(torch.zeros(
                    shape, dtype=pt.data_type.torch_dtype,
                    device=self.device))
            for op in plan.live_ops:
                if op.name in mha_self:
                    caches["mha"][op.name] = init_decode_cache(
                        op.params, batch, max_len, cdt, self.device,
                        mesh=self.mesh)
            params = self._decode_params(params)
            with torch.inference_mode():
                svals = compute_statics(params, static_inputs)
                caches["static"] = {g: self._decode_whole(svals[g])
                                    for g in static_kept}
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
                # a mesh holds statics whole (`_decode_whole`): sliced
                # on each rank's whole copy
                return like(dec._slice_aligned(
                    local(full), amap, t, s0, max_len, out_rank=out_rank,
                    site=site), full)

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
                        kv = like(_iota(x, dim), x)
                        q = like(_iota(x, a_info.live), x)
                        if per_row_t:
                            if x.shape[0] != t.shape[0]:
                                raise NotImplementedError(
                                    f"per-row positions: attention scores "
                                    f"fold batch with another axis "
                                    f"(axis 0 is {x.shape[0]}, batch "
                                    f"{t.shape[0]})")
                            qp = like(t.to(torch.long).view(
                                (t.shape[0],) + (1,) * (x.dim() - 1)), x) + q
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
                    v = vals[x.guid] = self._decode_reduce(x, v)
                    if x.guid in cached_set:
                        _write_prefix(local(caches["prefix"][x.guid]),
                                      local(self._decode_whole(v)),
                                      info[x.guid].live, t, per_row_t, x.guid)
            return self._decode_result(vals[self.logits_pt.guid])

        graphs = collections.OrderedDict()

        def replay(params, caches, t, tok):
            weights = [w for op in plan.live_ops
                       for w in params.get(op.name, {}).values()]
            gkey = (tuple(_data_ptr(w) for w in weights),
                    tuple((_data_ptr(x), tuple(x.shape))
                          for x in _tensors(caches)),
                    tuple(np.shape(tok)))
            g = graphs.get(gkey) or _DecodeGraph(
                self, np.shape(tok), plan.decode_pt.data_type.torch_dtype,
                weights)
            g.tok.copy_(torch.as_tensor(tok))
            g.t.copy_(torch.as_tensor(t, dtype=torch.int32))
            # a replay runs no Python: weights that training moved since
            # are copied into the cached compute-dtype copies first
            self.weight_cache.refresh()
            if g.graph is None:
                g.capture(lambda: walk(params, caches, g.t, self._decode_input(
                    plan.decode_pt, g.tok)))
            _keep_recent(graphs, gkey, g)
            return g.replay()

        @torch.inference_mode()
        def step(params, caches, t, batch_inputs, *, _eager=False):
            (tok,) = batch_inputs
            per_row = not isinstance(t, int) and np.ndim(t) == 1
            if per_row and len(t) != np.shape(tok)[0]:
                raise ValueError(f"per-row positions: {len(t)} positions "
                                 f"for {np.shape(tok)[0]} rows")
            params = self._decode_params(params)
            if (per_row and not _eager and self.device.type == "cuda"
                    and np.shape(tok)[1] == 1):
                return replay(params, caches, t, tok), caches
            tok = self._decode_input(plan.decode_pt, tok)
            if not isinstance(t, int):
                t = torch.as_tensor(t, dtype=torch.int32)
                # once, not once per layer
                t = int(t) if t.dim() == 0 else t.to(self.device)
            return walk(params, caches, t, tok), caches

        built = (init_caches, step)
        self._decode_builds[key] = built
        return built


def _data_ptr(t) -> int:
    """The address of a tensor's data, a DTensor's local shard's (read
    without `to_local`'s autograd call: the decode step's graph key reads
    every weight's and cache's at every step)."""
    return (t._local_tensor if is_dtensor(t) else t).data_ptr()


def _waited(g):
    """DTensor `g` whose local tensor an async collective is still
    writing (`redistribute(..., async_op=True)`), once it has finished."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor

    loc = g._local_tensor
    if not isinstance(loc, AsyncCollectiveTensor):
        return g
    return DTensor.from_local(loc.wait(), g.device_mesh, g.placements,
                              run_check=False)


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
        self.seeds = (torch.zeros((n, len(ex.compute_index)
                                   * ex._pipe_ticks, 2),
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
        self.counters: collections.Counter = collections.Counter()

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
        # the executor places each step's rows as its eager step does
        # (MeshExecutor: sharded from the static buffers, in the graph)
        parts = [self.ex._train(
            state, [x[j] for x in self.xs], self.ex._as_labels(self.y[j]),
            None if self.seeds is None else self.seeds[j])
            for j in range(count)]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def capture(self, state, tensors) -> None:
        """Warm up, then capture the N steps. `tensors` are the state's
        local tensors. The executor's counts that the capture advanced
        are what each replay adds (`counters`)."""
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
        before = self.ex._counters()
        try:
            graph.capture(lambda: self._steps(state, self.y.shape[0]))
        except RuntimeError as e:
            mesh = self.ex.mesh
            if mesh is not None and mesh.shape.get("pipe", 1) > 1:
                raise RuntimeError(
                    "the train scan over a pipe axis of "
                    f"{mesh.shape['pipe']} captures the GPipe schedule's "
                    "NCCL hops (all-to-alls) in its CUDA graph, and this "
                    f"capture failed ({e}); fit stepwise "
                    "(iterations_per_dispatch=1)") from e
            raise
        # a capture runs no step: take its counts back out
        self.counters = self.ex._counters() - before
        self.ex._add_counters(self.counters, -1)
        self.graph = graph
        self.ex.decode_captures += 1


class _DecodeGraph:
    """The captured one-token decode step for one cache set and weight
    set, with its static token and position buffers. It holds the weights
    it was captured with: while they live, no other weight can take their
    addresses (the graph's key), and their cached compute-dtype copies,
    which the graph reads, stay where they are. Once other weights are
    served the graph is dropped (`_keep_recent`), and the retired weights
    with it. A cache set needs no such hold: caches at the key's addresses
    are the caches the graph reads."""

    def __init__(self, ex, shape, dtype, weights):
        self.ex = ex
        self.tok = torch.empty(shape, dtype=dtype, device=ex.device)
        self.t = torch.empty((shape[0],), dtype=torch.int32,
                             device=ex.device)
        self.weights = weights
        self.graph = None
        # the executor's counters (a mesh's collectives) one replay adds
        self.counters: collections.Counter = collections.Counter()

    def capture(self, fn) -> None:
        """Warm up (a real step: it writes the caches exactly as the
        replay after it rewrites them) and capture in the caller's thread
        (the continuous batcher's serving thread). A capture runs no
        step: what it counted on the executor is taken back out, and
        each replay adds it (`replay`)."""
        from .graphs import CapturedGraph, warm_up

        warm_up(fn)
        graph = CapturedGraph()
        before = self.ex._counters()
        graph.capture(fn, capture_error_mode="thread_local")
        self.counters = self.ex._counters() - before
        self.ex._add_counters(self.counters, -1)
        self.graph = graph

    def replay(self):
        self.ex._add_counters(self.counters)
        return self.graph.replay()


class MeshExecutor(PCGExecutor):
    """Runs a PCG as one SPMD program over a device mesh (parallel/
    mesh.py Mesh: one process per device, NCCL on cards, gloo on the
    CPU), the JAX package's PCGExecutor on a mesh.

    Every value of the walk is a DTensor holding the GLOBAL array, so an
    op computes what it computes on one device and DTensor's sharding
    propagation inserts the collectives (the JAX package's GSPMD):
    a data-parallel BatchNorm takes the statistics of the whole batch, a
    row-parallel contraction comes out `Partial` and is summed where the
    graph asks for it. `init_params` draws every weight whole from the
    same CPU generator on every rank, exactly as PCGExecutor does, and
    each rank keeps its shard (the draws do not depend on the mesh).
    Every ParallelTensor with a sharded dim is redistributed to its
    placements (`_constrain`, JAX's with_sharding_constraint), the
    parallel ops redistribute to theirs (parallel/parallel_ops.py), the
    batch inputs and the labels are sharded from the global batch that
    every rank passes, and each weight's gradient is redistributed to
    the weight's placement once a step: the gradient all-reduce of a
    replicated weight (`grad_syncs` counts the redistributes that run: a
    gradient that comes out placed as its weight is needs none). Loss,
    metric partials, the forward's output and the eval step's logits
    are replicated whole on every rank before the host can read them.
    The optimizers, the step guard (on the global gradient norm) and
    snapshot/restore act on DTensors or each rank's shards.

    The train scan (`build_train_scan`, fit's `iterations_per_dispatch`)
    runs PCGExecutor's contract over the mesh: each step's rows of the
    stacked global batch are sharded as `_input_vals` and `_as_labels`
    shard a single step's, and the partials come back whole, (N,) a key.
    Off the card it is the loop over the eager step. On the card the N
    steps are one CUDA graph: DTensor's dispatch runs once, at capture,
    and the graph holds the per-shard kernels, the NCCL collectives of
    the data, tensor, sequence, expert and fsdp axes, and the overlapped
    sync's reduce-scatters, waits, owned-slice updates and all-gathers;
    the static input buffers are sharded inside the graph on every
    replay. A replay adds the collectives and syncs its capture counted.
    A capture that fails raises.

    FSDP/ZeRO (an "fsdp" mesh axis: `FFConfig.fsdp_degree`, or a searched
    winner's WeightShard nodes): a target weight lives `Shard(d)` over
    "fsdp" and is gathered where its op reads it (`_op_weights`: an
    explicit redistribute to its placement without "fsdp", so DTensor
    never moves the activation instead); the backward of that
    redistribute is the gradient's reduce-scatter onto the shard, and
    the optimizer slots, made by `zeros_like`, inherit the sharding.

    The overlapped gradient sync (`overlap_grad_sync`, on by default, the
    JAX package's): a weight with no data or fsdp placement and a dim
    that the data size divides (`_overlap_specs`) has its gradient
    reduce-scattered over "data" from a hook on its autograd leaf, an
    async collective issued while the backward still runs, so NCCL
    reduces layer i's gradient under layer i-1's backward kernels; it is
    waited on after the backward. The optimizer then updates the 1/d
    slice of the weight each rank owns (a `Shard` view of its local
    tensor, no traffic) with slots that live sharded from `init_state` on
    (ZeRO-1), and the updated slices are all-gathered back into the
    weight. The values are the all-reduce step's.

    Pipeline parallelism (a "pipe" mesh axis): a block-stack op
    (ops/pipeline.py) runs the GPipe schedule over its layers, Shard(0)
    over "pipe"; any other graph is cut into stages (`pipeline_plan`,
    the JAX package's `_plan_pcg_pipeline`) and `apply` runs them as
    the schedule (`_apply_pipelined`, parallel/pipeline.py gpipe_pcg),
    each rank its stage's ops on local values, the weights whole on
    every rank and their gradients summed over data and pipe by the
    step's sync. A seed-table row holds a seed an (op, tick), so each
    micro-batch draws its own dropout masks. The train scan over a pipe
    axis captures the schedule's NCCL hops in its graph;
    a capture that fails raises, naming them.

    `collectives` counts the collectives that run, by "<what>/<kind>/
    <axis>": "grad" (a gradient's sync), "weight" (an fsdp weight gathered
    on use), "param" (an updated weight gathered after the sharded
    update) and "act" (the expert dispatch's all-to-all), each an
    "all_reduce", "reduce_scatter", "all_gather" or "all_to_all" over a
    mesh axis; `grad_syncs` counts the gradient syncs (at most one a
    weight a step).

    No op is gathered behind its back: an op that builds a plain tensor
    over the global shape (a dropout mask, the MoE dispatch mask) wraps
    it as a replicated DTensor itself (parallel/mesh.py `like`), and the
    ops that DTensor has no rule for in some torch release (var_mean in
    LayerNorm and BatchNorm, pooling, a strided padded convolution,
    top_k's sort) run on local shards through `per_shard`, as
    attention's kernels and chunked path run through `local_map`; an op
    DTensor refuses otherwise raises.

    The decode step (`build_decode`, PCGExecutor's) runs over the mesh at
    the strategy's degrees, as the JAX package runs its device-local
    decode under GSPMD: the weights at this executor's placements
    (`_decode_params`), every value of the walk a DTensor, each
    self-attention op's KV cache a DTensor of per-rank strips (slots over
    "data" where the batch divides it, heads over "model";
    ops/attention.py `decode_cache_placements`) that its per-shard step
    (`_forward_decode_mesh`: the paged-decode kernel on the local strips
    on the card) writes in place and that no collective moves. Each op's
    output is made whole but for its batch rows (`_decode_reduce`; a
    column-sharded output that only row-sharded dense kernels read stays
    sharded, `_row_fed`), so the sharded weights compute locally and
    every collective of a step
    is counted in `collectives`: "act/..." (a partial sum reduced, a
    column-sharded output gathered), "out/..." (the logits gathered whole
    on every rank) and "kv/..." (a constant, static or prefix cache,
    attention from primitive ops, that had to be gathered to be held
    whole). On the card the one-token step replays a CUDA graph captured
    over the DTensor walk (DTensor's dispatch at capture only)."""

    # DTensor's views cannot set the version counter of an inference
    # tensor (a conv2d bias broadcast raises), so the mesh's forward runs
    # under no_grad
    _serving_mode = torch.no_grad

    def __init__(self, graph: Graph, mesh, device: torch.device, **kw):
        super().__init__(graph, device, **kw)
        self.mesh = mesh
        self._pl: Dict[int, tuple] = {}
        # weight -> [its copy at this executor's placements, its version]
        self._placed_copies = WeakIdKeyDictionary()
        self._row_fed_dims: Dict[int, frozenset] = {}
        self._weight_pts = {(op.name, n): wpt for op in self.topo
                            for n, wpt in zip(op.weight_names, op.weights)}
        self._const_vals = {g: self._replicated(v)
                            for g, v in self._const_vals.items()}
        # the gradient syncs that ran (at most one a weight a step), and
        # every collective by "<what>/<kind>/<axis>" (class docstring)
        self.grad_syncs = 0
        self.collectives: collections.Counter = collections.Counter()
        # overlapped reduce-scatters issued from a leaf's hook while the
        # backward ran, and those in flight until the update waits
        self.overlap_issued_in_backward = 0
        self._pending: Dict = {}
        # (op, weight) -> the placements an fsdp weight is gathered to
        self._gather_pl: Dict = {}
        # the generalized pipeline: a pipe axis and no block-stack op
        # means the graph itself is cut into stages (the JAX package's
        # executor plans it the same way)
        pipe = mesh.shape.get("pipe", 1)
        if pipe > 1 and not any(op.op_type == OperatorType.OP_BLOCK_STACK
                                for op in self.topo):
            self.pipeline_plan = self._plan_pcg_pipeline(pipe)
            if self.pipeline_plan is not None:
                from .pipeline import pipeline_ticks

                batch = self.input_pts[0].material_shape()[0]
                self._pipe_ticks = pipeline_ticks(
                    pipe, 0, batch // mesh.shape.get("data", 1))

    def mesh_is_live(self) -> bool:
        """False once the live world (runtime/distributed.py: shrunk by
        `shrunk_world` after a loss) no longer holds every rank this
        executor's mesh spans, or no longer holds this rank: a dispatch
        onto the stale mesh would wait forever for the lost ranks."""
        from ..runtime import distributed as rdist

        live = set(rdist.live_ranks())
        spans = set(self.mesh.device_mesh.mesh.flatten().tolist())
        return rdist.is_initialized() and \
            torch.distributed.get_rank() in live and spans <= live

    def placements(self, pt) -> tuple:
        pl = self._pl.get(pt.guid)
        if pl is None:
            pl = self._pl[pt.guid] = self.mesh.placements(pt)
        return pl

    def _replicated(self, t: torch.Tensor):
        """`t`, which every rank holds alike, as a replicated DTensor."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh.device_mesh,
                                  self.mesh.replicate(), run_check=False)

    # -- collectives -----------------------------------------------------
    def _count(self, what: str, src, dst) -> bool:
        """Count under `what` the collectives of a redistribute from
        placements `src` to `dst`, one per mesh axis that moves data;
        whether any does (Replicate -> Shard is a local slice)."""
        from torch.distributed.tensor import Partial, Shard

        moved = False
        for axis, a, b in zip(self.mesh.live_axes, src, dst):
            if a == b or (isinstance(b, Shard) and not isinstance(
                    a, (Partial, Shard))):
                continue
            kind = ("all_to_all" if isinstance(a, Shard)
                    and isinstance(b, Shard)
                    else "all_gather" if isinstance(a, Shard)
                    else "reduce_scatter" if isinstance(b, Shard)
                    else "all_reduce")
            self.collectives[f"{what}/{kind}/{axis}"] += 1
            moved = True
        return moved

    def _kind_total(self, what: str, kind: str) -> int:
        return sum(v for k, v in self.collectives.items()
                   if k.startswith(f"{what}/{kind}/"))

    @property
    def grad_all_reduces(self) -> int:
        return self._kind_total("grad", "all_reduce")

    @property
    def grad_reduce_scatters(self) -> int:
        return self._kind_total("grad", "reduce_scatter")

    @property
    def weight_gathers(self) -> int:
        """fsdp weights gathered on use, and updated weights gathered
        after the overlapped step's sharded update."""
        return (self._kind_total("weight", "all_gather")
                + self._kind_total("param", "all_gather"))

    # -- the overlapped gradient sync ------------------------------------
    def _overlap_specs(self) -> Dict:
        """(op name, weight name) -> (owned-shard placements, dim) for
        every weight the overlapped step updates on owned shards, the
        JAX package's `_overlap_specs` rule: the overlapped sync is on,
        the data axis is larger than 1, the weight has no data or fsdp
        placement (FSDP reduce-scatters on its own), and the weight's
        first dim that no axis shards and that the data size divides
        (and is at least) is sharded over "data" in the owned placements.
        Other weights keep the all-reduce."""
        if self._overlap_cache is not None:
            return self._overlap_cache
        from torch.distributed.tensor import Replicate, Shard

        out: Dict = {}
        dsize = self.mesh.shape.get("data", 1)
        ddim = self.mesh.dim_of("data")
        fdim = self.mesh.dim_of("fsdp")
        if self.overlap_grad_sync and ddim is not None:
            for op in self.topo:
                for n, wpt in zip(op.weight_names, op.weights):
                    pl = self.placements(wpt)
                    if not isinstance(pl[ddim], Replicate) or (
                            fdim is not None
                            and not isinstance(pl[fdim], Replicate)):
                        continue
                    taken = {p.dim for p in pl if isinstance(p, Shard)}
                    for di, size in enumerate(wpt.material_shape()):
                        if di not in taken and size >= dsize \
                                and size % dsize == 0:
                            owned = list(pl)
                            owned[ddim] = Shard(di)
                            out[(op.name, n)] = (tuple(owned), di)
                            break
        self._overlap_cache = out
        return out

    def _owned_view(self, w, owned, di):
        """The `Shard(di)`-over-"data" DTensor of the slice of weight `w`
        (held whole over "data") that this rank owns: a view of its local
        tensor, so an in-place update of it updates `w` there."""
        from torch.distributed.tensor import DTensor

        loc = local(w)
        part = loc.shape[di] // self.mesh.shape["data"]
        at = self.mesh.device_mesh.get_coordinate()[self.mesh.dim_of("data")]
        return DTensor.from_local(loc.narrow(di, at * part, part),
                                  self.mesh.device_mesh, owned,
                                  run_check=False)

    def _owned(self, tree: Params) -> Params:
        """A params-shaped tree with each overlap-eligible weight
        replaced by this rank's owned view of it."""
        omap = self._overlap_specs()
        if not omap:
            return tree
        return {op: {n: (self._owned_view(w, *omap[(op, n)])
                         if (op, n) in omap else w)
                     for n, w in ws.items()} for op, ws in tree.items()}

    def _watch_leaves(self, names, leaves) -> None:
        """Hook each overlap-eligible leaf: once autograd has its
        gradient (a partial sum over "data"), cast it as `_cast_grads`
        casts and issue its reduce-scatter onto the owned placements as
        an async collective; `_cast_grads` waits on it."""
        omap = self._overlap_specs()
        self._pending = {}
        for key, leaf in zip(names, leaves):
            if key in omap:
                leaf.register_hook(functools.partial(self._issue, key,
                                                     omap[key][0]))

    def _issue(self, key, owned, g):
        if self.grad_dtype is not None:
            g = g.to(self.grad_dtype)
        if torch._C._current_graph_task_id() != -1:
            self.overlap_issued_in_backward += 1
        if self._count("grad", g.placements, owned):
            self.grad_syncs += 1
        self._pending[key] = g.redistribute(self.mesh.device_mesh, owned,
                                            async_op=True)

    @torch.no_grad()
    def _gather_updated(self, params: Params) -> None:
        """All-gather each updated owned slice back into its weight."""
        for (op, n), (owned, di) in self._overlap_specs().items():
            w = params[op][n]
            whole = self._owned_view(w, owned, di).redistribute(
                self.mesh.device_mesh, w.placements)
            self._count("param", owned, w.placements)
            local(w).copy_(local(whole))

    # -- placement -------------------------------------------------------
    def init_params(self) -> Params:
        params = super().init_params()
        return {op: {n: distribute(w, self.mesh, self.placements(
            self._weight_pts[(op, n)])) for n, w in ws.items()}
            for op, ws in params.items()}

    def init_net_state(self) -> Params:
        return {op: {n: self._replicated(b) for n, b in bufs.items()}
                for op, bufs in super().init_net_state().items()}

    def place_param(self, wpt, value) -> torch.Tensor:
        return distribute(super().place_param(wpt, value), self.mesh,
                          self.placements(wpt))

    def _input_vals(self, batch_inputs) -> Dict[int, torch.Tensor]:
        vals = super()._input_vals(batch_inputs)
        return {pt.guid: distribute(vals[pt.guid], self.mesh,
                                    self.placements(pt))
                for pt in self.input_pts}

    def _as_labels(self, labels) -> torch.Tensor:
        """The global labels, sharded as the logits are on every dim but
        the class dim (a sparse label's trailing 1 cannot shard)."""
        from torch.distributed.tensor import Replicate, Shard

        y = super()._as_labels(labels)
        lshape = self.logits_pt.material_shape()
        pl = tuple(
            p if isinstance(p, Shard) and p.dim < len(lshape) - 1
            and p.dim < y.dim() - 1 and y.shape[p.dim] == lshape[p.dim]
            else Replicate()
            for p in self.placements(self.logits_pt))
        return distribute(y, self.mesh, pl)

    def _op_weights(self, op, w):
        """Op `op`'s weights with each one sharded over "fsdp" gathered
        to its placement without "fsdp" (an explicit all-gather before the
        op reads it; in training the backward of the redistribute
        reduce-scatters its gradient onto the shard)."""
        fdim = self.mesh.dim_of("fsdp")
        if fdim is None or not w:
            return w
        from torch.distributed.tensor import Replicate

        out = {}
        for n, t in w.items():
            key = (op.name, n)
            pl = self._gather_pl.get(key)
            if pl is None:
                pl = list(self.placements(self._weight_pts[key]))
                pl[fdim] = Replicate()
                pl = self._gather_pl[key] = tuple(pl)
            if tuple(t.placements) != pl:
                self._count("weight", t.placements, pl)
                src = t.placements
                t = t.redistribute(self.mesh.device_mesh, pl)
                if t.requires_grad:
                    t.register_hook(functools.partial(
                        self._count_gather_grad, src))
            out[n] = t
        return out

    def _count_gather_grad(self, src, g):
        """The gradient of a gathered fsdp weight, about to be reduced
        onto its shard by the redistribute's backward: count what runs."""
        if self._count("grad", g.placements, src):
            self.grad_syncs += 1

    def _parallel_op(self, op, ins) -> list:
        """The parallel op's redistribute; the expert dispatch's
        all-to-all (OP_ALL_TO_ALL, Shard -> Shard) is counted as
        "act/all_to_all/<axis>"."""
        outs = super()._parallel_op(op, ins)
        if op.op_type == OperatorType.OP_ALL_TO_ALL and is_dtensor(ins[0]):
            self._count("act", ins[0].placements, outs[0].placements)
        return outs

    def _constrain(self, val, pt):
        from torch.distributed.tensor import Shard

        if not is_dtensor(val):
            val = self._replicated(val)
        pl = self.placements(pt)
        if any(isinstance(p, Shard) for p in pl) and \
                tuple(val.placements) != pl:
            val = val.redistribute(self.mesh.device_mesh, pl)
        return val

    # -- the walk --------------------------------------------------------
    def _cast_grads(self, grads: Params) -> Params:
        """An overlap-eligible gradient: its reduce-scatter, issued from
        the backward, waited on here (already cast). Any other: cast as
        PCGExecutor casts, then redistributed to its weight's placement,
        the gradient all-reduce of the step. A gradient that comes out
        placed as its weight is (a weight sharded as its activations are,
        an fsdp weight reduce-scattered by its gather's backward) needs no
        collective here."""
        pending, self._pending = self._pending, {}
        out: Params = {}
        for op, gs in grads.items():
            for n, g in gs.items():
                key = (op, n)
                if key in pending:
                    out.setdefault(op, {})[n] = _waited(pending[key])
                    continue
                if self.grad_dtype is not None:
                    g = g.to(self.grad_dtype)
                pl = self.placements(self._weight_pts[key])
                if not is_dtensor(g):
                    g = self._replicated(g)
                if tuple(g.placements) != pl:
                    if self._count("grad", g.placements, pl):
                        self.grad_syncs += 1
                    g = g.redistribute(self.mesh.device_mesh, pl)
                out.setdefault(op, {})[n] = g
        return out

    def _train(self, state, batch_inputs, labels, row, poison=None):
        return {k: full(v) for k, v in super()._train(
            state, batch_inputs, labels, row, poison).items()}

    def build_forward(self, seq_length: int = -1) -> Callable:
        fwd = super().build_forward(seq_length)
        return lambda params, batch_inputs, net_state=None: full(
            fwd(params, batch_inputs, net_state))

    def build_eval_step(self) -> Callable:
        step = super().build_eval_step()

        def whole(params, batch_inputs, labels, net_state=None):
            logits, partials = step(params, batch_inputs, labels, net_state)
            return full(logits), {k: full(v) for k, v in partials.items()}

        return whole

    def _counters(self) -> collections.Counter:
        c = collections.Counter({("collectives", k): v
                                 for k, v in self.collectives.items()})
        c["grad_syncs"] = self.grad_syncs
        c["overlap_issued_in_backward"] = self.overlap_issued_in_backward
        return c

    def _add_counters(self, delta: collections.Counter,
                      times: int = 1) -> None:
        for k, v in delta.items():
            if isinstance(k, tuple):
                self.collectives[k[1]] += times * v
            else:
                setattr(self, k, getattr(self, k) + times * v)

    # -- the decode step -------------------------------------------------
    def _decode_params(self, params):
        """The weights at this executor's placements on its mesh (the JAX
        package traces its decode step device-local over weights placed at
        the winner's shardings). A weight already placed so is used as it
        is; any other (the training executor's weights served by the
        decode executor: another strategy, another mesh) through a copy
        placed here once and refreshed in place whenever the weight moves,
        by its version as the serving weight cache tracks it (each rank
        reads the source whole: "weight/placed" in `collectives`)."""
        if params is None:
            return None
        return {op: {n: self._placed(op, n, w) for n, w in ws.items()}
                for op, ws in params.items()}

    def _placed(self, op, n, w):
        wpt = self._weight_pts.get((op, n))
        if wpt is None:
            return w  # an op of another graph: the step never reads it
        pl = self.placements(wpt)
        if is_dtensor(w) and tuple(w.placements) == pl and (
                w.device_mesh is self.mesh.device_mesh
                or w.device_mesh == self.mesh.device_mesh):
            return w
        entry = self._placed_copies.get(w)
        if entry is not None and entry[1] == version(w):
            return entry[0]
        with torch.inference_mode(False), torch.no_grad():
            self.collectives["weight/placed"] += 1
            placed = distribute(full(w).detach().to(self.device), self.mesh,
                                pl)
            if entry is None:
                entry = self._placed_copies[w] = [placed, None]
            else:
                local(entry[0]).copy_(local(placed))
        entry[1] = version(w)
        return entry[0]

    def _decode_input(self, pt, array):
        return distribute(super()._decode_input(pt, local(array)), self.mesh,
                          self.placements(pt))

    def _decode_whole(self, t):
        if not is_dtensor(t):
            return self._replicated(t)
        want = self.mesh.replicate()
        if tuple(t.placements) != want:
            self._count("kv", t.placements, want)
            t = t.redistribute(self.mesh.device_mesh, want)
        return t

    def _decode_reduce(self, pt, v):
        from torch.distributed.tensor import Replicate, Shard

        if not is_dtensor(v):
            return v
        rows = self._row_fed(pt.guid)
        last = v.dim() - 1
        want = tuple(p if isinstance(p, Shard) and (
            p.dim == 0 or (p.dim == last and i in rows))
            else Replicate() for i, p in enumerate(v.placements))
        if want == tuple(v.placements):
            return v
        self._count("act", v.placements, want)
        return v.redistribute(self.mesh.device_mesh, want)

    def _row_fed(self, guid) -> frozenset:
        """The mesh dims over which every consumer of value `guid` is a
        dense op whose kernel that dim shards by rows (Megatron's second
        product): a value sharded there on its last dim stays so, and
        the consumers' local products give partial sums
        (ops/linear.py `_local_product`), as GSPMD keeps it sharded."""
        from torch.distributed.tensor import Shard

        dims = self._row_fed_dims.get(guid)
        if dims is None:
            users = [op for op in self.topo
                     if any(t.guid == guid for t in op.inputs)]
            keep = set(range(len(self.mesh.replicate()))) if users else set()
            for op in users:
                if (op.op_type != OperatorType.OP_LINEAR
                        or op.inputs[0].guid != guid):
                    keep = set()
                    break
                kernel = self.placements(self._weight_pts[(op.name,
                                                           "kernel")])
                keep &= {i for i, p in enumerate(kernel)
                         if isinstance(p, Shard) and p.dim == 0}
            dims = self._row_fed_dims[guid] = frozenset(keep)
        return dims

    def _decode_result(self, logits):
        """The logits whole on every rank (every rank picks the same
        tokens), counted as "out/all_gather/<axis>" where sharded."""
        self._count("out", logits.placements, self.mesh.replicate())
        return full(logits)
