"""Operator times measured on the device, for the measured-mode cost model.

The PyTorch counterpart of flexflow_tpu/search/measure.py (reference:
the Simulator measures every operator's fwd/bwd on the GPU and caches by
(op-params, machine-view) hash, simulator.cc:489-537,
Op::measure_operator_cost; inner_measure_operator_cost, operator.h:127,
times with cudaEvents around warm-up and repeats). `OperatorMeasurer`
runs an op's forward, then its forward with the backward, at the view's
per-shard shapes through the port's op library (on a card the MHA op
runs the flash kernels), and feeds the (fwd, bwd) seconds into
CostModel.measured, so the Unity search steers by the device instead of
the analytic roofline.

On a card one measurement is R repetitions captured in a CUDA graph
(parallel/graphs.py) and replayed between two CUDA events, and again
with 4R: the difference over 3R cancels what one replay costs beyond its
kernels (the graph launch, the events, the host), as the JAX package's
`per_rep_seconds` differences two scans. R grows until the difference
clears MIN_SIGNAL_S. On the CPU (tests) R repetitions are timed directly
on the host clock.

Enable with FFConfig.measure_operator_costs (argv: --measured-search).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ff_types import DataType, OperatorType
from ..ops.registry import FwdCtx, get_op_def

# the smallest R-vs-4R difference a card measurement accepts before R
# grows (a replay's fixed cost varies by microseconds)
MIN_SIGNAL_S = 1e-3
# R stops growing here whatever the signal
MAX_REPEATS = 4096


def _local_shape(pt) -> Tuple[int, ...]:
    """The per-shard material shape under the tensor's sharding degrees."""
    return tuple(
        d.size // max(1, d.degree)
        for d in pt.dims
        if not d.is_replica_dim
    )


def _dummy(shape, data_type: DataType, rng: np.random.RandomState,
           device: torch.device) -> torch.Tensor:
    dt = data_type.torch_dtype
    if data_type in (DataType.DT_INT32, DataType.DT_INT64):
        return torch.as_tensor(rng.randint(0, 2, shape), dtype=dt,
                               device=device)
    return torch.as_tensor(rng.rand(*shape).astype(np.float32), dtype=dt,
                           device=device)


def _shard_params(op, w_shapes, parts: int):
    """(the op's params at its shard, shards a device runs). A
    head-partitioned attention op's shard holds num_heads / k heads (its
    wq shard's middle dim), and its forward must be told so. The head
    degree is the weights' alone: the DP places the op by its output's
    degree, so a view may hold fewer devices than the op has shards
    (query degree x head degree), and then each device runs that many
    over the view's parts. The op is priced at that many shard times,
    never at one -- the JAX package's analytic price keeps the full head
    count on such views for the same reason. Other ops read their sizes
    from their operands and run one shard a device."""
    p = op.params
    if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION and w_shapes \
            and len(w_shapes[0]) == 3 and w_shapes[0][1] != p.num_heads:
        k = p.num_heads // max(1, w_shapes[0][1])
        q_deg = 1
        for d in op.inputs[0].dims:
            if not d.is_replica_dim:
                q_deg *= max(1, d.degree)
        return (dataclasses.replace(p, num_heads=w_shapes[0][1],
                                    kdim=p.qk_head_dim, vdim=p.v_head_dim),
                max(1, q_deg * k // max(1, parts)))
    return p, 1


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class Measurement:
    """One measured key: the op's shard shapes, what the forward call
    read and wrote (bytes at the dtypes the call saw), what the call with
    the backward wrote besides (the gradients), and the times. The weight
    shapes are the ones timed."""

    op_type: str
    params: str
    shard_shapes: Tuple[Tuple[int, ...], ...]
    weight_shapes: Tuple[Tuple[int, ...], ...]
    output_shapes: Tuple[Tuple[int, ...], ...]
    fwd_bytes: int
    grad_bytes: int
    # a weight of the op was timed whole (FSDP: gathered on use)
    gathered_weights: bool
    # shards of the op one device runs (the times are that many calls')
    shards_per_device: int
    repeats: int
    fwd_s: float
    total_s: float
    bwd_s: float


class OperatorMeasurer:
    """Times op fwd/bwd on `device` (a torch device; a card by default).

    Cached by (op_type, params, local input/weight shapes, parts) -- the
    view enters only through the shard shapes, like the reference's
    strict hash (simulator.cc strict_hash_to_operator_cost)."""

    def __init__(self, *, repeats: int = 50, warmup: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 device=None, cache_path: Optional[str] = None):
        self.repeats = repeats
        self.warmup = warmup
        self.compute_dtype = compute_dtype
        self.device = torch.device(device if device is not None else "cuda")
        self._cache: Dict[Tuple, Tuple[float, float]] = {}
        self._warned: set = set()
        # every measurement made in this process, and every op type that
        # fell back to the analytic roofline (with why)
        self.measurements: Dict[Tuple, Measurement] = {}
        self.fallbacks: List[Tuple[str, str]] = []
        # disk persistence (reference: the Simulator caches its on-device
        # microbenchmarks across runs): measurements survive process
        # restarts, so repeated --measured-search compiles pay the device
        # cost once per (op, shard shape)
        self.cache_path = cache_path
        self._disk: Dict[str, Tuple[float, float]] = {}
        self._disk_loaded = False

    def _cache_meta(self) -> Dict[str, str]:
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return {"device": kind, "dtype": str(self.compute_dtype or "f32")}

    def _load_disk(self) -> None:
        """Lazy (first measurement): the cache is only valid for the SAME
        device kind and compute dtype -- timings from another device
        replayed silently would poison every downstream cost."""
        self._disk_loaded = True
        if not self.cache_path:
            return
        import json
        import os

        if not os.path.exists(self.cache_path):
            return
        try:
            with open(self.cache_path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(
                f"measured-search: ignoring unreadable cache "
                f"{self.cache_path}: {e}"
            )
            return
        meta = data.pop("__meta__", None)
        if meta != self._cache_meta():
            warnings.warn(
                f"measured-search: cache {self.cache_path} was measured on "
                f"{meta} but this run is {self._cache_meta()} -- ignoring it"
            )
            return
        self._disk = {k: tuple(v) for k, v in data.items()}

    @staticmethod
    def _disk_key(key) -> str:
        op_type, params, shard_shapes, w_shapes, parts = key
        return f"{op_type.name}|{params!r}|{shard_shapes}|{w_shapes}|{parts}"

    def _disk_put(self, key, fb) -> None:
        if not self.cache_path:
            return
        import json

        self._disk[self._disk_key(key)] = fb
        try:
            payload = {"__meta__": self._cache_meta()}
            payload.update({k: list(v) for k, v in self._disk.items()})
            with open(self.cache_path, "w") as f:
                json.dump(payload, f, indent=0)
        except OSError as e:
            warnings.warn(f"measured-search: cache write failed: {e}")

    @staticmethod
    def key_of(op, view) -> Tuple:
        """The cache key of `op` under `view`."""
        return (op.op_type, op.params,
                tuple(_local_shape(t) for t in op.inputs),
                tuple(_local_shape(w) for w in op.weights),
                max(1, view.num_parts()))

    def __call__(self, op, view, *, force: bool = False) -> Tuple[float, float]:
        """(fwd, bwd) seconds of `op` under `view`; NaNs when the op cannot
        run alone (the cost model then prices it analytically, and the
        op type lands in `fallbacks`). force=True bypasses the cache READ
        (a fresh measurement still lands in the cache)."""
        key = self.key_of(op, view)
        _, _, shard_shapes, w_shapes, parts = key
        if not self._disk_loaded:
            self._load_disk()
        if not force:
            if key in self._cache:
                return self._cache[key]
            disk = self._disk.get(self._disk_key(key))
            if disk is not None:
                self._cache[key] = disk
                return disk
        try:
            m = self._measure(op, shard_shapes, w_shapes, parts)
        except Exception as e:
            # un-runnable standalone: analytic fallback -- but say so ONCE
            # per op type, and keep the record
            self.fallbacks.append((op.op_type.name,
                                   f"{type(e).__name__}: {e}"))
            if op.op_type not in self._warned:
                self._warned.add(op.op_type)
                warnings.warn(
                    f"measured-search: {op.op_type.name} fell back to the "
                    f"analytic cost model ({type(e).__name__}: {e})"
                )
            m = None
        if m is None:
            fb = (float("nan"), float("nan"))
        else:
            self.measurements[key] = m
            fb = (m.fwd_s, m.bwd_s)
            self._disk_put(key, fb)
        self._cache[key] = fb
        return fb

    # -- one measurement ---------------------------------------------------
    def _measure(self, op, shard_shapes, w_shapes,
                 parts: int) -> Optional[Measurement]:
        if op.is_parallel_op or not op.inputs:
            return None
        opdef = get_op_def(op.op_type)
        params, per_device = _shard_params(op, w_shapes, parts)
        rng = np.random.RandomState(0)
        dev = self.device
        inputs = [_dummy(s, t.data_type, rng, dev)
                  for s, t in zip(shard_shapes, op.inputs)]
        # weight names from the WeightSpecs (so dict lookups in the
        # forward resolve), shapes from the op's ParallelTensors at their
        # PER-SHARD sizes -- a channel-split kernel is timed at
        # out_channels/degree, not full size
        specs = opdef.weights(params, [tuple(s) for s in shard_shapes],
                              [t.data_type for t in op.inputs])
        weights = {spec.name: _dummy(ws, w.data_type, rng, dev)
                   for spec, ws, w in zip(specs, w_shapes, op.weights)}
        ctx = FwdCtx(training=False, compute_dtype=self.compute_dtype,
                     op_name=op.name)
        gathered = False
        try:
            with torch.no_grad():
                opdef.forward(params, weights, inputs, ctx)
        except RuntimeError:
            # a weight sharded where the op's inputs are not (FSDP: the
            # WeightShard node's target, parallel/weight_sharding.py) is
            # gathered whole before use, so it is timed whole: the
            # spec's shape at the shard inputs
            if all(tuple(sp.shape) == tuple(ws)
                   for sp, ws in zip(specs, w_shapes)):
                raise
            weights = {spec.name: _dummy(spec.shape, w.data_type, rng, dev)
                       for spec, w in zip(specs, op.weights)}
            gathered = True
        diffable = [i for i, a in enumerate(inputs)
                    if a.is_floating_point()]
        leaves = ([weights[k] for k in weights
                   if weights[k].is_floating_point()]
                  + [inputs[i] for i in diffable])

        def fwd_once():
            with torch.no_grad():
                return opdef.forward(params, weights, inputs, ctx)

        def total_once():
            ws = {k: (v.detach().requires_grad_() if v.is_floating_point()
                      else v) for k, v in weights.items()}
            ins = [a.detach().requires_grad_() if i in diffable else a
                   for i, a in enumerate(inputs)]
            outs = opdef.forward(params, ws, ins, ctx)
            loss = sum(o.float().sum() for o in outs
                       if o.is_floating_point())
            grads = torch.autograd.grad(
                loss, [v for v in ws.values() if v.requires_grad]
                + [ins[i] for i in diffable], allow_unused=True)
            return [g for g in grads if g is not None]

        outs = fwd_once()
        fwd_bytes = _nbytes(inputs) + _nbytes(weights.values()) + _nbytes(outs)
        grad_bytes = _nbytes(leaves)
        reps, fwd_t = self._per_rep_seconds(fwd_once)
        _, total_t = self._per_rep_seconds(total_once)
        # the JAX package's floor: a backward never reads as free
        bwd_t = max(total_t - fwd_t, 0.1 * fwd_t)
        fwd_t, total_t, bwd_t = (per_device * t
                                 for t in (fwd_t, total_t, bwd_t))
        return Measurement(
            op_type=op.op_type.name, params=repr(op.params),
            shard_shapes=shard_shapes,
            weight_shapes=tuple(tuple(w.shape) for w in weights.values()),
            output_shapes=tuple(tuple(o.shape) for o in outs),
            fwd_bytes=fwd_bytes, grad_bytes=grad_bytes,
            gathered_weights=gathered, shards_per_device=per_device,
            repeats=reps,
            fwd_s=fwd_t, total_s=total_t, bwd_s=bwd_t)

    def _per_rep_seconds(self, fn) -> Tuple[int, float]:
        """(R, seconds of one repetition of fn)."""
        if self.device.type != "cuda":
            return self.repeats, self._host_seconds(fn, self.repeats) \
                / self.repeats
        reps = self.repeats
        while True:
            t1 = self._graph_seconds(fn, reps)
            t4 = self._graph_seconds(fn, 4 * reps)
            signal = t4 - t1
            if signal > MIN_SIGNAL_S or 4 * reps >= MAX_REPEATS:
                return reps, max(signal / (3 * reps), 1e-9)
            reps *= 4

    def _host_seconds(self, fn, reps: int) -> float:
        for _ in range(self.warmup):
            fn()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best

    def _graph_seconds(self, fn, reps: int) -> float:
        """The best of three replays of `reps` calls of fn captured in one
        CUDA graph, between CUDA events."""
        from ..parallel.graphs import CapturedGraph, warm_up

        for _ in range(self.warmup):
            warm_up(fn)
        g = CapturedGraph()

        def body():
            for _ in range(reps):
                fn()

        g.capture(body)
        best = float("inf")
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        del g
        return best


def attach_measured_mode(cost_model, *, repeats: int = 50,
                         compute_dtype: Optional[torch.dtype] = None,
                         device=None,
                         cache_path: Optional[str] = None
                         ) -> OperatorMeasurer:
    """Wire an OperatorMeasurer into a CostModel: every cost-cache miss
    first measures on `device`; NaN (unmeasurable) falls back to the
    analytic roofline. cache_path persists measurements across runs.
    Returns the measurer."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        warnings.warn(
            f"measured-search is timing ops on the '{dev.type}' device; "
            "mixing those times with the machine model's link costs skews "
            "the search -- use for testing only"
        )
    cost_model.measure_fn = OperatorMeasurer(
        repeats=repeats, compute_dtype=compute_dtype, device=dev,
        cache_path=cache_path
    )
    return cost_model.measure_fn
