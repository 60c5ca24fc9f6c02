"""Analytic cost model for the strategy search.

The PyTorch counterpart of flexflow_tpu/search/cost_model.py (reference:
the Simulator, src/runtime/simulator.cc; measure_operator_cost caches
each op's fwd/bwd cost by params and machine view, simulator.cc:489).
An op's cost is an analytic roofline over its FLOPs and bytes, and
communication comes from the machine model's link and collective costs;
the measured mode (search/measure.py) overrides an op's entry with the
times measured on the device, as the reference's Simulator does.

The arithmetic is the JAX package's. The matmul tile quanta it pads a
shard's extents to come from the machine's chip spec (`mxu_lanes`,
`mxu_sublanes`): the JAX package's chip keeps its tile, the H100 spec
has the card's own (search/machine_model.py H100_SPEC).

A fit of the H100 ships with the port: calibration_h100.json, per-op-
class efficiencies fitted to times measured on the card by
`python -m flexflow_tpu_torch.search.calibrate` (the counterpart of
tools/calibrate_cost_model.py). `CostModel(calibration=None)` applies it
when the machine's chip is the H100's (its peak and bandwidth equal
H100_SPEC's, as `h100_machine()`'s do, which compile() searches by
default), and no fit on any other chip: a fit of one chip is wrong for
another. `calibration=False` applies none; a dict or a JSON file applies
through `validate_calibration`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..ff_types import OperatorType, PARALLEL_OP_TYPES
from ..pcg.machine_view import MachineView
from ..pcg.op import PCGOp
from .machine_model import H100_SPEC, MachineModel, TPUChipSpec


class CostObjective:
    """What workload the cost oracle prices an op for (ROADMAP item 3 —
    "run the Unity search twice per model with different cost
    objectives"; the Splitwise/DistServe disaggregation insight).

      TRAIN  — the classic per-step price: padded MXU FLOPs vs HBM
               roofline, backward + weight-grad sync included.
      DECODE — one single-token decode step: cost is the HBM roofline
               over the bytes the step actually streams (weights per
               shard + the KV-cache-resident K/V re-read per token +
               1-token activation slices), no backward, no grad sync,
               and collectives priced latency-bound (per-token messages
               are KB-sized, so hop latency dominates bandwidth).
    """

    TRAIN = "train"
    DECODE = "decode"
    ALL = (TRAIN, DECODE)

    @staticmethod
    def validate(objective: str) -> str:
        if objective not in CostObjective.ALL:
            raise ValueError(
                f"objective={objective!r}: expected one of "
                f"{'/'.join(CostObjective.ALL)}"
            )
        return objective


@dataclasses.dataclass
class CostMetrics:
    """reference: simulator.h:54-88 CostMetrics"""

    forward_time: float = 0.0
    backward_time: float = 0.0
    sync_time: float = 0.0  # weight-grad allreduce
    inputs_memory: int = 0
    outputs_memory: int = 0
    weights_memory: int = 0
    # seconds of sync_time the overlapped schedule hides behind backward
    # compute (0 unless the cost model runs with overlap_backward_update;
    # never exceeds sync_time, so total_time is never below fwd + bwd)
    hidden_sync_time: float = 0.0

    @property
    def total_time(self) -> float:
        exposed = max(0.0, self.sync_time - self.hidden_sync_time)
        return self.forward_time + self.backward_time + exposed

    @property
    def total_memory(self) -> int:
        return self.inputs_memory + self.outputs_memory + self.weights_memory


def _vol(shape) -> int:
    v = 1
    for s in shape:
        v *= int(s)
    return v


def op_flops(op: PCGOp) -> float:
    """Forward FLOPs of the whole (unsharded) op."""
    t = op.op_type
    in_shapes = [x.material_shape() for x in op.inputs]
    out_shapes = [x.material_shape() for x in op.outputs]
    if t == OperatorType.OP_LINEAR:
        (s,) = in_shapes
        return 2.0 * _vol(s) * op.params.out_channels
    if t == OperatorType.OP_CONV2D:
        o = out_shapes[0]  # (N, Cout, OH, OW)
        cin = in_shapes[0][1]
        p = op.params
        return 2.0 * _vol(o) * cin * p.kernel_h * p.kernel_w / max(1, p.groups)
    if t == OperatorType.OP_BATCHMATMUL:
        a, b = in_shapes
        return 2.0 * _vol(a) * b[-1]
    if t == OperatorType.OP_MULTIHEAD_ATTENTION:
        q, k, v = in_shapes
        p = op.params
        h, d = p.num_heads, p.qk_head_dim
        bq, sq, eq = q[0], q[1], q[2]
        sk = k[1]
        proj = 2.0 * bq * sq * eq * h * d * 3  # q,k,v projections
        scores = 2.0 * bq * h * sq * sk * d
        av = 2.0 * bq * h * sq * sk * p.v_head_dim
        out = 2.0 * bq * sq * h * p.v_head_dim * p.embed_dim
        return proj + scores + av + out
    if t in (OperatorType.OP_GROUP_BY, OperatorType.OP_AGGREGATE,
             OperatorType.OP_AGG_SPEC):
        # dispatch/combine einsum ~ tokens × experts × capacity × dim
        total_out = sum(_vol(s) for s in out_shapes)
        return 2.0 * total_out * max(1, in_shapes[0][0])
    # elementwise / data movement: negligible flops (1 per element)
    return float(sum(_vol(s) for s in out_shapes))


def _pad(v, q: int) -> float:
    return float(math.ceil(max(1, int(v)) / q) * q)


def _shard_shape(t) -> List[int]:
    """Per-device shard extents: size/degree per dim (replica dims keep
    their size — every replica computes the full extent)."""
    return [max(1, d.size // max(1, d.degree)) if not d.is_replica_dim
            else d.size for d in t.dims]


def op_padded_flops(op: PCGOp, parts: int = 1,
                    chip: Optional[TPUChipSpec] = None) -> float:
    """PER-SHARD tile-effective FLOPs: a matmul whose dims are not
    multiples of the chip's tile (`chip.mxu_lanes` wide in the output
    and contraction dims, `chip.mxu_sublanes` rows) runs at the PADDED
    shape's cost. Padding applies to the SHARD shape, not the logical
    one -- splitting a one-tile-wide gemm two ways leaves each shard
    paying a full tile, so over-sharding narrow dims stops helping.
    `chip` None takes TPUChipSpec()'s quanta (the JAX package's); quanta
    of 1 give the unpadded per-shard FLOPs. Ops with no matmul shape
    return plain per-shard flops."""
    if chip is None:
        chip = TPUChipSpec()
    MXU_LANES, MXU_SUBLANES = chip.mxu_lanes, chip.mxu_sublanes
    t = op.op_type
    if t == OperatorType.OP_LINEAR and op.inputs and op.outputs:
        si = _shard_shape(op.inputs[0])
        # replica dims are dropped from the OUTPUT: a partial-sum output
        # (row-parallel linear, contraction sharded) marks its pending
        # reduction with a replica dim, but each device only computes its
        # contraction slice — the /degree is already in si[-1]. Truly
        # duplicated compute (replicated input) shows up as an UNSHARDED
        # si[-1], so dropping the dim never under-prices replication.
        so = [x for x, d in zip(_shard_shape(op.outputs[0]),
                                op.outputs[0].dims) if not d.is_replica_dim]
        return 2.0 * _pad(_vol(so[:-1]), MXU_SUBLANES) * _pad(si[-1], MXU_LANES) * _pad(so[-1], MXU_LANES)
    if t == OperatorType.OP_CONV2D and op.inputs and op.outputs:
        si = _shard_shape(op.inputs[0])   # (N, Cin, H, W) shard
        so = _shard_shape(op.outputs[0])  # (N, Cout, OH, OW) shard
        p = op.params
        contraction = si[1] * p.kernel_h * p.kernel_w // max(1, p.groups)
        return 2.0 * _pad(so[0] * so[2] * so[3], MXU_SUBLANES) * _pad(contraction, MXU_LANES) \
            * _pad(so[1], MXU_LANES)
    if t == OperatorType.OP_BATCHMATMUL and len(op.inputs) == 2:
        sa = _shard_shape(op.inputs[0])
        sb = _shard_shape(op.inputs[1])
        # each batch element is a SEPARATE MXU gemm, so the 8-row sublane
        # padding applies per batch element (exactly like the MHA branch's
        # bq*h*_pad(sq,8) below), not once to the flattened batch*rows
        # product — flattening under-priced small-rows batched matmuls
        return 2.0 * _vol(sa[:-2]) * _pad(sa[-2], MXU_SUBLANES) * _pad(sa[-1], MXU_LANES) \
            * _pad(sb[-1], MXU_LANES)
    if t == OperatorType.OP_MULTIHEAD_ATTENTION and len(op.inputs) == 3:
        q, k = op.inputs[0], op.inputs[1]
        p = op.params
        bq = _shard_shape(q)[0]
        # seq/embed from the material (non-replica) dims, as op_flops
        # does — a leading replica dim on q/k would shift raw indices
        qm = [d.size for d in q.dims if not d.is_replica_dim]
        km = [d.size for d in k.dims if not d.is_replica_dim]
        sq, eq = qm[1], qm[2]
        sk = km[1]
        # head-sharded MHA (weight-only degrees) keeps its full-h price —
        # the DP grants it single-part views, so charging one shard here
        # would let a TP candidate undercut without paying its devices
        h, d = p.num_heads, p.qk_head_dim
        proj = 2.0 * _pad(bq * sq, MXU_SUBLANES) * _pad(eq, MXU_LANES) * _pad(h * d, MXU_LANES) * 3
        scores = 2.0 * bq * h * _pad(sq, MXU_SUBLANES) * _pad(d, MXU_LANES) * _pad(sk, MXU_LANES)
        av = 2.0 * bq * h * _pad(sq, MXU_SUBLANES) * _pad(sk, MXU_LANES) * _pad(p.v_head_dim, MXU_LANES)
        out = 2.0 * _pad(bq * sq, MXU_SUBLANES) * _pad(h * p.v_head_dim, MXU_LANES) * _pad(p.embed_dim, MXU_LANES)
        return proj + scores + av + out
    return op_flops(op) / max(1, parts)


def op_bytes(op: PCGOp) -> float:
    """HBM traffic of the whole op (inputs + outputs + weights, once).

    Activations move at their COMPUTE width (analysis/precision.py
    annotations — a bf16 flow streams 2 bytes/elt); weights stay at
    their declared storage width, because the fp32 master copy is what
    the op actually reads from HBM under AMP."""
    n = 0
    for x in op.inputs:
        n += _vol(x.material_shape()) * x.effective_itemsize()
    for x in op.outputs:
        n += _vol(x.material_shape()) * x.effective_itemsize()
    for w in op.weights:
        n += _vol(w.material_shape()) * w.data_type.size
    return float(n)


def op_weight_bytes(op: PCGOp) -> int:
    return sum(_vol(w.material_shape()) * w.data_type.size for w in op.weights)


def _seq_extent(t) -> int:
    """The sequence extent of an activation tensor under the repo's
    (batch, seq, ...) convention — 1 for tensors with no seq axis."""
    s = t.material_shape()
    return int(s[1]) if len(s) >= 3 else 1


def op_decode_bytes(op: PCGOp) -> float:
    """HBM bytes ONE single-token decode step streams for this op,
    unsharded (the decode-objective analog of op_bytes): every weight is
    read once per step; an MHA op re-reads its KV-cache-resident K/V in
    full (the cache length is stood in for by the graph's compiled seq
    extent — same tensors, same bytes); activations contribute only
    their 1-token slice (full volume over the seq extent). This is what
    makes decode memory-bound where training is compute-bound: at batch
    1 the weights dominate and the FLOPs term of the roofline collapses.
    """
    n = float(op_weight_bytes(op))
    if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION \
            and len(op.inputs) >= 3:
        # the persistent (b, max_len, h, d) K/V pair the step attends
        # over — byte-equivalent to the full k/v inputs; the cache is
        # materialized at the compute width (bf16 under AMP)
        for x in op.inputs[1:3]:
            n += _vol(x.material_shape()) * x.effective_itemsize()
    for x in list(op.inputs) + list(op.outputs):
        n += _vol(x.material_shape()) * x.effective_itemsize() \
            / max(1, _seq_extent(x))
    return n


def validate_calibration(cal: dict) -> dict:
    """Reject out-of-range calibration values at load time: efficiencies
    must lie in (0, 1] (a 0.0 or negative value would otherwise silently
    produce infinite/negative op costs) and bwd/fwd ratios must be
    positive."""
    def check_eff(name, v):
        if v is None:
            return
        if not isinstance(v, (int, float)) or not (0.0 < v <= 1.0):
            raise ValueError(
                f"calibration {name}={v!r} outside (0, 1]"
            )

    if not isinstance(cal, dict):
        raise ValueError(f"calibration must be a dict, got {type(cal)}")
    # fraction of an overlappable collective that actually hides behind
    # backward compute on the device (the overlap discount's
    # calibration knob)
    check_eff("overlap_efficiency", cal.get("overlap_efficiency"))
    op_class = cal.get("op_class", {})
    if not isinstance(op_class, dict):
        raise ValueError("calibration op_class must be a dict")
    check_eff("mxu_efficiency", cal.get("mxu_efficiency"))
    check_eff("hbm_efficiency", cal.get("hbm_efficiency"))
    for op_name, cls in op_class.items():
        if not isinstance(cls, dict):
            raise ValueError(
                f"calibration op_class[{op_name}] must be a dict"
            )
        check_eff(f"op_class[{op_name}].mxu_efficiency",
                  cls.get("mxu_efficiency"))
        check_eff(f"op_class[{op_name}].hbm_efficiency",
                  cls.get("hbm_efficiency"))
        ratio = cls.get("bwd_over_fwd")
        if ratio is not None and (
                not isinstance(ratio, (int, float)) or ratio <= 0):
            raise ValueError(
                f"calibration op_class[{op_name}].bwd_over_fwd={ratio!r} "
                "must be positive"
            )
    return cal


_DEFAULT_CALIBRATION: Optional[dict] = None
_DEFAULT_CALIBRATION_LOADED = False


def load_default_calibration() -> Optional[dict]:
    """The shipped fit of the H100 (calibration_h100.json, written by
    `python -m flexflow_tpu_torch.search.calibrate` on the card): per-op-
    class efficiencies fitted from measured fwd/bwd times. Read and
    validated once; None when the file is missing or invalid."""
    global _DEFAULT_CALIBRATION, _DEFAULT_CALIBRATION_LOADED
    if not _DEFAULT_CALIBRATION_LOADED:
        _DEFAULT_CALIBRATION_LOADED = True
        import json
        import os

        path = os.path.join(os.path.dirname(__file__),
                            "calibration_h100.json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    _DEFAULT_CALIBRATION = validate_calibration(json.load(f))
            except (OSError, ValueError):
                _DEFAULT_CALIBRATION = None
    return _DEFAULT_CALIBRATION


def _is_h100_chip(chip) -> bool:
    """True when `chip` prices like the H100 spec the shipped fit was
    measured against: the same peak and bandwidth."""
    return (chip.peak_flops_bf16 == H100_SPEC.peak_flops_bf16
            and chip.hbm_bandwidth == H100_SPEC.hbm_bandwidth)


def apply_calibration(cm, *, profiled=None, overlap_efficiency=None,
                      collective_bandwidths=None):
    """The measured-calibration refresh seam: write measurements onto a
    CostModel in place and return it. Compile-time oracle construction
    (core/model.py _build_cost_model) funnels through here.

    profiled: {op_cost_key: (fwd_s, bwd_s)} measured per-op seconds
    (obs/explain.py, or a CalibrationStore's table) — serial-view costs
    resolve to these instead of the analytic roofline.
    overlap_efficiency / collective_bandwidths: the CalibrationStore's
    measured globals (step observatory write-through).
    """
    if profiled:
        from ..obs.explain import attach_profiled_costs

        attach_profiled_costs(cm, profiled)
    if overlap_efficiency is not None:
        cm.overlap_efficiency = float(overlap_efficiency)
        cm.overlap_efficiency_source = "calibration_store"
    if collective_bandwidths:
        cm.calibrated_collective_bandwidths = {
            k: float(v) for k, v in collective_bandwidths.items()
        }
    return cm


class CostModel:
    """Per-(op, machine-view) cost oracle with memoization
    (reference: Simulator::measure_operator_cost's hash_map cache,
    simulator.cc:489-537 + strict_hash_to_operator_cost).

    calibration: None applies the shipped fit of the H100
    (load_default_calibration) when the machine's chip is the H100's,
    and none on any other chip; False applies none; a dict or a JSON
    path supplies one, checked by validate_calibration. A fit refines
    the roofline's mxu/hbm efficiency constants per op class."""

    def __init__(self, machine: MachineModel, *, bf16: bool = True,
                 calibration=None, overlap_backward_update: bool = False,
                 overlap_efficiency: Optional[float] = None,
                 survivability_penalty: float = 0.0,
                 objective: str = CostObjective.TRAIN):
        self.machine = machine
        self.bf16 = bf16
        # what workload an op's price describes: the training step
        # (default) or one single-token decode step (CostObjective.DECODE
        # — HBM-roofline bytes, no backward/sync, latency-bound
        # collectives). Per-instance, so the two searches a model runs
        # (compile() + compile_decode()) can never share a cache entry.
        self.objective = CostObjective.validate(objective)
        # slice-loss survivability bias (search/survivability.py, config
        # knob search_survivability_penalty): >0 on hierarchical
        # machines makes DP/MCMC multiply a candidate's cost by
        # 1 + penalty * (cross-slice-sharded weight fraction), steering
        # the search toward strategies where only data-parallel replicas
        # cross the slice boundary. 0 disables the bias entirely.
        self.survivability_penalty = float(survivability_penalty)
        # "overlappable" discount (config.search_overlap_backward_update):
        # a weight-gradient sync collective is statically independent of
        # the backward critical path — the gradient it reduces feeds ONLY
        # the optimizer update, and every topologically-earlier op's
        # backward cannot read it (analysis/collectives.
        # overlappable_grad_syncs is the graph-level proof) — so the
        # overlapped executor hides it behind dependent backward matmuls
        # and the search should price only the EXPOSED remainder:
        # max(0, sync - overlap_efficiency * backward). Explicit parallel
        # ops (Repartition/Combine/...) sit on the activation path and
        # keep their full price.
        self.overlap_backward_update = overlap_backward_update
        if calibration is None:
            calibration = (load_default_calibration()
                           if _is_h100_chip(machine.chip) else None)
        elif calibration is False:
            calibration = None
        elif isinstance(calibration, str):
            import json

            with open(calibration) as f:
                calibration = validate_calibration(json.load(f))
        elif isinstance(calibration, dict):
            validate_calibration(calibration)
        self.calibration = calibration
        if overlap_efficiency is None:
            overlap_efficiency = (calibration or {}).get(
                "overlap_efficiency", 1.0
            )
        self.overlap_efficiency = float(overlap_efficiency)
        self._cache: Dict[Tuple, CostMetrics] = {}
        self._xfer_cache: Dict[Tuple, float] = {}
        # measured-mode overrides: key -> (fwd, bwd) seconds
        self.measured: Dict[Tuple, Tuple[float, float]] = {}
        # optional on-device microbenchmark oracle (search/measure.py,
        # reference: Simulator::measure_operator_cost's real timing path)
        self.measure_fn = None
        # provenance: where a measured oracle came from, and how often
        # the search actually priced an op from measurement vs the
        # analytic roofline -- so "measured" is a checked claim, not an
        # assumption
        self.calibration_source: Optional[str] = None
        self.measured_hits = 0
        self.analytic_hits = 0
        # calibrated globals: where overlap_efficiency came from
        # and the measured per-kind collective bandwidths the oracle was
        # handed — provenance() reports both so "priced from reality" is
        # a checkable claim
        self.overlap_efficiency_source = (
            "calibration" if (calibration or {}).get("overlap_efficiency")
            is not None else "default"
        )
        self.calibrated_collective_bandwidths: Dict[str, float] = {}

    def provenance(self) -> dict:
        """How this oracle priced ops so far: measurement vs analytic
        roofline (cache-cold queries only — memoized repeats don't
        re-count), plus the calibrated globals (overlap efficiency and
        any measured collective bandwidths the calibration store fed
        in). analysis/perf.py attaches this to its report when a
        measured source is present."""
        total = self.measured_hits + self.analytic_hits
        return {
            "source": self.calibration_source,
            "measured_ops": len(self.measured),
            "measured_hits": self.measured_hits,
            "analytic_hits": self.analytic_hits,
            "measured_fraction": (self.measured_hits / total)
            if total else 0.0,
            "overlap_efficiency": self.overlap_efficiency,
            "overlap_efficiency_source": self.overlap_efficiency_source,
            "collective_bytes_per_s":
                dict(self.calibrated_collective_bandwidths),
        }

    def _calibration_class(self, op_type, flops=None,
                           membytes=None) -> Optional[dict]:
        """The fitted entry for this op, shape-regime aware: a class may
        ship a separate '<NAME>@mem' fit for its memory-bound shapes
        (VERDICT r2 #8 — OP_LINEAR's implied efficiencies spanned 6x
        between compute- and memory-bound shapes; one scalar can't serve
        both). Regime decided by the UNCALIBRATED roofline."""
        if not self.calibration:
            return None
        cls_map = self.calibration.get("op_class", {})
        name = op_type.name
        if flops is not None and membytes is not None and \
                f"{name}@mem" in cls_map:
            peak = (self.machine.chip.peak_flops_bf16 if self.bf16
                    else self.machine.chip.peak_flops_f32)
            t_f = flops / peak
            t_m = membytes / self.machine.chip.hbm_bandwidth
            if t_m > t_f:
                name = f"{name}@mem"
        return cls_map.get(name)

    def _calibrated_efficiencies(self, op_type, flops=None, membytes=None
                                 ) -> Tuple[Optional[float],
                                            Optional[float]]:
        """(mxu_eff, hbm_eff) overrides for this op class, if fitted."""
        if not self.calibration:
            return None, None
        cls = self._calibration_class(op_type, flops, membytes)
        g_m = self.calibration.get("mxu_efficiency")
        g_h = self.calibration.get("hbm_efficiency")
        if cls:
            return cls.get("mxu_efficiency", g_m), cls.get("hbm_efficiency",
                                                           g_h)
        return g_m, g_h

    def _key(self, op: PCGOp, view: MachineView):
        # weights are part of the key: their sharding degrees decide the
        # gradient-sync term (a channel-split table syncs nothing; a
        # replicated one allreduces the full table)
        return (
            op.op_type,
            op.params,
            tuple(t.shape_key() for t in op.inputs),
            tuple(w.shape_key() for w in op.weights),
            view.hash(),
        )

    def _measure_decode_cost(self, op: PCGOp, view: MachineView,
                             key) -> CostMetrics:
        """Price ONE single-token decode step of `op` under `view`: the
        HBM roofline over the bytes the step streams per device. Weights
        divide by their OWN shard degree (a head/channel-split weight is
        the thing decode sharding actually buys — each chip streams
        1/degree of the matrix per token); the KV-cache-resident K/V
        divide by the batch degree × the head-shard degree (the two axes
        that tile the cache); 1-token activation slices divide by the
        view's parts. FLOPs are the UNPADDED per-token count — a 1-token
        gemm never fills an MXU tile, and padding it would misprice
        decode as compute-bound, which is exactly the mistake the decode
        objective exists to avoid. No backward, no weight-grad sync."""
        parts = max(1, view.num_parts())
        seq = max(1, _seq_extent(op.outputs[0])) if op.outputs else 1
        flops = op_flops(op) / seq / parts
        membytes = 0.0
        for w in op.weights:
            membytes += _vol(w.material_shape()) * w.data_type.size \
                / max(1, w.get_total_degree())
        if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION \
                and len(op.inputs) >= 3:
            batch_deg = 1
            if op.outputs and op.outputs[0].dims:
                batch_deg = max(1, op.outputs[0].dims[0].degree)
            head_deg = max(
                [max(1, w.get_total_degree()) for w in op.weights] or [1]
            )
            kv = sum(_vol(x.material_shape()) * x.effective_itemsize()
                     for x in op.inputs[1:3])
            membytes += kv / max(1, batch_deg * head_deg)
        for x in list(op.inputs) + list(op.outputs):
            membytes += _vol(x.material_shape()) * x.effective_itemsize() \
                / max(1, _seq_extent(x)) / parts
        mxu_eff, hbm_eff = self._calibrated_efficiencies(
            op.op_type, flops, membytes
        )
        self.analytic_hits += 1
        fwd = self.machine.compute_cost(
            flops, membytes, self.bf16, mxu_eff=mxu_eff, hbm_eff=hbm_eff,
        )
        wmem = 0
        for w in op.weights:
            w_b = _vol(w.material_shape()) * w.data_type.size
            wmem += int(w_b / max(1, w.get_total_degree()))
        cm = CostMetrics(
            forward_time=fwd,
            backward_time=0.0,
            sync_time=0.0,
            inputs_memory=int(
                sum(_vol(t.material_shape()) * t.effective_itemsize()
                    for t in op.inputs) / parts
            ),
            outputs_memory=int(
                sum(_vol(t.material_shape()) * t.effective_itemsize()
                    for t in op.outputs) / parts
            ),
            weights_memory=wmem,
        )
        self._cache[key] = cm
        return cm

    def measure_operator_cost(self, op: PCGOp, view: MachineView) -> CostMetrics:
        key = self._key(op, view)
        if key in self._cache:
            return self._cache[key]
        if self.objective == CostObjective.DECODE:
            return self._measure_decode_cost(op, view, key)
        parts = max(1, view.num_parts())
        # MXU time is paid at the tile-quantized SHARD shape; the padded
        # count only describes the shard when the tensor degrees actually
        # match the view's parts (they do for DP-granted views;
        # unsharded-tensor-on-wide-view callers fall back to plain /parts)
        out_deg = op.outputs[0].get_total_degree() if op.outputs else 1
        if out_deg == parts:
            flops = op_padded_flops(op, parts, self.machine.chip)
        else:
            flops = op_flops(op) / parts
        membytes = op_bytes(op) / parts
        if key not in self.measured and self.measure_fn is not None:
            m_fwd, m_bwd = self.measure_fn(op, view)
            if m_fwd == m_fwd:  # not NaN -> measurable on device
                self.measured[key] = (m_fwd, m_bwd)
        if key in self.measured:
            self.measured_hits += 1
            fwd, bwd = self.measured[key]
        else:
            self.analytic_hits += 1
            mxu_eff, hbm_eff = self._calibrated_efficiencies(
                op.op_type, flops, membytes
            )
            fwd = self.machine.compute_cost(
                flops, membytes, self.bf16,
                mxu_eff=mxu_eff, hbm_eff=hbm_eff,
            )
            # backward ≈ 2× forward for weight ops (dgrad+wgrad), ≈ forward
            # for the rest (reference measures both; ratio matches its
            # observed GEMM fwd:bwd split); calibration refines per class
            ratio = None
            cls = self._calibration_class(op.op_type, flops, membytes)
            if cls:
                ratio = cls.get("bwd_over_fwd")
            if ratio is None:
                ratio = 2.0 if op.weights else 1.0
            bwd = ratio * fwd
        # Ring-attention ICI rotation (Liu et al., Ring Attention): a
        # seq-sharded attention op keeps K/V resident and rotates each
        # shard around the seq ring — (sd-1) steps of kv_bytes/sd each,
        # i.e. kv_bytes*(sd-1)/sd total wire time, which is EXACTLY the
        # all_to_all_cost formula; routing it through the machine model
        # means the hierarchical slice-crossing override prices rings
        # that straddle slices too (search/network.py). Backward rotates
        # twice (the dK/dV accumulation makes a second pass).
        if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION \
                and op.outputs and len(op.outputs[0].dims) == 3 \
                and op.outputs[0].dims[1].degree > 1 and len(op.inputs) >= 2:
            sd = op.outputs[0].dims[1].degree
            group = view.device_ids()[:sd]
            if len(group) >= 2:
                kv_bytes = 2 * _vol(op.inputs[1].material_shape()) \
                    * op.inputs[1].effective_itemsize()
                rot = self.machine.all_to_all_cost(kv_bytes, group)
                fwd += rot
                bwd += 2 * rot
        # weight gradient sync (reference: NCCL allreduce per weight per
        # view, optimizer.cc nccl_update_task). Per weight: a sharded
        # weight only syncs across its REPLICAS — each device owns
        # bytes/degree, and with `degree` shards over `parts` devices the
        # replica group for one shard is every degree-th device (strided,
        # so a group can span nodes and pay DCN). Fully sharded weights
        # (parameter parallelism, e.g. DLRM embedding tables) sync nothing;
        # replicated weights coexisting with sharded ones (a row-parallel
        # Linear's bias) still pay their own full allreduce.
        sync = 0.0
        wbytes = op_weight_bytes(op)
        if wbytes and parts > 1:
            ids = view.device_ids()
            for w in op.weights:
                w_bytes = _vol(w.material_shape()) * w.data_type.size
                w_deg = max(1, w.get_total_degree())
                replicas = max(1, parts // w_deg)
                if replicas > 1:
                    group = ids[::w_deg][:replicas]
                    sync += self.machine.allreduce_cost(w_bytes / w_deg, group)
        hidden = 0.0
        if sync > 0.0 and self.overlap_backward_update:
            # overlappable discount: the exposed sync is what the comm
            # channel can't hide behind this op's share of backward
            # compute (the machine model owns the overlap seam so
            # topology-aware models can refine it)
            exposed = self.machine.exposed_comm_time(
                sync, bwd, self.overlap_efficiency
            )
            hidden = sync - exposed
        # Per-device weight bytes divide by the weight's OWN shard degree,
        # never by the view's part count: a replicated weight under a
        # data-parallel view lives in FULL on every replica (dividing by
        # `parts`, as rounds 3-6 did, made the memory search believe DP
        # already shards state — so the lambda loop admitted strategies
        # the static analyzer correctly rejects with FFA301, and weight
        # sharding looked pointless). A dim-sharded weight (tensor-
        # parallel channel/head splits, FSDP/ZeRO weight sharding) holds
        # bytes/degree per device regardless of how the view tiles the
        # activations — the same rule analysis/memory._shard_bytes uses,
        # so the search and the static HBM gate price the same bytes.
        wmem = 0
        for w in op.weights:
            w_b = _vol(w.material_shape()) * w.data_type.size
            wmem += int(w_b / max(1, w.get_total_degree()))
        cm = CostMetrics(
            forward_time=fwd,
            backward_time=bwd,
            sync_time=sync,
            hidden_sync_time=hidden,
            inputs_memory=int(
                sum(_vol(t.material_shape()) * t.data_type.size for t in op.inputs)
                / parts
            ),
            outputs_memory=int(
                sum(_vol(t.material_shape()) * t.data_type.size for t in op.outputs)
                / parts
            ),
            weights_memory=wmem,
        )
        self._cache[key] = cm
        return cm

    def estimate_xfer_cost(
        self,
        tensor,
        src_view: Optional[MachineView],
        dst_view: Optional[MachineView],
    ) -> float:
        """Resharding cost of moving `tensor` from src_view's layout to
        dst_view's (reference: SearchHelper::estimate_xfer_cost — Legion
        region movement; here: the collective the move would take)."""
        if src_view is None or dst_view is None:
            return 0.0
        if src_view.hash() == dst_view.hash():
            return 0.0
        total = _vol(tensor.material_shape()) * tensor.data_type.size
        if self.objective == CostObjective.DECODE:
            # a decode step only moves the 1-token slice of the
            # activation; xfer_cost's link-latency term then dominates,
            # which is the point — resharding per token is expensive in
            # hops, not bytes
            total /= max(1, _seq_extent(tensor))
        key = (total, src_view.hash(), dst_view.hash())
        cached = self._xfer_cache.get(key)
        if cached is not None:
            return cached
        src_ids, dst_ids = src_view.device_ids(), dst_view.device_ids()
        # per-destination bytes: each dst shard gathers its slice
        per_dst = total / max(1, len(dst_ids))
        worst = 0.0
        for i, d in enumerate(dst_ids):
            s = src_ids[i % len(src_ids)]
            worst = max(worst, self.machine.xfer_cost(per_dst, s, d))
        self._xfer_cache[key] = worst
        return worst

    def concurrent_xfer_penalty(self, flows) -> float:
        """Congestion surcharge for transfers that happen AT THE SAME TIME
        (an op pulling several inputs; concurrent nonsequence halves
        pulling their boundary tensors; a diamond sink draining its
        towers). flows: [(tensor, src_view, dst_view), ...].

        Priced through the machine's concurrent_flows_cost (the
        topology-aware link-sharing model, network.py — reference:
        EnhancedMachineModel congestion over shared comm devices,
        machine_model.cc): penalty = finish time of the flow SET minus the
        slowest flow alone, i.e. exactly the cost the independent
        per-transfer estimates miss. Flat machine models (no
        concurrent_flows_cost) price zero — link sharing is invisible to
        them by construction."""
        conc_fn = getattr(self.machine, "concurrent_flows_cost", None)
        if conc_fn is None:
            return 0.0
        pt_flows = []
        for tensor, src_view, dst_view in flows:
            if src_view is None or dst_view is None:
                continue
            if src_view.hash() == dst_view.hash():
                continue
            total = _vol(tensor.material_shape()) * tensor.data_type.size
            if total <= 0:
                continue
            dst_ids = dst_view.device_ids()
            per_dst = total / max(1, len(dst_ids))
            pt_flows.append((per_dst, src_view.start_device_id,
                             dst_view.start_device_id))
        if len(pt_flows) < 2:
            return 0.0
        key = ("conc", tuple(sorted(pt_flows)))
        cached = self._xfer_cache.get(key)
        if cached is not None:
            return cached
        together = conc_fn(pt_flows)
        alone = max(conc_fn([f]) for f in pt_flows)
        penalty = max(0.0, together - alone)
        self._xfer_cache[key] = penalty
        return penalty

    def parallel_op_cost(self, op: PCGOp, view=None) -> float:
        """Cost of an explicit parallel op node (reshard collectives),
        priced through the machine model's collective methods so a
        topology-aware machine (hop distances, DCN hierarchy) changes the
        number — the reference's EnhancedMachineModel routes these through
        its per-link comm devices (machine_model.cc)."""
        t = op.op_type
        if t not in PARALLEL_OP_TYPES:
            return 0.0
        x = op.inputs[0]
        total = _vol(x.material_shape()) * x.data_type.size
        m = self.machine

        def group(deg):
            if view is not None:
                ids = view.device_ids()
                if len(ids) >= deg:
                    return ids[:deg]
            return range(deg)

        if self.objective == CostObjective.DECODE:
            # per-token messages over the latency-bound collective model:
            # one decode step moves the 1-token slice, and at KB sizes the
            # ring's hop latency (not bandwidth) is the price — the term
            # that makes a per-token all-reduce on the critical path
            # costly no matter how narrow the message is
            total /= max(1, _seq_extent(x))
            if t == OperatorType.OP_REPLICATE:
                deg = op.params.replicate_degree
                return m.latency_bound_collective_cost(
                    "replicate", total, group(deg))
            if t == OperatorType.OP_REDUCTION:
                deg = op.params.reduction_degree
                return m.latency_bound_collective_cost(
                    "allreduce", total / deg, group(deg))
            if t == OperatorType.OP_ALL_TO_ALL:
                deg = op.params.degree
                return m.latency_bound_collective_cost(
                    "all_to_all", total, group(deg))
            if t == OperatorType.OP_WEIGHT_SHARD:
                # decode pays ONE gather-on-use of the full weight per
                # token (no backward re-gather, no gradient
                # reduce-scatter) — still ruinous at batch 1, which is
                # why the decode search avoids FSDP nodes
                from ..parallel.weight_sharding import \
                    shard_target_weight_bytes

                deg = op.params.shard_degree
                wbytes = shard_target_weight_bytes(op)
                return m.latency_bound_collective_cost(
                    "all_gather", wbytes, group(deg))
            deg = getattr(op.params, "repartition_degree",
                          getattr(op.params, "combine_degree", 2))
            return m.latency_bound_collective_cost(
                "reshard", total, group(deg))

        if t == OperatorType.OP_WEIGHT_SHARD:
            # FSDP/ZeRO per-step collectives over the TARGET op's full
            # weight bytes (parallel/weight_sharding.py): all-gather the
            # sharded params on use in the forward AND the backward, plus
            # one reduce-scatter of the weight gradients — 3(p-1)/p wire
            # bytes vs the replicated strategy's 2(p-1)/p all-reduce
            # (which measure_operator_cost's sync term stops charging once
            # the weight is sharded). Strictly slower on runtime, so only
            # the memory-lambda loop picks it.
            from ..parallel.weight_sharding import shard_target_weight_bytes

            deg = op.params.shard_degree
            wbytes = shard_target_weight_bytes(op)
            g = group(deg)
            return (2.0 * m.all_gather_cost(wbytes, g)
                    + m.reduce_scatter_cost(wbytes, g))
        if t == OperatorType.OP_REPLICATE:
            deg = op.params.replicate_degree
            return m.replicate_cost(total, group(deg))
        if t == OperatorType.OP_REDUCTION:
            deg = op.params.reduction_degree
            return m.allreduce_cost(total / deg, group(deg))
        if t == OperatorType.OP_ALL_TO_ALL:
            deg = op.params.degree
            return m.all_to_all_cost(total, group(deg))
        deg = getattr(op.params, "repartition_degree",
                      getattr(op.params, "combine_degree", 2))
        return m.reshard_cost(total, group(deg))
