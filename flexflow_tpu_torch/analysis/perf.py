"""Static performance analysis (the FFA5xx pass family).

The PyTorch counterpart of flexflow_tpu/analysis/perf.py.

The search trusts its cost model; the JAX package makes that trust
load-bearing by letting the search DISCOUNT weight-grad collectives it believes will
hide behind backward compute, and by running an overlapped
reduce-scatter / sharded-update / all-gather step with donated buffers.
These passes audit the CHOSEN strategy before it executes:

  * FFA500 — oracle provenance (INFO): when the audited cost model is
    calibrated from measurement (obs/calibration.py store or an
    in-process profile), one line names the source so FFA501/FFA503
    numbers are read as measured, not analytic.
  * FFA501 — overlap-discount soundness: recompute the statically
    hideable backward-compute window behind every discounted collective
    (analysis/collectives.hideable_backward_compute) and flag discounts
    the schedule cannot actually realize, with the exposed-time delta
    the search is blind to. Per-collective overshoot is a WARNING (the
    per-op seam is a calibrated approximation); a discount on a
    collective the schedule keeps serial, or an aggregate discount the
    whole backward pass cannot absorb, is an ERROR — the search lied to
    itself.
  * FFA502 — static overlap race/aliasing detection over the modelled
    executor schedule (analysis/schedule.py; run via the "schedule"
    pass / an executor's ``overlap_schedule()`` hook).
  * FFA503 — roofline/padding diagnostics: ops whose SHARD shape pays
    tile padding the unsharded shape would not (the cost model's
    sublane/lane quantization rule, read from the audited machine's chip
    spec: the H100's measured quanta pad k and n to 128 and leave rows
    alone), with a fix_hint naming the degree change that removes the
    padding.
  * FFA504 — slice-boundary collective lint: collectives whose ring
    crosses a node (slice) boundary while the machine model prices a
    flat mesh (the static precondition for hierarchical multi-slice
    search, ROADMAP item 4); under a topology-aware machine,
    non-contiguous rings are reported with their torus hop factor.
  * FFA505 — all-to-all / collective-bytes coverage (lives in
    analysis/collectives.py next to the per-op collective checks:
    unknown collective kinds are a typed warning instead of a silent
    estimate skip, and the all-to-all kind is modelled + exported).
  * FFA506 — overlap REALIZATION (the measured counterpart of FFA501):
    given a step-observatory capture (obs/step_profile.py), compare the
    measured hidden-vs-exposed split of the weight-grad collectives
    against the discount's assumed overlap_efficiency — a realized
    ratio materially below the assumption means the search priced
    overlap the silicon does not deliver
    (``overlap_realization_diagnostics``).
  * FFA507 — expert-capacity token dropping (WARNING): a group_by whose
    declared capacity factor gives n_experts x capacity fewer slots than
    the tokens x top_k assignments routed into it — the dispatch mask
    statically drops the overflow every step (GShard-style token
    dropping; fine if intended, silent accuracy loss if not).
  * FFA508 — expert-capacity indivisibility (ERROR): the per-expert
    capacity dim does not divide by the expert-parallel degree — either
    a sharded capacity dim with a non-dividing degree, or a declared
    config.expert_parallel_degree the strategy pass would silently skip
    (parallel/strategies.apply_expert_parallel's divisibility guard).
  * FFA509 — decode-objective roofline lints (WARNING; only under
    ``objective="decode"``): an attention op whose weight shard degree
    exceeds its KV head count (the extra ways buy no HBM bandwidth),
    or a per-token collective whose fixed ring latency exceeds the
    decode-roofline compute of the op feeding it (the single-token
    step is latency-bound, not HBM-bound) — fix_hint names the
    cheaper degree in both cases.

The FFA6xx family audits fault-domain ROBUSTNESS of the strategy on
multi-slice machines (search/survivability.py; runtime counterpart in
runtime/fault_domains.py):

  * FFA600 — survivability summary (INFO): the strategy spans slices
    and only data-parallel replicas cross the boundary — a whole-slice
    loss shrinks the run instead of forcing a full reshard.
  * FFA601 — slice-loss survivability (WARNING): an op shards weights
    across the slice boundary; losing any one slice takes shard pieces
    that exist nowhere else and recovery needs a full reshard/restore
    from checkpoint. The search's configurable penalty
    (config.search_survivability_penalty) biases away from this; the
    lint reports what remains.

Entry: ``perf_diagnostics(graph, views, cost_model=..., executor=...)``;
wired into ``analyze_graph``/``analyze_model`` as the "perf" and
"schedule" passes, into ``compile()`` (core/model.py warns on errors
after the strategy search), into ``fit(lint=...)``, the
``python -m flexflow_tpu_torch.analysis`` CLI, and ``obs.explain_strategy()``
(each ranked op carries its FFA5xx diagnostics).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..ff_types import OperatorType
from .collectives import _COLLECTIVE_OF, _view_of
from .diagnostics import AnalysisReport, Severity

# relative/absolute slack before a discount overshoot is reported: the
# per-op seam and the schedule window are both analytic, so hold back on
# float-noise-sized deltas
_REL_TOL = 1e-6
_ABS_TOL_S = 1e-9

# ops with an MXU (systolic-array) shape, i.e. a tile-quantized cost
# (search/cost_model.op_padded_flops)
_MXU_OPS = frozenset({
    OperatorType.OP_LINEAR,
    OperatorType.OP_CONV2D,
    OperatorType.OP_BATCHMATMUL,
    OperatorType.OP_MULTIHEAD_ATTENTION,
})


def perf_diagnostics(
    graph,
    views: Optional[Dict] = None,
    *,
    cost_model=None,
    machine=None,
    num_devices: Optional[int] = None,
    executor=None,
    expert_degree: int = 1,
    objective: str = "train",
) -> AnalysisReport:
    """Run the FFA5xx static performance passes over a placed strategy.

    cost_model: the search's cost oracle (enables FFA501 and the
    roofline numbers in FFA503; its machine model feeds FFA504).
    machine: explicit MachineModel when no cost model is at hand.
    executor: a live PCGExecutor — its ``overlap_schedule()`` hook is
    audited for FFA502 races.
    expert_degree: a declared config.expert_parallel_degree, audited
    against expert capacities for FFA508 even when the strategy pass
    skipped applying it.
    objective: the cost objective the strategy was searched under
    ("train" or "decode"); "decode" enables the FFA509 decode-roofline
    lints (head over-sharding, latency-dominated per-token collectives).
    """
    rep = AnalysisReport()
    views = views or {}
    if machine is None and cost_model is not None:
        machine = cost_model.machine
    if cost_model is not None:
        _oracle_provenance_diagnostic(cost_model, rep)
        if objective != "decode":
            # the overlap discount hides weight-grad collectives behind
            # BACKWARD compute; decode has no backward pass to hide
            # anything behind, so the soundness audit does not apply
            _overlap_discount_diagnostics(graph, views, cost_model, rep)
    if objective == "decode":
        _decode_objective_diagnostics(graph, views, cost_model, machine,
                                      rep)
    _padding_roofline_diagnostics(graph, views, machine, rep)
    _expert_capacity_diagnostics(graph, rep,
                                 expert_degree=expert_degree)
    if machine is not None:
        _topology_cost_diagnostics(graph, views, machine, rep)
        if machine.num_nodes > 1:
            # FFA6xx fires only where a slice boundary exists — single-
            # node machines have no fault domain to lose
            _survivability_diagnostics(graph, views, machine, rep)
    if executor is not None:
        sched = executor.overlap_schedule()
        if sched is not None:
            from .schedule import schedule_race_diagnostics

            rep.extend(schedule_race_diagnostics(sched))
    return rep


# ----------------------------------------------------------------------
# oracle provenance (calibrated vs analytic)
# ----------------------------------------------------------------------
def _oracle_provenance_diagnostic(cost_model, rep: AnalysisReport) -> None:
    """One INFO line naming the oracle every FFA5xx verdict below was
    judged against. When a calibration store / profiled table is
    attached (obs.explain.attach_profiled_costs), the overlap and
    roofline numbers come from MEASURED per-op seconds, not the analytic
    roofline — a reader triaging an FFA501 error needs to know which."""
    source = getattr(cost_model, "calibration_source", None)
    if source is None:
        return
    prov = (cost_model.provenance() if hasattr(cost_model, "provenance")
            else {"source": source})
    n = prov.get("measured_ops", len(getattr(cost_model, "measured", ())))
    rep.add(
        Severity.INFO, "FFA500",
        f"cost oracle is calibrated from {source} ({n} measured op "
        "entr" + ("y" if n == 1 else "ies") + "); serial-view op costs "
        "below are measured seconds, sharded views fall back to the "
        "analytic roofline",
    )


# ----------------------------------------------------------------------
# FFA501 — overlap-discount soundness
# ----------------------------------------------------------------------
def _overlap_discount_diagnostics(graph, views, cost_model,
                                  rep: AnalysisReport) -> None:
    if not getattr(cost_model, "overlap_backward_update", False):
        return
    from ..pcg.machine_view import MachineView

    from .collectives import (
        hideable_backward_compute,
        overlappable_grad_syncs,
    )

    eff = min(max(float(getattr(cost_model, "overlap_efficiency", 1.0)),
                  0.0), 1.0)
    overlappable = overlappable_grad_syncs(graph)
    windows = hideable_backward_compute(graph, views, cost_model)
    v1 = MachineView(start_device_id=0, dim=(1,), stride=(1,))
    total_hidden = 0.0
    max_window = 0.0
    for op in graph.topo_order():
        v = _view_of(op, views) or v1
        cm = cost_model.measure_operator_cost(op, v)
        hidden = cm.hidden_sync_time
        if hidden <= 0.0:
            continue
        if op.guid not in overlappable:
            # the structural proof (analysis/collectives.
            # overlappable_grad_syncs) excludes this op — e.g. its
            # reduce-scatter is owned by an FSDP WeightShard node — so
            # the overlapped simulator keeps the sync SERIAL while the
            # per-op cost discounted it: the two halves of the search
            # disagree about the same collective
            rep.add(
                Severity.ERROR, "FFA501",
                f"the cost model discounted {hidden * 1e3:.3f} ms of "
                f"this op's {cm.sync_time * 1e3:.3f} ms gradient sync, "
                "but the collective is NOT statically overlappable "
                "(overlappable_grad_syncs excludes it) — the schedule "
                f"keeps it serial; exposed-time delta {hidden * 1e3:.3f} "
                "ms", op=op,
                fix_hint="exclude the op from the discount (FSDP-owned "
                         "and activation-path collectives keep their "
                         "full price)",
            )
            continue
        total_hidden += hidden
        window = eff * windows.get(op.guid, 0.0)
        max_window = max(max_window, window)
        delta = hidden - window
        if delta > max(_ABS_TOL_S, _REL_TOL * cm.sync_time):
            rep.add(
                Severity.WARNING, "FFA501",
                f"search discount hides {hidden * 1e3:.3f} ms of this "
                f"op's gradient sync, but only "
                f"{window * 1e3:.3f} ms of backward compute is "
                "statically schedulable behind it "
                f"(eff={eff:.2f}); exposed-time delta "
                f"{delta * 1e3:.3f} ms the simulated step time omits",
                op=op,
                fix_hint="lower overlap_efficiency (calibration) or "
                         "accept the optimism for mid-stack ops — the "
                         "aggregate check below is the hard bound",
            )
    if total_hidden > max_window + max(_ABS_TOL_S, _REL_TOL * total_hidden):
        # the comm channel serializes: every discounted collective must
        # fit inside the LARGEST hideable window — if the total claimed
        # hidden time exceeds it, no schedule can realize the discount
        rep.add(
            Severity.ERROR, "FFA501",
            f"aggregate overlap discount {total_hidden * 1e3:.3f} ms "
            f"exceeds the largest statically hideable backward window "
            f"{max_window * 1e3:.3f} ms (eff={eff:.2f}) — the searched "
            "strategy's simulated step time is unrealizable; exposed-"
            f"time delta {(total_hidden - max_window) * 1e3:.3f} ms",
            fix_hint="disable search_overlap_backward_update for this "
                     "graph or re-search with a calibrated "
                     "overlap_efficiency",
        )


# ----------------------------------------------------------------------
# FFA509 — decode-objective roofline lints
# ----------------------------------------------------------------------
def _decode_objective_diagnostics(graph, views, cost_model, machine,
                                  rep: AnalysisReport) -> None:
    """Audit a strategy searched under objective="decode" for the two
    ways a decode placement goes wrong that the HBM-roofline cost model
    can misprice:

      * head over-sharding — an attention op whose weight shard degree
        exceeds the head count: the extra ways cannot split any more
        KV heads, so each step pays the collective for a degree that
        buys no additional HBM bandwidth.
      * latency-dominated per-token collectives — a collective op on
        the single-token critical path whose fixed ring latency
        ((n-1)·max link latency) exceeds the decode-roofline compute of
        the op feeding it: the step is waiting on wire latency, not on
        HBM, and a lower degree is strictly cheaper.
    """
    from ..search.cost_model import op_decode_bytes

    if machine is None:
        return
    # --- head over-sharding -------------------------------------------
    for op in graph.topo_order():
        if op.op_type != OperatorType.OP_MULTIHEAD_ATTENTION:
            continue
        heads = int(getattr(op.params, "num_heads", 0) or 0)
        if heads <= 0 or not op.weights:
            continue
        head_deg = max(max(1, w.get_total_degree()) for w in op.weights)
        if head_deg > heads:
            best = max((d for d in range(1, heads + 1)
                        if head_deg % d == 0), default=1)
            rep.add(
                Severity.WARNING, "FFA509",
                f"decode-objective strategy shards attention weights "
                f"{head_deg}-way but the op has only {heads} KV heads — "
                f"the extra {head_deg // max(1, best)}x ways split no "
                "additional heads, so each decode token pays the wider "
                "collective without streaming any less KV per chip",
                op=op,
                fix_hint=f"reduce the weight shard degree {head_deg} -> "
                         f"{best} (a divisor within the {heads}-head "
                         "budget); replicate the remainder instead",
            )
    # --- latency-dominated per-token collectives ----------------------
    producer: Dict[int, object] = {}
    for op in graph.topo_order():
        for t in op.outputs:
            producer[t.guid] = op
    hbm_bw = machine.chip.hbm_bandwidth * machine.hbm_efficiency
    for op in graph.topo_order():
        kind = _COLLECTIVE_OF.get(op.op_type)
        if kind is None or not op.inputs:
            continue
        v = _view_of(op, views or {})
        if v is None:
            continue
        ids = list(v.device_ids())
        n = len(ids)
        if n <= 1:
            continue
        max_lat = max(machine.link_latency(ids[i], ids[(i + 1) % n])
                      for i in range(n))
        latency = (n - 1) * max_lat
        src = producer.get(op.inputs[0].guid)
        if src is None:
            continue
        sv = _view_of(src, views or {})
        parts = sv.num_parts() if sv is not None else 1
        # decode-roofline compute of the feeding op: the HBM time ONE
        # token's step spends streaming that op's bytes per device
        compute = op_decode_bytes(src) / max(1, parts) / hbm_bw
        if latency <= compute or latency <= 0.0:
            continue
        # cheapest degree whose ring latency fits under the compute it
        # amortizes: (d-1)·max_lat <= compute, snapped to a divisor of n
        fit = int(compute / max_lat) + 1 if max_lat > 0 else 1
        best = max((d for d in range(1, min(n, max(1, fit)) + 1)
                    if n % d == 0), default=1)
        rep.add(
            Severity.WARNING, "FFA509",
            f"per-token {kind} over {n} devices costs "
            f"{latency * 1e6:.2f} us of ring latency but the op feeding "
            f"it ({src.name}) only has {compute * 1e6:.2f} us of decode-"
            "roofline compute per token — the single-token step is "
            "latency-bound on this collective, not HBM-bound",
            op=op,
            fix_hint=f"reduce the degree {n} -> {best}: "
                     f"({best - 1})x{max_lat * 1e6:.2f} us of latency "
                     "fits under the compute it amortizes",
        )


# ----------------------------------------------------------------------
# FFA506 — overlap realization (measured, from the step observatory)
# ----------------------------------------------------------------------
def overlap_realization_diagnostics(profile,
                                    cost_model=None) -> AnalysisReport:
    """The measured counterpart of FFA501: audit a step-observatory
    capture (obs/step_profile.StepProfile) against the overlap
    discount's efficiency assumption. FFA501 proves the discount is
    statically *schedulable*; this pass reports whether the fused step
    actually *realized* it — INFO when measurement and assumption
    agree, WARNING when the realized ratio falls materially below the
    assumed overlap_efficiency (the search is pricing overlap the
    hardware does not deliver), plus a WARNING naming the most-exposed
    collective so the calibration loop has a worklist entry."""
    rep = AnalysisReport()
    assumed = float(getattr(cost_model, "overlap_efficiency",
                            profile.assumed_efficiency)
                    if cost_model is not None
                    else profile.assumed_efficiency)
    realized = profile.realized_ratio
    if realized is None:
        rep.add(
            Severity.INFO, "FFA506",
            "no weight-grad collectives measured (data degree "
            f"{profile.data_degree}) — nothing for the overlap discount "
            "to hide, realization not applicable",
        )
        return rep
    rep.add(
        Severity.INFO, "FFA506",
        f"measured overlap realization {realized:.2f} "
        f"(hidden {profile.hidden_sync_s * 1e3:.3f} ms of "
        f"{profile.total_sync_s * 1e3:.3f} ms collective time; fused "
        f"step {profile.step_wall_s * 1e3:.3f} ms vs serial "
        f"{profile.serial_step_wall_s * 1e3:.3f} ms) against assumed "
        f"overlap_efficiency {assumed:.2f} [{profile.mode}, "
        f"{profile.backend}]",
    )
    # hold back on noise: require both a relative shortfall and a
    # measurable absolute amount of exposed time before accusing the
    # discount of optimism
    if realized < assumed - 0.1 and \
            profile.total_sync_s - profile.hidden_sync_s > 1e-6:
        rep.add(
            Severity.WARNING, "FFA506",
            f"the search prices overlap at efficiency {assumed:.2f} but "
            f"the fused step realized only {realized:.2f} — "
            f"{(profile.total_sync_s - profile.hidden_sync_s) * 1e3:.3f} "
            "ms of collective time stays exposed that the simulated "
            "step time omits",
            fix_hint="write the measured efficiency through the "
                     "calibration store (StepProfile.write_calibration) "
                     "and re-search",
        )
        exposed = [c for c in profile.collectives if c.overlappable]
        if exposed:
            worst = max(exposed, key=lambda c: c.exposed_s)
            if worst.exposed_s > 0:
                rep.add(
                    Severity.WARNING, "FFA506",
                    f"most-exposed collective: {worst.op}.grad_sync "
                    f"({worst.kind}, {worst.wire_bytes} wire bytes) — "
                    f"{worst.exposed_s * 1e3:.3f} ms of its "
                    f"{worst.sync_s * 1e3:.3f} ms stays exposed",
                )
    return rep


# ----------------------------------------------------------------------
# FFA503 — roofline / sharding-induced padding
# ----------------------------------------------------------------------
def _tile_waste(extent: int, quantum: int) -> float:
    return math.ceil(max(1, extent) / quantum) * quantum / max(1, extent)


def _padding_roofline_diagnostics(graph, views, machine,
                                  rep: AnalysisReport) -> None:
    from ..search.cost_model import op_bytes, op_flops
    from ..search.machine_model import H100_SPEC

    # the tile quanta of the chip the cost model prices (the quanta
    # op_padded_flops pads shards to), else the H100's: the lint and the
    # cost model agree on what a shard pays. H100_SPEC's are 128 lanes
    # and 1 sublane (search/machine_model.py, from a sweep on the card):
    # on it only a shard's minor-most extent pads
    chip = machine.chip if machine is not None else H100_SPEC
    lanes = max(1, int(getattr(chip, "mxu_lanes", 1)))
    sublanes = max(1, int(getattr(chip, "mxu_sublanes", 1)))
    ridge = chip.peak_flops_bf16 / chip.hbm_bandwidth
    seen = set()
    for op in graph.topo_order():
        if op.op_type not in _MXU_OPS or not op.outputs:
            continue
        tensors = [("output", op.outputs[0])]
        if op.inputs:
            tensors.append(("input", op.inputs[0]))
        for role, t in tensors:
            material = [(i, d) for i, d in enumerate(t.dims)
                        if not d.is_replica_dim]
            rank = len(material)
            for mi, (di, d) in enumerate(material):
                if d.degree <= 1 or d.size % d.degree != 0:
                    continue
                # tile quantization — the SAME quanta op_padded_flops
                # prices shards at: lanes on the minormost dim, sublanes
                # on the second-minormost
                quantum = lanes if mi == rank - 1 else \
                    sublanes if mi == rank - 2 else None
                if quantum is None:
                    continue
                if (t.guid, di) in seen:
                    continue
                shard = d.size // d.degree
                waste_shard = _tile_waste(shard, quantum)
                waste_full = _tile_waste(d.size, quantum)
                if waste_shard < 1.5 or waste_shard < 1.5 * waste_full:
                    continue  # padding not sharding-induced (or minor)
                seen.add((t.guid, di))
                deg = t.get_total_degree()
                useful = op_flops(op) / max(1, deg)
                nbytes = op_bytes(op) / max(1, deg)
                intensity = useful / max(1.0, nbytes)
                bound = ("HBM-bound" if intensity < ridge
                         else "padding-bound")
                fix = _padding_fix_hint(role, di, d.size, d.degree,
                                        quantum)
                rep.add(
                    Severity.WARNING, "FFA503",
                    f"{role} dim {di} shard extent {shard} pads to "
                    f"{int(_tile_waste(shard, quantum) * shard)} on the "
                    f"tensor cores ({waste_shard:.1f}x cost; the unsharded extent "
                    f"{d.size} wastes only {waste_full:.1f}x) — the "
                    f"{d.degree}-way sharding drove this op {bound} "
                    f"(useful intensity {intensity:.0f} flops/B vs "
                    f"ridge {ridge:.0f})",
                    op=op, fix_hint=fix,
                )


def _padding_fix_hint(role: str, dim: int, size: int, degree: int,
                      quantum: int) -> str:
    for d in range(degree - 1, 0, -1):
        if degree % d == 0 and (size // d) % quantum == 0:
            return (f"reduce {role} dim {dim} degree {degree} -> {d} "
                    f"(shard extent {size // d} is a multiple of "
                    f"{quantum})")
    return (f"no divisor of {degree} shards {size} into {quantum}-"
            f"multiples; unshard dim {dim} or pad it to a multiple of "
            f"{quantum * degree}")


# ----------------------------------------------------------------------
# FFA507/FFA508 — expert capacity (token dropping + divisibility)
# ----------------------------------------------------------------------
def _expert_capacity_diagnostics(graph, rep: AnalysisReport, *,
                                 expert_degree: int = 1) -> None:
    """Audit every group_by dispatch for statically-decided capacity
    hazards. Both verdicts read only the graph: capacity is baked into
    the group_by output shape at build time, so dropped tokens and
    non-dividing shards are knowable before a single step runs."""
    for op in graph.ops:
        if op.op_type != OperatorType.OP_GROUP_BY or not op.outputs:
            continue
        n = getattr(op.params, "n", len(op.outputs))
        alpha = getattr(op.params, "alpha", 1.0)
        cap = op.outputs[0].dims[0].size
        if len(op.inputs) > 1 and len(op.inputs[1].dims) >= 2:
            tokens = op.inputs[1].dims[0].size
            top_k = op.inputs[1].dims[-1].size
            routed = tokens * top_k
            slots = n * cap
            if slots < routed:
                rep.add(
                    Severity.WARNING, "FFA507",
                    f"expert dispatch '{op.name}' declares capacity "
                    f"factor {alpha:g}: {n} experts x {cap} slots = "
                    f"{slots} for {routed} routed assignments "
                    f"({tokens} tokens x top-{top_k}) — "
                    f"{routed - slots} assignments are statically "
                    "dropped every step",
                    op=op,
                    fix_hint="raise the capacity factor to >= 1.0 for "
                             "dropless routing, or keep it if GShard-"
                             "style token dropping is intended",
                )
        degrees = {expert_degree} if expert_degree > 1 else set()
        degrees.update(t.dims[0].degree for t in op.outputs
                       if t.dims and t.dims[0].degree > 1)
        for deg in sorted(degrees):
            if cap % deg != 0:
                rep.add(
                    Severity.ERROR, "FFA508",
                    f"expert dispatch '{op.name}': per-expert capacity "
                    f"{cap} does not divide by expert-parallel degree "
                    f"{deg} — the capacity dim cannot be sharded "
                    "evenly (strategies.apply_expert_parallel silently "
                    "skips this op; a hand-placed shard would be "
                    "ragged)",
                    op=op,
                    fix_hint=f"pick a capacity factor making the "
                             f"capacity a multiple of {deg}, or lower "
                             "the expert-parallel degree to a divisor "
                             f"of {cap}",
                )


# ----------------------------------------------------------------------
# FFA504 — slice-boundary collective cost
# ----------------------------------------------------------------------
def _topology_cost_diagnostics(graph, views, machine,
                               rep: AnalysisReport) -> None:
    hierarchical = bool(getattr(machine, "hierarchical", False))
    for op in graph.topo_order():
        kind = _COLLECTIVE_OF.get(op.op_type)
        if kind is None:
            continue
        v = _view_of(op, views or {})
        if v is None:
            continue
        ids = list(v.device_ids())
        if len(ids) <= 1:
            continue
        per_slice: Dict[int, List[int]] = {}
        for d in ids:
            per_slice.setdefault(machine.node_of(d), []).append(d)
        if len(per_slice) > 1 and not hierarchical:
            sizes = {s: len(v2) for s, v2 in sorted(per_slice.items())}
            rep.add(
                Severity.WARNING, "FFA504",
                f"{kind} ring spans {len(per_slice)} slices "
                f"(devices per slice {sizes}) but the flat machine "
                "model prices every link at NVLink bandwidth "
                f"({machine.ici_bandwidth / 1e9:.0f} GB/s); the network "
                f"crossings ({machine.dcn_bandwidth / 1e9:.0f} GB/s) "
                "make the search's cost for this collective fiction",
                op=op,
                fix_hint="set machine_model_version = 1 / topology_dims "
                         "in the machine config (e.g. "
                         "machine_config_multislice) so collectives "
                         "decompose into intra-node + network phases",
            )
        elif hierarchical and hasattr(machine, "ring_hop_factor"):
            # torus routing (search/network.py): a ring whose neighbors
            # are multi-hop pays per-step hop cost a contiguous ring
            # would not — priced correctly here, surfaced so strategies
            # with scattered placements are explainable
            max_hops, _ = machine.ring_hop_factor(ids)
            if max_hops >= 2:
                rep.add(
                    Severity.INFO, "FFA504",
                    f"{kind} ring neighbors are up to {int(max_hops)} "
                    "link hops apart on the node topology — per-step cost "
                    f"scales ~{int(max_hops)}x vs a contiguous ring "
                    "(priced by the topology model; a contiguous "
                    "placement would be cheaper)",
                    op=op,
                )


# ----------------------------------------------------------------------
# FFA600/FFA601 — slice-loss survivability
# ----------------------------------------------------------------------
def _survivability_diagnostics(graph, views, machine,
                               rep: AnalysisReport) -> None:
    from ..search.survivability import (
        CROSS_SLICE_SHARDED,
        strategy_survivability,
    )

    s = strategy_survivability(graph, views or {}, machine=machine)
    for o in s.ops:
        if o.status != CROSS_SLICE_SHARDED:
            continue
        op = next((x for x in graph.topo_order() if x.guid == o.guid), None)
        rep.add(
            Severity.WARNING, "FFA601",
            f"strategy not slice-loss-survivable: op {o.name} shards "
            f"weights {o.partition_degree}-way across slices "
            f"{list(o.spanned_slices)} (per-slice devices "
            f"{list(o.per_slice_devices)}, "
            f"{o.weight_bytes / 1e6:.2f} MB of parameters); losing any "
            "one slice destroys weight shards held nowhere else — "
            "recovery requires a full reshard/restore from checkpoint "
            "instead of dropping a data-parallel replica",
            op=op,
            fix_hint="confine the model/FSDP sharding within one slice "
                     f"(weight partition degree <= "
                     f"{machine.workers_per_node} devices/slice) and let "
                     "only data-parallel replication cross the network "
                     "boundary; search_survivability_penalty > 0 biases "
                     "the search this way",
        )
    if s.survivable and s.spans_slices and s.total_weight_bytes > 0:
        rep.add(
            Severity.INFO, "FFA600",
            f"strategy is slice-loss-survivable: every weight shard set "
            f"is complete within one slice across all "
            f"{s.num_slices} slices — a whole-slice loss only drops "
            "data-parallel replicas and the run shrinks onto the "
            "survivors",
        )


# ----------------------------------------------------------------------
# joins for obs/explain.py
# ----------------------------------------------------------------------
def diagnostics_by_op(report: AnalysisReport) -> Dict[int, List]:
    """op guid -> [Diagnostic] (graph-level findings land under None)."""
    out: Dict[int, List] = {}
    for d in report:
        out.setdefault(d.op_guid, []).append(d)
    return out
