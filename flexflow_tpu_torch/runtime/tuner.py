"""Self-healing strategy adaptation: close the measure -> act loop the
observatory opened.

The PyTorch counterpart of flexflow_tpu/runtime/tuner.py, for training.
The Unity search (core/model.py compile) runs once, against a cost model
that the step observatory (obs/step_profile.py) and per-op calibration
(obs/explain.py) routinely prove wrong mid-run: machines drift, the
shipped machine model was never right for this cluster, the workload's
MoE routing shifted. The StrategyTuner watches the telemetry the system
already emits, re-runs the strategy search in a background thread under
the drift-corrected cost model, and -- when the simulated win is worth it
-- hot-swaps the executor at a step boundary TRANSACTIONALLY: host-gather
snapshot, name-matched reshard onto the candidate strategy (bit-exact,
asserted by checksum), a canary step cross-checked against the pre-swap
executor, and a post-swap guard window on measured step time. Any
failure on that path rolls back to the pre-swap strategy and quarantines
the candidate; training never dies to the tuner.

State machine::

    IDLE --drift(hysteresis,cooldown)--> SEARCHING (background thread)
    SEARCHING --crash--------------------------> IDLE   [rolled_back]
    SEARCHING --lint fail / win < min_win /
                already quarantined-------------> IDLE   [quarantined]
    SEARCHING --candidate + win >= min_win------> swap at next boundary
    swap --reshard checksum mismatch / canary
           divergence / executor throw----------> IDLE   [rolled_back]
    swap --ok-----------------------------------> POST_SWAP (guard window)
    POST_SWAP --step EMA regression > guard_band-> IDLE  [rolled_back]
    POST_SWAP --N clean steps-------------------> IDLE   [committed]

Every cycle ends in exactly one ``ff_strategy_swaps_total{outcome}``
increment -- committed, rolled_back or quarantined -- so the counter
accounts for every attempt with no silent outcomes. Rolled-back and
failed candidates are quarantined by strategy fingerprint and never
retried within the run (thrash-proofing), and every trigger obeys
hysteresis + cooldown so transient noise cannot launch a re-search.

FaultInjector sites (runtime/resilience.py) make each failure leg
testable: ``swap_research_crash`` (background search dies),
``swap_reshard_corruption`` (a transplanted weight is corrupted before
the checksum gate), ``swap_regression`` (post-swap measured step time is
inflated past the guard band).

On a process group every rank runs the same machine on the same inputs:
rank 0's measured step times (and probe) are broadcast, so every rank's
drift score, trigger and guard-window verdict agree; rank 0 alone runs
the background search, and its winner reaches the other ranks as an
artifact-store payload replayed onto their own lowering; each swap gate
is agreed across the ranks before the next collective, and a gate that
fails on any rank rolls back on all. The background thread does no
device work: the search prices candidates with the drift-corrected cost
model from host data (calibration probes run on the main thread at a
step boundary).
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import obs
from ..parallel.mesh import full, is_dtensor, local
from . import distributed as rdist

logger = logging.getLogger("flexflow_tpu_torch.tuner")

SWAP_METRIC = "ff_strategy_swaps_total"
SWAP_METRIC_HELP = ("Strategy hot-swap cycles by outcome "
                    "(committed|rolled_back|quarantined) and leg "
                    "(train|serving); every tuner cycle increments "
                    "exactly one outcome")
DRIFT_GAUGE = "ff_tuner_drift_score"
DRIFT_GAUGE_HELP = ("Current drift score: max of step-time slowdown vs "
                    "baseline and per-op calibration error; the tuner "
                    "triggers a re-search when it stays above "
                    "drift_threshold for hysteresis_steps synced steps")


class SwapError(RuntimeError):
    """A transactional strategy swap failed one of its gates (reshard
    checksum, canary, executor build or dispatch) and was rolled back."""


@dataclasses.dataclass
class TunerConfig:
    """Knobs for fit(tuner=...).

    The trigger: ``drift_score = max(slowdown, miscalibration)`` where
    slowdown is the measured step-time EMA relative to the best EMA seen
    (0.1 = 10% slower) and miscalibration is the worst per-op-class
    measured/simulated deviation from an applied calibration probe. The
    tuner re-searches only after the score exceeds ``drift_threshold``
    for ``hysteresis_steps`` consecutive synced steps, and never within
    ``cooldown_steps`` of a previous cycle."""

    drift_threshold: float = 0.5
    hysteresis_steps: int = 3
    cooldown_steps: int = 10
    # steps of EMA warm-up before the slowdown baseline freezes (first
    # steps pay kernel builds and caching noise)
    warmup_steps: int = 3
    # minimum fractional simulated win a candidate must show over the
    # current strategy (re-simulated under the same refreshed oracle)
    min_win: float = 0.05
    # post-swap measured step EMA may exceed the pre-swap EMA by at most
    # this fraction before the swap is rolled back
    guard_band: float = 0.5
    # length of the post-swap guard window, in synced steps
    post_swap_steps: int = 5
    # post-swap steps excluded from the guard-window EMA before it starts
    # counting: the new executor's first steps pay its warm-up (buffers,
    # caches) -- charging them to the window makes every swap look like
    # a regression
    post_swap_warmup_steps: int = 2
    # background re-search budget (GraphSearchHelper budget)
    search_budget: int = 10
    # run an explain_strategy() calibration probe automatically at this
    # global step (device work, main thread, step boundary); the probe's
    # measurements write through the active CalibrationStore and feed the
    # miscalibration drift signal. None = no automatic probe (feed
    # observe_explanation() yourself, or rely on step-time drift alone).
    probe_after_steps: Optional[int] = None
    probe_repeats: int = 1
    # canary tolerance: the candidate executor's loss on the cached last
    # batch must match the pre-swap executor's within rtol/atol (sharding
    # changes reduction order, so bit-exact loss equality is not expected
    # -- the carried WEIGHTS are checked bit-exactly by checksum instead)
    canary_rtol: float = 0.05
    canary_atol: float = 1e-4
    # hard cap on committed swaps per run (0 = unlimited)
    max_swaps: int = 0


@dataclasses.dataclass
class _SearchOutcome:
    graph: Any = None
    views: Optional[Dict[int, Any]] = None
    cost: Optional[float] = None
    error: Optional[BaseException] = None


def strategy_fingerprint(graph, views) -> str:
    """Stable identity of a (graph, views) strategy: op names/types plus
    their machine views. Used for the quarantine set -- a rolled-back or
    rejected candidate is never retried within the run."""
    views = views or {}
    lines = sorted(
        f"{op.name}|{op.op_type.name}|{views.get(op.guid, getattr(op, 'machine_view', None))}"
        for op in graph.ops
    )
    return hashlib.sha1("\n".join(lines).encode()).hexdigest()[:16]


def _complete_views(graph, views) -> Dict[int, Any]:
    """simulate_runtime indexes views[guid] for every op; complete a
    possibly-partial search result with per-op machine views (serial
    default)."""
    from ..pcg.machine_view import MachineView

    out = {}
    serial = MachineView()
    for op in graph.topo_order():
        v = (views or {}).get(op.guid) or getattr(op, "machine_view", None)
        out[op.guid] = v if v is not None else serial
    return out


def _host_tree(tree):
    """A copy of a nest of dicts/lists with every tensor read whole onto
    the host (a DTensor gathered on every rank) -- the swap's snapshot,
    which must survive the in-place updates of later steps."""
    if isinstance(tree, torch.Tensor):
        return full(tree.detach()).to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return tree


@torch.no_grad()
def _place_into(live: torch.Tensor, src: torch.Tensor) -> None:
    """Write whole host tensor `src` into `live` in place: a DTensor
    keeps this rank's part at its own placements (runtime/checkpoint.py
    `_put_resharded`; no communication)."""
    from .checkpoint import _put_resharded

    if is_dtensor(live):
        local(live).copy_(local(_put_resharded(src, live, strict=False)))
    else:
        live.copy_(src)


class StrategyTuner:
    """The fit()-resident adaptation loop. One instance per fit() call;
    ``fit(tuner=TunerConfig(...))`` constructs and drives it:

    - ``observe_step(dur_s)`` after every SYNCED step (wall time measured
      a whole step);
    - ``on_step_boundary(step, batch)`` between steps -- runs the probe,
      evaluates the trigger, collects background search results, executes
      pending swaps, and polices the post-swap guard window. Returns True
      when the live executor changed (fit must rebuild its step fn).
    On a process group every rank calls both at the same steps."""

    IDLE = "idle"
    SEARCHING = "searching"
    POST_SWAP = "post_swap"

    def __init__(self, model, config: Optional[TunerConfig] = None, *,
                 fault_injector=None, leg: str = "train"):
        self.model = model
        self.cfg = config if config is not None else TunerConfig()
        self.fault = fault_injector
        self.leg = leg
        self.state = self.IDLE
        self.outcomes: Dict[str, int] = {
            "committed": 0, "rolled_back": 0, "quarantined": 0,
        }
        self.quarantined: Set[str] = set()
        self.swap_history: List[dict] = []  # every cycle, with outcome
        # phase seconds of the last swap attempt (build, transplant,
        # canary) and of the last background search
        self.timings: Dict[str, float] = {}
        self._ema: Optional[float] = None
        self._obs_steps = 0
        self._baseline: Optional[float] = None
        self._miscal = 0.0
        self._breach = 0
        self._cooldown_until = -1
        self._probed = False
        self._thread: Optional[threading.Thread] = None
        self._search_result: Optional[_SearchOutcome] = None
        self._candidate: Optional[dict] = None
        self._last_batch: Optional[Tuple] = None
        # POST_SWAP bookkeeping: pre-swap strategy kept for rollback
        self._preswap: Optional[dict] = None
        self._post_seen = 0
        self._post_skipped = 0
        self._post_ema: Optional[float] = None
        self._pre_swap_ema: Optional[float] = None
        self._regress_factor: Optional[float] = None
        # artifact-store plumbing (runtime/artifact_store.py): quarantined
        # fingerprints persist across process restarts and committed
        # winners are written through for fleet-wide reuse
        self._artifact_store = None
        self._quarantine_scope: Optional[str] = None
        # anomaly sentinel over the drift score (obs/anomaly.py): a drift
        # spike that later trips the re-search trigger becomes the tagged
        # cause on tuner_research_started
        from ..obs.anomaly import AnomalySentinel

        self.sentinel = AnomalySentinel()

    # ------------------------------------------------------------------
    # artifact store: persisted quarantines + winner write-through
    # ------------------------------------------------------------------
    def attach_artifact_store(self, store) -> None:
        """Load the persisted quarantine set for this (graph, topology)
        scope and keep the store for write-through. A rolled-back
        candidate quarantined by a PREVIOUS process is then never
        re-proposed after a restart. No-op without a store."""
        if store is None:
            return
        self._artifact_store = store
        parts = getattr(self.model, "_artifact_key", None)
        if not parts:
            # no compile probe (search off): derive the scope the same
            # way compile() would
            try:
                from .artifact_store import graph_fingerprint, topology_digest
                from .elastic import topology_fingerprint

                parts = {
                    "graph": graph_fingerprint(self.model.graph),
                    "topology": topology_digest(topology_fingerprint(
                        None if rdist.is_initialized()
                        else self.model.device)),
                }
            except Exception:
                return
        # calibration deliberately excluded: a re-measured machine does
        # not un-poison a strategy the guard window rejected
        self._quarantine_scope = hashlib.sha1(
            f"{parts['graph']}|{parts['topology']}".encode()
        ).hexdigest()[:20]
        try:
            persisted = store.load_quarantine(self._quarantine_scope)
        except Exception as e:
            logger.warning("tuner: could not load persisted quarantines "
                           "(%r); starting from the in-memory set", e)
            return
        if persisted:
            logger.info("tuner: honoring %d persisted quarantine "
                        "fingerprint(s)", len(persisted))
        self.quarantined |= persisted

    def _quarantine(self, fp: str) -> None:
        """Quarantine a fingerprint in memory AND through the store, so
        the decision survives a process restart (rank 0 writes)."""
        self.quarantined.add(fp)
        if (self._artifact_store is not None and self._quarantine_scope
                and rdist.process_index() == 0):
            try:
                self._artifact_store.add_quarantine(self._quarantine_scope,
                                                    [fp])
            except Exception as e:
                logger.warning("tuner: failed to persist quarantine %s "
                               "(%r)", fp, e)

    def _write_through_winner(self) -> None:
        """A committed swap IS a fresh search result the whole fleet can
        reuse: write it through under compile()'s key so the next boot
        replays the tuned strategy instead of the original winner."""
        store = self._artifact_store
        key = getattr(self.model, "_artifact_key", None)
        if store is None or key is None or rdist.process_index() != 0:
            return
        try:
            from .artifact_store import strategy_payload

            store.put(key, strategy_payload(
                self.model.graph,
                getattr(self.model, "searched_views", None),
                cost=getattr(self.model, "searched_cost", None),
                mesh_axes=dict(self.model.mesh_axes),
                provenance={"writer": "tuner", "leg": self.leg},
            ))
        except Exception as e:
            logger.warning("tuner: winner write-through failed (%r)", e)

    # ------------------------------------------------------------------
    # watch
    # ------------------------------------------------------------------
    def observe_step(self, dur_s: float) -> None:
        """Feed one synced step's wall time (same EMA discipline as
        PCGExecutor.note_step_duration). On a process group rank 0's
        reading is every rank's."""
        if self._regress_factor:
            # injected post-swap regression (swap_regression fault site)
            dur_s *= self._regress_factor
        dur_s = float(rdist.broadcast_object(dur_s))
        if dur_s <= 0:
            return
        self._obs_steps += 1
        self._ema = (dur_s if self._ema is None
                     else 0.5 * self._ema + 0.5 * dur_s)
        if self._obs_steps > self.cfg.warmup_steps:
            self._baseline = (self._ema if self._baseline is None
                              else min(self._baseline, self._ema))
        if self.state == self.POST_SWAP:
            if self._post_skipped < self.cfg.post_swap_warmup_steps:
                # the new executor's warm-up; see
                # TunerConfig.post_swap_warmup_steps
                self._post_skipped += 1
                return
            self._post_seen += 1
            self._post_ema = (dur_s if self._post_ema is None
                              else 0.5 * self._post_ema + 0.5 * dur_s)

    def observe_explanation(self, explanation) -> None:
        """Feed a per-op calibration probe (obs.explain.StrategyExplanation):
        the worst per-op-class measured/simulated deviation becomes the
        miscalibration component of the drift score."""
        worst = 0.0
        for ratio in explanation.calibration_ratios().values():
            if ratio > 0 and np.isfinite(ratio):
                worst = max(worst, max(ratio, 1.0 / ratio) - 1.0)
        self._miscal = worst

    def drift_score(self) -> float:
        slowdown = 0.0
        if self._ema is not None and self._baseline:
            slowdown = max(0.0, self._ema / self._baseline - 1.0)
        return max(slowdown, self._miscal)

    # ------------------------------------------------------------------
    # the boundary hook
    # ------------------------------------------------------------------
    def on_step_boundary(self, step: int, batch: Optional[Tuple] = None
                         ) -> bool:
        """Called by fit() between steps (and by tests directly). `batch`
        is the (inputs_list, labels) host batch just trained on -- cached
        for the canary. Returns True when the model's executor changed
        (commit or rollback) and fit must rebuild its step function."""
        if batch is not None:
            self._last_batch = batch
        self._maybe_probe(step)
        score = self.drift_score()
        obs.gauge_set(DRIFT_GAUGE, score, help=DRIFT_GAUGE_HELP,
                      leg=self.leg)
        self.sentinel.observe("tuner_drift_score", score, min_delta=0.05)
        if self.state == self.IDLE:
            self._evaluate_trigger(step, score)
            return False
        if self.state == self.SEARCHING:
            # rank 0 searches; its thread's end is every rank's
            done = rdist.process_index() == 0 and not self._searching()
            if rdist.any_rank(done):
                return self._collect_search(step)
            return False
        if self.state == self.POST_SWAP:
            return self._police_guard_window(step)
        return False

    def _searching(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _maybe_probe(self, step: int) -> None:
        cfg = self.cfg
        if (cfg.probe_after_steps is None or self._probed
                or step < cfg.probe_after_steps
                or self.state != self.IDLE):
            return
        self._probed = True
        from ..obs.explain import explain_strategy

        t0 = time.perf_counter()
        expl = explain_strategy(self.model, repeats=cfg.probe_repeats,
                                warmup=0)
        tel = obs.active()
        store = getattr(tel, "calibration", None) if tel else None
        expl.apply(self.model, store=store)  # write-through the store
        self.observe_explanation(expl)
        # every rank prices with rank 0's probe
        self._miscal = float(rdist.broadcast_object(self._miscal))
        obs.event("tuner_probe", cat="tuner", step=step,
                  dur_s=round(time.perf_counter() - t0, 4),
                  miscalibration=round(self._miscal, 4))

    def _evaluate_trigger(self, step: int, score: float) -> None:
        cfg = self.cfg
        if step < self._cooldown_until:
            self._breach = 0
            return
        if cfg.max_swaps and self.outcomes["committed"] >= cfg.max_swaps:
            return
        if score > cfg.drift_threshold:
            self._breach += 1
        else:
            self._breach = 0
        if self._breach >= cfg.hysteresis_steps:
            self._breach = 0
            self._start_research(step, score)

    # ------------------------------------------------------------------
    # re-search (background thread)
    # ------------------------------------------------------------------
    def _start_research(self, step: int, score: float) -> None:
        model = self.model
        # refreshed oracle: picks up the probe's _profiled_op_costs and
        # any CalibrationStore globals written through since compile
        cost_model = model._build_cost_model()
        self.state = self.SEARCHING
        self._search_result = None
        self._search_cm = cost_model
        self._search_step = step
        blame = self.sentinel.blame()
        obs.event("tuner_research_started", cat="tuner", step=step,
                  drift_score=round(score, 4), anomaly=blame or "")
        model.search_trajectory.event(
            "tuner_research_started", step=step,
            drift_score=round(score, 4),
        )
        if rdist.process_index() != 0:
            return  # rank 0 searches for every rank
        self._thread = threading.Thread(
            target=self._research_main, args=(step, cost_model),
            name="ff-tuner-research", daemon=True,
        )
        self._thread.start()

    def _research_main(self, step: int, cost_model) -> None:
        out = _SearchOutcome()
        t0 = time.perf_counter()
        try:
            if self.fault is not None:
                plan = self.fault.fire("swap_research_crash", step)
                if plan is not None:
                    raise RuntimeError(
                        "injected background re-search crash "
                        "(swap_research_crash)"
                    )
            out.graph, out.views, out.cost = self._run_search(cost_model)
        except BaseException as e:  # must never kill the training process
            out.error = e
        self.timings["search_s"] = time.perf_counter() - t0
        self._search_result = out

    def _lowering(self):
        """A fresh lowering of the model's layers (with --fusion's)."""
        return self.model._lower_layers()[0]

    def _run_search(self, cost_model):
        """The actual search: pure host-side work, safe off-thread. Uses
        parallelization xfers ONLY (no operator-substitution rules) --
        a substitution rewrites compute ops and rebuilds their weights
        fresh, but a hot-swap must carry the TRAINED weights by (op name,
        weight name); compile_decode() makes the same restriction for the
        same reason."""
        from ..obs.trajectory import SearchTrajectory
        from ..pcg.machine_view import MachineResource
        from ..search import (GraphSearchHelper, SearchHelper,
                              generate_all_pcg_xfers)

        cfg = self.model.config
        graph = self._lowering()
        machine = cost_model.machine
        degrees = []
        d = 2
        while d <= machine.num_workers:
            degrees.append(d)
            d *= 2
        xfers = generate_all_pcg_xfers(degrees or [1], cfg)
        budget = (self.cfg.search_budget if self.cfg.search_budget > 0
                  else (cfg.search_budget if cfg.search_budget > 0 else 10))
        traj = SearchTrajectory()
        sh = SearchHelper(cost_model, trajectory=traj)
        gsh = GraphSearchHelper(sh, xfers, alpha=cfg.search_alpha,
                                budget=budget, trajectory=traj)
        res = MachineResource(
            num_nodes=machine.num_nodes,
            all_procs_per_node=machine.workers_per_node,
            available_procs_per_node=machine.workers_per_node,
        )
        best, result = gsh.graph_optimize(graph, res)
        self.last_trajectory = traj
        return best, result.views, result.cost

    def _shared_outcome(self) -> Tuple[_SearchOutcome, Optional[str]]:
        """Rank 0's search outcome on every rank, and its fingerprint:
        the winner crosses as an artifact-store payload that the other
        ranks replay onto their own lowering (runtime/artifact_store.py),
        and the ranks check that they hold one strategy."""
        out = self._search_result or _SearchOutcome(
            error=RuntimeError("search thread vanished without a result"))
        if rdist.process_count() == 1:
            fp = (None if out.error is not None
                  else strategy_fingerprint(out.graph, out.views))
            return out, fp
        from .artifact_store import replay_strategy, strategy_payload

        msg = None
        if rdist.process_index() == 0:
            msg = ({"error": repr(out.error)} if out.error is not None else
                   {"payload": strategy_payload(
                       out.graph, out.views, cost=out.cost, mesh_axes={}),
                    "fingerprint": strategy_fingerprint(out.graph,
                                                        out.views)})
        msg = rdist.broadcast_object(msg)
        if "error" in msg:
            return _SearchOutcome(error=RuntimeError(msg["error"])), None
        err = None
        if rdist.process_index() != 0:
            try:
                g, views, _, cost = replay_strategy(
                    self._lowering(), msg["payload"],
                    num_devices=self._search_cm.machine.num_workers)
                out = _SearchOutcome(graph=g, views=views, cost=cost)
            except Exception as e:  # agreed on below
                err = e
        if rdist.any_rank(err is not None):
            return _SearchOutcome(error=err or RuntimeError(
                "another rank could not replay the searched strategy")), None
        self.model._assert_same_strategy(out.graph, out.views)
        return out, msg["fingerprint"]

    def _collect_search(self, step: int) -> bool:
        """Search thread finished: vet the candidate or account the
        failure, then (maybe) swap -- we are at a step boundary."""
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        out, fp = self._shared_outcome()
        self._search_result = None
        cm = self._search_cm
        if out.error is not None:
            logger.warning("tuner: background re-search failed: %r",
                           out.error)
            self._finish_cycle(step, "rolled_back", reason="research_crash",
                               detail=repr(out.error))
            return False
        model = self.model
        ndev = rdist.process_count()
        if fp in self.quarantined:
            self._finish_cycle(step, "quarantined",
                               reason="already_quarantined", fingerprint=fp)
            return False
        from ..analysis.swap_lint import lint_swap_candidate

        problems = lint_swap_candidate(
            out.graph, out.views, num_devices=ndev, cost_model=cm,
            current_weight_ops=set(model.state.params.keys()),
        )
        if problems:
            self._quarantine(fp)
            self._finish_cycle(step, "quarantined", reason="lint",
                               fingerprint=fp, detail="; ".join(problems[:3]))
            return False
        # apples-to-apples win: both strategies re-simulated under the
        # SAME refreshed oracle (searched_cost was priced by the stale one)
        from ..search import simulate_runtime

        # compile() may have skipped the search (search_budget=-1 /
        # only_data_parallel): searched_views is then unset and the ops'
        # own machine views (from apply_*_parallel) price the incumbent
        cur_views = getattr(model, "searched_views", None)
        cur_sim = simulate_runtime(
            model.graph, _complete_views(model.graph, cur_views), cm,
        )
        cand_sim = simulate_runtime(
            out.graph, _complete_views(out.graph, out.views), cm,
        )
        win = (cur_sim - cand_sim) / cur_sim if cur_sim > 0 else 0.0
        obs.event("tuner_candidate", cat="tuner", step=step,
                  fingerprint=fp, win=round(win, 4),
                  cur_sim_s=cur_sim, cand_sim_s=cand_sim)
        if win < self.cfg.min_win:
            self._quarantine(fp)
            self._finish_cycle(step, "quarantined", reason="below_min_win",
                               fingerprint=fp, win=round(win, 4))
            return False
        self._candidate = {
            "graph": out.graph, "views": out.views, "cost": cand_sim,
            "fingerprint": fp, "win": win, "cost_model": cm,
        }
        return self._execute_swap(step)

    # ------------------------------------------------------------------
    # transactional swap
    # ------------------------------------------------------------------
    def _build_candidate_executor(self, graph, cost_model):
        """Build an executor for the candidate graph exactly as compile()
        does (core/model.py): on a process group a MeshExecutor over a
        mesh sized from the candidate's own degrees
        (parallel/strategies.py assign_mesh_axes over the live world),
        else the plain executor on the model's device. Returns
        (executor, mesh axes)."""
        from ..parallel import strategies

        model = self.model
        cfg = model.config
        mixed = cfg.allow_mixed_precision
        axes = model._mesh_axes(strategies.assign_mesh_axes(
            graph, rdist.process_count()))
        inputs, constants = model._graph_inputs(graph)
        executor_cls, where = model._executor_where(axes)
        from ..core.metrics import Metrics

        ex = executor_cls(
            graph, *where, optimizer=model.optimizer,
            loss_type=model.loss_type,
            metrics=Metrics(model.loss_type, model.metrics),
            compute_dtype=torch.bfloat16 if mixed else None,
            grad_dtype=(torch.bfloat16 if model._use_bf16_grads()
                        else None),
            seed=cfg.seed, input_order=inputs, remat=cfg.remat,
            constants=constants,
            overlap_grad_sync=cfg.overlap_backward_update,
            plan_cost_model=(cost_model if axes.get("pipe", 1) > 1
                             else None))
        ex.set_step_metrics(model.executor.step_metrics)
        return ex, axes

    def _transplant_state(self, new_ex, host_params, host_net, host_opt,
                          step_count, old_guard_host):
        """Name-matched reshard of the live state onto the candidate
        executor's placements: params and net state by (op name, weight
        name), optimizer slots structurally (ZeRO-1 slots included; the
        snapshot holds them whole), the step and the guard carried. Each
        tensor is written into the candidate's own (no communication)."""
        from ..parallel.executor import GuardState
        from .checkpoint import _merge_restore

        state = new_ex.init_state()
        unmatched = []
        for opn, wd in state.params.items():
            for wn, live in wd.items():
                src = host_params.get(opn, {}).get(wn)
                if src is None or tuple(src.shape) != tuple(live.shape):
                    unmatched.append(f"{opn}/{wn}")
                    continue
                _place_into(live, src)
        if unmatched:
            raise SwapError(
                "candidate strategy orphans trained weights (no name "
                "match): " + ", ".join(unmatched[:5])
            )
        for opn, bufs in state.net_state.items():
            for bn, live in bufs.items():
                src = (host_net or {}).get(opn, {}).get(bn)
                if src is not None and tuple(src.shape) == tuple(live.shape):
                    _place_into(live, src)
        for live, src in _merge_restore(state.opt_state, host_opt):
            _place_into(live, src)
        state.step = step_count
        if old_guard_host is not None:
            new_ex.set_step_guard(self.model.executor.step_guard)
            state.guard = GuardState.create(1.0, new_ex.device)
            for k in GuardState.FIELDS:
                _place_into(getattr(state.guard, k), old_guard_host[k])
        return state

    def _canary_losses(self, old_ex, old_state, new_ex, new_state,
                       batch) -> Tuple[float, float]:
        """One canary step on BOTH executors from equivalent state and the
        same cached batch and seed; returns (pre-swap loss, candidate
        loss). The steps update in place, so each state is snapshotted
        first and written back after: the canary only vets, it never
        trains."""
        xs, y = batch
        seed = self.model.config.seed + 104729
        losses = []
        for ex, state in ((old_ex, old_state), (new_ex, new_state)):
            kept = ex.snapshot_state(state)
            try:
                _, partials = ex.build_train_step()(state, list(xs), y, seed)
                losses.append(float(partials["loss"]))
            finally:
                ex.restore_state(state, kept)
        return losses[0], losses[1]

    def _execute_swap(self, step: int) -> bool:
        """The transaction. Nothing on the model mutates until every gate
        passes; a failure at any gate (on any rank: each is agreed before
        the next collective) discards the candidate (the live executor
        and state were never touched) and quarantines it."""
        from .verify import tensor_checksums

        model = self.model
        cand = self._candidate
        self._candidate = None
        fp = cand["fingerprint"]
        old_ex = model.executor
        t0 = time.perf_counter()
        try:
            host_params = _host_tree(model.state.params)
            host_net = _host_tree(model.state.net_state or {})
            host_opt = _host_tree(model.state.opt_state)
            old_guard_host = (None if model.state.guard is None
                              else _host_tree(model.state.guard.as_dict()))
            step_count = int(model.state.step)
            pre_crc = tensor_checksums(host_params)

            err, new_ex, new_state = None, None, None
            t1 = time.perf_counter()
            try:
                new_ex, axes = self._build_candidate_executor(
                    cand["graph"], cand["cost_model"])
                self.timings["build_s"] = time.perf_counter() - t1
                t1 = time.perf_counter()
                new_state = self._transplant_state(
                    new_ex, host_params, host_net, host_opt, step_count,
                    old_guard_host)
                if self.fault is not None:
                    plan = self.fault.fire("swap_reshard_corruption", step)
                    if plan is not None:
                        _corrupt_one_param(new_state, plan)
            except Exception as e:  # agreed on below
                err = e
            if rdist.any_rank(err is not None):
                raise err or SwapError("the candidate executor failed to "
                                       "build on another rank")
            # bit-exact carryover gate: gather the transplanted params
            # back and compare content checksums against the snapshot
            post_crc = tensor_checksums(_host_tree(new_state.params))
            self.timings["transplant_s"] = time.perf_counter() - t1
            bad = [k for k, rec in pre_crc.items()
                   if post_crc.get(k, {}).get("crc32") != rec["crc32"]]
            if rdist.any_rank(bool(bad)):
                raise SwapError(
                    "reshard carryover is not bit-exact: "
                    + (", ".join(sorted(bad)[:5]) or "on another rank")
                )
            # canary gate: candidate loss vs pre-swap loss on the same
            # batch (also proves the new executor dispatches at all)
            if self._last_batch is not None:
                t1 = time.perf_counter()
                loss_pre, loss_new = self._canary_losses(
                    old_ex, model.state, new_ex, new_state,
                    self._last_batch,
                )
                self.timings["canary_s"] = time.perf_counter() - t1
                tol = (self.cfg.canary_atol
                       + self.cfg.canary_rtol * abs(loss_pre))
                if (not np.isfinite(loss_new)
                        or abs(loss_new - loss_pre) > tol):
                    raise SwapError(
                        f"canary diverged: pre-swap loss {loss_pre:.6g} "
                        f"vs candidate {loss_new:.6g} (tol {tol:.3g})"
                    )
        except Exception as e:
            # the live executor/state were never touched -- just discard
            logger.warning("tuner: swap aborted, keeping pre-swap "
                           "strategy: %s", e)
            self._quarantine(fp)
            self._finish_cycle(step, "rolled_back", reason="swap_failed",
                               fingerprint=fp, detail=str(e))
            return False

        # ---- commit point: publish the candidate as the live strategy
        cur_views = getattr(model, "searched_views", None)
        self._preswap = {
            "graph": model.graph, "views": cur_views,
            "cost": getattr(model, "searched_cost", None), "executor": old_ex,
            "mesh_axes": dict(model.mesh_axes),
            "fingerprint": strategy_fingerprint(model.graph, cur_views),
        }
        # guard reference: the BEST (min) EMA the pre-swap strategy showed,
        # not the instantaneous EMA -- early in a run the EMA still carries
        # the first steps' warm-up and would mask a real regression.
        # (_install resets both, so capture before.)
        pre_ema = min(x for x in (self._ema, self._baseline)
                      if x is not None) if self._ema is not None else None
        self._install(cand["graph"], cand["views"], cand["cost"],
                      new_ex, new_state, axes)
        self._pre_swap_ema = pre_ema
        self._post_seen = 0
        self._post_skipped = 0
        self._post_ema = None
        self._regress_factor = None
        if self.fault is not None:
            plan = self.fault.fire("swap_regression", step)
            if plan is not None:
                self._regress_factor = float(plan.get("factor", 10.0))
        self.state = self.POST_SWAP
        dur = time.perf_counter() - t0
        obs.event("strategy_swap", cat="tuner", step=step, fingerprint=fp,
                  win=round(cand["win"], 4), dur_s=round(dur, 4))
        model.search_trajectory.event(
            "strategy_swap", step=step, fingerprint=fp,
            win=round(cand["win"], 4),
        )
        self._record_overlay_instant(step, fp)
        tel = obs.active()
        if tel is not None and getattr(tel, "tracer", None) is not None:
            tel.tracer.instant("strategy_swap", cat="tuner", step=step,
                               fingerprint=fp)
        logger.info("tuner: strategy swap installed at step %d "
                    "(fingerprint %s, simulated win %.1f%%); guard window "
                    "%d steps", step, fp, 100 * cand["win"],
                    self.cfg.post_swap_steps)
        return True

    def _install(self, graph, views, cost, executor, state,
                 mesh_axes) -> None:
        """Point the model at a (graph, views, executor, state) tuple and
        re-register it with the active telemetry session (the elastic
        recompile path does the same). The old executor's serving weight
        cache and captured graphs stay with it: nothing keyed on its
        tensors serves the new ones."""
        model = self.model
        model.graph = graph
        model.searched_views = views
        model.searched_cost = cost
        model.executor = executor
        model.state = state
        model.mesh_axes = dict(mesh_axes)
        executor.reset_step_duration()
        self._ema = None
        self._obs_steps = 0
        self._baseline = None
        tel = obs.active()
        if tel is not None and hasattr(tel, "_attached_models"):
            try:
                tel._attached_models.remove(model)
            except ValueError:
                pass
            tel.attach_model(model)

    def _record_overlay_instant(self, step: int, fingerprint: str) -> None:
        """Queue a swap-boundary instant for the step-observatory Perfetto
        overlay (obs/step_profile.py export_overlay extra_events)."""
        model = self.model
        evs = getattr(model, "_strategy_swap_overlay_events", None)
        if evs is None:
            evs = model._strategy_swap_overlay_events = []
        evs.append({
            "name": "strategy_swap", "cat": "tuner", "ph": "i", "s": "g",
            "ts": time.time() * 1e6, "pid": 1, "tid": 0,
            "args": {"step": step, "fingerprint": fingerprint,
                     "leg": self.leg},
        })

    # ------------------------------------------------------------------
    # post-swap guard window
    # ------------------------------------------------------------------
    def _police_guard_window(self, step: int) -> bool:
        cfg = self.cfg
        if self._post_seen < cfg.post_swap_steps:
            # regress fast if the window already shows a blowout
            if (self._post_ema is not None and self._pre_swap_ema
                    and self._post_seen >= 2
                    and self._post_ema > self._pre_swap_ema
                    * (1.0 + cfg.guard_band)):
                return self._rollback_regression(step)
            return False
        if (self._post_ema is not None and self._pre_swap_ema
                and self._post_ema > self._pre_swap_ema
                * (1.0 + cfg.guard_band)):
            return self._rollback_regression(step)
        # guard window survived: the swap is committed
        pre = self._preswap
        self._preswap = None
        self._regress_factor = None
        self._write_through_winner()
        self._finish_cycle(
            step, "committed",
            fingerprint=strategy_fingerprint(self.model.graph,
                                             self.model.searched_views),
            replaced=pre["fingerprint"] if pre else None,
        )
        return False

    def _rollback_regression(self, step: int) -> bool:
        """Measured step time regressed past the guard band: re-transplant
        the CURRENT (evolved) state back onto the pre-swap strategy and
        restore it. Training continues -- the regressed candidate is
        quarantined."""
        model = self.model
        pre = self._preswap
        self._preswap = None
        self._regress_factor = None
        bad_fp = strategy_fingerprint(model.graph, model.searched_views)
        self._quarantine(bad_fp)
        host_params = _host_tree(model.state.params)
        host_net = _host_tree(model.state.net_state or {})
        host_opt = _host_tree(model.state.opt_state)
        old_guard_host = (None if model.state.guard is None
                          else _host_tree(model.state.guard.as_dict()))
        step_count = int(model.state.step)
        old_ex = pre["executor"]
        state = self._transplant_state(old_ex, host_params, host_net,
                                       host_opt, step_count, old_guard_host)
        self._install(pre["graph"], pre["views"], pre["cost"], old_ex, state,
                      pre["mesh_axes"])
        ratio = ((self._post_ema / self._pre_swap_ema)
                 if (self._post_ema and self._pre_swap_ema) else float("nan"))
        logger.warning(
            "tuner: post-swap step time regressed %.2fx past the guard "
            "band; rolled back to pre-swap strategy %s", ratio,
            pre["fingerprint"],
        )
        self._finish_cycle(step, "rolled_back", reason="post_swap_regression",
                           fingerprint=bad_fp,
                           regression_ratio=round(ratio, 3))
        return True

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def _finish_cycle(self, step: int, outcome: str, **detail) -> None:
        self.state = self.IDLE
        self._breach = 0
        self._miscal = 0.0
        self._cooldown_until = step + self.cfg.cooldown_steps
        self.outcomes[outcome] += 1
        self.swap_history.append({"step": step, "outcome": outcome,
                                  **detail})
        obs.count(SWAP_METRIC, help=SWAP_METRIC_HELP, outcome=outcome,
                  leg=self.leg)
        obs.event("tuner_cycle_finished", cat="tuner", step=step,
                  outcome=outcome,
                  **{k: v for k, v in detail.items() if v is not None})
        if outcome in ("rolled_back", "quarantined"):
            # rollbacks are the tuner's crash-equivalent: keep the event
            # tail + strategy provenance around the failed swap
            obs.forensics_dump(
                f"tuner_{outcome}", step=step, leg=self.leg,
                outcomes=dict(self.outcomes),
                swap_history=self.swap_history[-5:],
                detail={k: v for k, v in detail.items()
                        if isinstance(v, (str, int, float, bool))})


def _corrupt_one_param(state, plan) -> None:
    """swap_reshard_corruption fault site: shift the first weight's first
    element after the transplant, BEFORE the checksum gate -- the gate
    must catch it and the swap must roll back."""
    for opn in sorted(state.params):
        for wn in sorted(state.params[opn]):
            like = state.params[opn][wn]
            arr = full(like).detach().to("cpu", copy=True)
            flat = arr.reshape(-1)
            if arr.is_floating_point():
                flat[0] += float(plan.get("delta", 1.0))
            else:
                flat[0] = ~flat[0]
            _place_into(like, arr)
            return
