"""Fault-tolerant training runtime.

The PyTorch counterpart of flexflow_tpu/runtime/resilience.py, on one
device or a process group. The failure modes it handles:

  * **preemption** — the host is SIGTERMed between steps; the run must
    resume from the last checkpoint and replay deterministically
    (Megatron-LM-style periodic checkpoint/resume).
  * **non-finite steps** — one NaN/Inf batch must not corrupt the params;
    the step is skipped and the loss scale backed off (the mixed-precision
    skip-and-rescale recipe), with a hard fail after N consecutive skips.
  * **transient I/O failures** — checkpoint writes get exponential-backoff
    retries.

Everything here is CPU-testable: `FaultInjector` deterministically injects
NaN gradients, checkpoint-write IOErrors, simulated preemption and
on-disk bit flips (tests/test_torch_port_resilience.py).
"""
from __future__ import annotations

import dataclasses
import os
import random
import re
import shutil
import signal
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import distributed as rdist


# ----------------------------------------------------------------------
# typed failures
# ----------------------------------------------------------------------
class ResilienceError(RuntimeError):
    """Base class for runtime fault-tolerance failures."""


class InferenceTimeout(ResilienceError, TimeoutError):
    """A serving request was not answered within its deadline.

    Subclasses TimeoutError so the default RetryPolicy retries it."""


class NonFiniteGradientsError(ResilienceError):
    """The step guard skipped `max_consecutive_skips` steps in a row —
    the run is diverging (bad data / broken op), not a transient batch."""


class TrainingPreempted(ResilienceError):
    """fit() was interrupted between steps by a preemption signal.

    `graceful` preemptions flushed a final checkpoint (checkpoint_path);
    hard ones resume from the last periodic checkpoint and replay."""

    def __init__(self, msg: str = "training preempted", *, step: int = 0,
                 graceful: bool = True):
        super().__init__(msg)
        self.step = step
        self.graceful = graceful
        self.checkpoint_path: Optional[str] = None


class HostLossError(TrainingPreempted):
    """A host (and its devices) dropped out of the topology between steps.

    Subclasses TrainingPreempted so the fit() grace-period machinery
    flushes a final checkpoint; the orchestrator then restarts the run
    elastically (runtime/elastic.py restore_elastic) on the surviving
    device set instead of waiting for the identical slice to return."""

    def __init__(self, msg: str = "host lost", *, step: int = 0,
                 graceful: bool = True,
                 surviving_devices: Optional[int] = None):
        super().__init__(msg, step=step, graceful=graceful)
        self.surviving_devices = surviving_devices
        # True when the loss came from a FaultInjector plan (simulation):
        # fit()'s in-process failover may then shrink the live world
        # itself (elastic.shrunk_devices) instead of deferring to the
        # orchestrator.
        self.simulated = False


class SliceLossError(HostLossError):
    """An entire slice (fault domain) dropped out between steps — every
    host of the slice went stale, or the ``slice_loss`` fault-injection
    site fired. Unlike a single host loss, NOTHING of the slice
    survives: strategies that shard model or optimizer state across slices
    cannot recover by shrinking and need a full restore-from-checkpoint;
    pure data-parallel-across-slices strategies just drop the replicas
    (search/survivability.py classifies which case a strategy is in).

    fit(elastic=True) catches this, shrinks onto the surviving slices,
    re-searches and resumes from the last checkpoint (simulated losses
    in-process; real ones via the orchestrator + restore_elastic)."""

    def __init__(self, msg: str = "slice lost", *, step: int = 0,
                 graceful: bool = True, lost_slice: Optional[int] = None,
                 surviving_devices: Optional[int] = None):
        super().__init__(msg, step=step, graceful=graceful,
                         surviving_devices=surviving_devices)
        self.lost_slice = lost_slice


class SliceDrained(TrainingPreempted):
    """A deadline-bearing preemption notice was drained to completion:
    fit() kept stepping while the remaining grace exceeded the drain
    window (one step + a checkpoint flush), then wrote a final
    checkpoint and stopped. Carries everything failover needs to resume
    on the surviving slices without the leaving one."""

    def __init__(self, msg: str = "slice drained", *, step: int = 0,
                 deadline_s: Optional[float] = None,
                 met_deadline: bool = True,
                 drained_steps: int = 0,
                 leaving_slice: Optional[int] = None,
                 surviving_devices: Optional[int] = None):
        super().__init__(msg, step=step, graceful=True)
        self.deadline_s = deadline_s
        self.met_deadline = met_deadline
        self.drained_steps = drained_steps
        self.leaving_slice = leaving_slice
        self.surviving_devices = surviving_devices
        self.simulated = False


class CollectiveTimeout(ResilienceError, TimeoutError):
    """The health watchdog (runtime/elastic.py HealthMonitor) declared a
    step hung — a collective that never completes (deadlocked psum after
    a host loss, a wedged straggler) — or a straggler host stopped
    heartbeating. fit() escalates through checkpoint-and-raise: the last
    good state is flushed (checkpoint_path) and the process exits so the
    orchestrator can restart elastically instead of burning device-hours in
    a deadlock."""

    def __init__(self, msg: str = "collective timeout", *, step: int = 0,
                 info: Optional[dict] = None):
        super().__init__(msg)
        self.step = step
        self.info = info or {}
        self.checkpoint_path: Optional[str] = None


# ----------------------------------------------------------------------
# retry / backoff
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter (the standard cloud-client recipe:
    delay_k = min(max, base * multiplier**k), randomized by +/-jitter so
    a fleet of preempted workers doesn't thundering-herd the coordinator)."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.25  # fraction of the delay, uniform +/-
    retry_on: Tuple[type, ...] = (OSError, ConnectionError, TimeoutError)

    def delay(self, attempt: int, rand: Callable[[], float] = random.random) -> float:
        """Backoff before retry number `attempt` (0-based)."""
        d = min(self.max_delay_s, self.base_delay_s * self.multiplier ** attempt)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rand() - 1.0)
        return max(0.0, d)


def retry(
    fn: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Call `fn()` under `policy`: exceptions in `policy.retry_on` are
    retried with exponential backoff + jitter, anything else (and the
    final exhausted attempt) propagates. `on_retry(attempt, exc, delay)`
    observes each retry; `sleep` is injectable so tests run at full speed."""
    from .. import obs

    policy = policy or RetryPolicy()
    attempts = max(1, policy.max_attempts)
    for attempt in range(attempts):
        try:
            return fn()
        except policy.retry_on as e:
            if attempt == attempts - 1:
                # exhausted retries are a typed-failure-grade incident:
                # keep the tail that shows every attempt + backoff
                obs.forensics_dump("retries_exhausted", error=e,
                                   attempts=attempts)
                raise
            d = policy.delay(attempt)
            obs.count("ff_retries_total",
                      help="retried transient failures (runtime.retry)")
            obs.event("retry", cat="runtime", attempt=attempt,
                      error=type(e).__name__, delay_s=d)
            if on_retry is not None:
                on_retry(attempt, e, d)
            sleep(d)


# ----------------------------------------------------------------------
# step guard config (the executor owns the guard math)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepGuardConfig:
    """NaN/Inf step guard + dynamic loss scale, applied inside the train
    step on the device (parallel/executor.py): a non-finite global grad
    norm skips the optimizer update (params and optimizer state carried
    through unchanged) and backs the loss scale off; `growth_interval`
    consecutive good steps grow it back (capped at `max_loss_scale`,
    default = the initial scale, so plain f32 runs keep scale 1.0 and
    only recover what backoff lost).
    fit() hard-fails with NonFiniteGradientsError after
    `max_consecutive_skips` skipped steps in a row."""

    max_consecutive_skips: int = 10
    init_loss_scale: float = 1.0
    backoff_factor: float = 0.5
    growth_factor: float = 2.0
    growth_interval: int = 200
    max_loss_scale: Optional[float] = None  # None -> init_loss_scale
    min_loss_scale: float = 2.0 ** -16


# ----------------------------------------------------------------------
# preemption
# ----------------------------------------------------------------------
class PreemptionSignal:
    """A between-steps stop flag. Real deployments arm it from SIGTERM
    (install_sigterm_handler — what a preemptible host gets with a grace
    period); the fault-injection harness arms it directly.

    Two shapes of trigger:

    * **bare** (`trigger()`) — legacy stop-now: fit() flushes a final
      checkpoint (graceful) and raises TrainingPreempted.
    * **deadline-bearing** (`trigger(deadline_s=...)`) — a drain notice:
      the pod manager granted `deadline_s` seconds of grace, optionally
      naming the `leaving_slice` and the `surviving_devices` count that
      remain after it goes. fit() keeps training while the remaining
      grace comfortably exceeds one step + a checkpoint flush, then
      checkpoints and raises SliceDrained so failover can shrink onto
      the survivors (the *drain protocol*)."""

    def __init__(self):
        self._event = threading.Event()
        self.graceful = True
        self._prev_handler = None
        self.deadline_at: Optional[float] = None  # time.monotonic()
        self.deadline_s: Optional[float] = None
        self.leaving_slice: Optional[int] = None
        self.surviving_devices: Optional[int] = None

    def trigger(self, graceful: bool = True, *,
                deadline_s: Optional[float] = None,
                leaving_slice: Optional[int] = None,
                surviving_devices: Optional[int] = None) -> None:
        self.graceful = graceful
        if deadline_s is not None:
            self.deadline_s = float(deadline_s)
            self.deadline_at = time.monotonic() + float(deadline_s)
        self.leaving_slice = leaving_slice
        self.surviving_devices = surviving_devices
        self._event.set()

    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def draining(self) -> bool:
        """Armed WITH a deadline — fit() drains instead of stopping."""
        return self._event.is_set() and self.deadline_at is not None

    def deadline_remaining(self) -> Optional[float]:
        """Seconds of grace left (negative = deadline blown); None when
        the signal carries no deadline."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.monotonic()

    def clear(self) -> None:
        self._event.clear()
        self.graceful = True
        self.deadline_at = None
        self.deadline_s = None
        self.leaving_slice = None
        self.surviving_devices = None

    def install_sigterm_handler(self) -> bool:
        """Arm on SIGTERM (graceful: the grace period is for the final
        checkpoint flush). Returns False when not on the main thread,
        where Python forbids signal handler installation."""
        try:
            self._prev_handler = signal.signal(
                signal.SIGTERM, lambda signum, frame: self.trigger(graceful=True)
            )
            return True
        except ValueError:  # not the main thread
            return False

    def uninstall(self) -> None:
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None


# ----------------------------------------------------------------------
# fault injection
# ----------------------------------------------------------------------
class FaultInjector:
    """Deterministic fault injection for chaos testing on CPU.

    Sites consumed by the runtime:
      * ``nan_grads``        — fit() poisons that step's gradients with NaN
                               (exercises the step guard end-to-end).
      * ``checkpoint_write`` — raised between the checkpoint's tmp write
                               and its atomic rename (exercises retry and
                               the no-partial-checkpoint guarantee).
      * ``preempt``          — arms the preemption flag between steps;
                               ``graceful=False`` simulates a hard kill
                               (no final checkpoint flush).
      * ``preemption_notice`` — arms the preemption signal WITH a drain
                               deadline (``deadline_s=`` grace seconds;
                               ``slice=``/``surviving_devices=`` ride
                               along): fit() finishes the in-flight
                               step(s), checkpoints before the deadline
                               and raises SliceDrained.
      * ``bitflip``          — silent-data-corruption simulation
                               (runtime/verify.py): the canary's consumer
                               flips one bit of one live weight tensor
                               after a step executes (default), or with
                               ``target="disk"`` CheckpointManager.save
                               corrupts the just-written checkpoint so
                               the restore-time checksum path fires.
      * ``artifact_corruption`` — an ArtifactStore.get
                               (runtime/artifact_store.py) treats the
                               existing entry as corrupt: it is
                               quarantined, counted under
                               ff_artifact_cache_total{event=corrupt}
                               and the typed ArtifactCorruptionError is
                               raised — compile() must degrade to a
                               fresh search.
      * ``artifact_stale``   — an ArtifactStore.get treats the existing
                               entry as fingerprint-stale: quarantined,
                               counted under event=stale and returned
                               as a miss (fresh search, no error).

      * ``slice_loss``       — fit() loses a whole fault domain before
                               that step (``slice=``/``surviving_devices=``):
                               SliceLossError after a final checkpoint;
                               fit(elastic=True) shrinks onto the
                               survivors and resumes in-process.
      * ``host_loss``        — fit() loses a host before that step
                               (``surviving_devices=``): HostLossError
                               after a final checkpoint.
      * ``hung_step``        — with a health_monitor, the step blocks as
                               on a dead collective until the watchdog
                               fires: CollectiveTimeout after a
                               checkpoint.
      * ``swap_research_crash`` / ``swap_reshard_corruption`` /
        ``swap_regression`` — the strategy tuner's failure legs
                               (runtime/tuner.py).

      * ``serving_worker``   — raised inside BatchScheduler's worker loop
                               (runtime/serving.py): the in-flight batch
                               re-runs on the degraded unbatched path
                               and the worker restarts with backoff.
      * ``replica_death``    — raised inside a ContinuousBatcher serve
                               loop: the replica dies, its in-flight
                               requests go back to the queue and a
                               ReplicaSet replaces it (a warm spare, or a
                               rebuild through restore_elastic). Extras:
                               ``replica="replicaN"`` targets one.
      * ``slow_worker``      — stalls one decode iteration for
                               ``delay_s`` seconds inside the health-
                               monitored step window, so the watchdog
                               sees a hung step and failover fires.
      * ``kv_exhaustion``    — a KV-page reservation fails as if the pool
                               were full (runtime/kvcache.py):
                               backpressure; ``never_fits=True`` sheds.
      * ``shared_page_corruption`` — a shared-prefix chain fails its
                               integrity check: the chain is quarantined;
                               ``match_prefix`` raises the typed
                               SharedPageCorruptionError, ``reserve``
                               admits unshared.
      * ``release_race``     — a racing second ``PagePool.release`` right
                               after a successful one: a typed double
                               release, never corrupt refcounts.
      * ``cow_fault``        — a KV copy-on-write fails before any pool
                               state changes.

    Each injection fires `times` times, optionally only at `at_step`.
    `fire(site, step)` consumes one shot and raises `exc` when armed with
    one, otherwise returns the plan dict (extras like graceful=False ride
    along) or None when nothing applies. `fire(..., key=value)` keyword
    filters restrict matching to plans whose extras carry those exact
    values (how the two ``bitflip`` consumers avoid stealing each
    other's plans)."""

    def __init__(self):
        self._plans: Dict[str, List[dict]] = {}
        self.fired: Dict[str, int] = {}

    def inject(self, site: str, *, at_step: Optional[int] = None,
               times: int = 1, exc: Optional[BaseException] = None,
               **extra) -> "FaultInjector":
        plan = {"at_step": at_step, "remaining": times, "exc": exc}
        plan.update(extra)
        self._plans.setdefault(site, []).append(plan)
        return self

    def fire(self, site: str, step: Optional[int] = None,
             **match) -> Optional[dict]:
        for plan in self._plans.get(site, []):
            if plan["remaining"] <= 0:
                continue
            if plan["at_step"] is not None and step != plan["at_step"]:
                continue
            if any(plan.get(k) != v for k, v in match.items()):
                continue
            plan["remaining"] -= 1
            self.fired[site] = self.fired.get(site, 0) + 1
            # the JAX package records the shot in the flight recorder
            # here; not ported yet (ROADMAP queue 1 item 6)
            if plan["exc"] is not None:
                raise plan["exc"]
            return plan
        return None

    def pending(self, site: str) -> int:
        return sum(max(0, p["remaining"]) for p in self._plans.get(site, []))


# ----------------------------------------------------------------------
# checkpoint manager
# ----------------------------------------------------------------------
_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
_LATEST_FILE = "LATEST"


@dataclasses.dataclass
class RestoreResult:
    step: int
    path: str
    meta: dict


class CheckpointManager:
    """Preemption-safe periodic checkpointing over runtime/checkpoint.py.

    Layout: ``<dir>/step_<N>/`` (atomic: written to a tmp name and
    renamed, so a checkpoint directory either exists complete or not at
    all) + ``step_<N>.meta.json`` sidecar (topology + train cursor) +
    ``LATEST`` pointer. Retention keeps the newest `keep_last_n`.
    Writes are retried under `retry_policy`; `fault_injector` (site
    ``checkpoint_write``) can make any write fail mid-flight for tests.

    On a process group every rank holds a manager over the same
    directory: every rank joins a save (runtime/checkpoint.py gathers the
    state on all of them) and rank 0 alone touches the disk (the write,
    LATEST, the pruning, the stale-tmp sweep); a restore's choice of
    checkpoint, the corrupt-newest fallback included, is rank 0's,
    broadcast, and a checkpoint counts as restored only where it restored
    on every rank."""

    def __init__(self, directory: str, *, keep_last_n: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.directory = os.path.abspath(directory)
        self.keep_last_n = max(1, keep_last_n)
        self.retry_policy = retry_policy or RetryPolicy()
        self.fault_injector = fault_injector
        self._sleep = sleep
        self._leader = rdist.process_index() == 0
        os.makedirs(self.directory, exist_ok=True)
        if self._leader:
            self.clean_stale_tmp()

    # -- paths ----------------------------------------------------------
    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def list_steps(self) -> List[int]:
        """Complete checkpoints only (tmp names never match step_*)."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            m = _STEP_DIR_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """The LATEST pointer when valid, else the newest step on disk."""
        steps = self.list_steps()
        try:
            with open(os.path.join(self.directory, _LATEST_FILE)) as f:
                s = int(f.read().strip())
            if s in steps:
                return s
        except (OSError, ValueError):
            pass
        return steps[-1] if steps else None

    def clean_stale_tmp(self) -> None:
        """Drop half-written tmp dirs/files left by a kill mid-save or
        mid-GC, and orphan ``step_N.meta.json`` sidecars whose checkpoint
        dir is gone (a crash between _gc's dir-prune and sidecar-prune)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        pid_suffix = str(os.getpid())
        for name in names:
            if ".tmp-" in name:
                # tmp names end in the writer's pid; OUR pid means another
                # manager in this process (warm spare / replica sharing the
                # dir) may be mid-save — sweeping its tmp races os.replace
                if name.rsplit("-", 1)[-1] == pid_suffix:
                    continue
                p = os.path.join(self.directory, name)
                shutil.rmtree(p, ignore_errors=True)
                if os.path.isfile(p):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
        for name in names:
            if not name.endswith(".meta.json"):
                continue
            base = name[: -len(".meta.json")]
            if _STEP_DIR_RE.match(base) and not os.path.isdir(
                os.path.join(self.directory, base)
            ):
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    # -- save / restore -------------------------------------------------
    def save(self, model, step: int, extra_meta: Optional[dict] = None) -> str:
        """Atomically write `model`'s full training state as step `step`,
        retrying transient I/O failures, then advance LATEST and GC."""
        from .. import obs
        from .checkpoint import save_checkpoint

        path = self.step_path(step)
        hook = None
        if self.fault_injector is not None:
            hook = lambda: self.fault_injector.fire("checkpoint_write", step)  # noqa: E731

        def _write():
            return save_checkpoint(model, path, step=step,
                                   extra_meta=extra_meta,
                                   _pre_rename_hook=hook)

        with obs.span("checkpoint_save", cat="checkpoint", step=step,
                      path=path):
            retry(_write, self.retry_policy, sleep=self._sleep)
        obs.count("ff_checkpoint_saves_total",
                  help="checkpoints written (CheckpointManager.save)")
        if self._leader:
            self._after_save(path, step)
        # the pointer is written before any rank reads it
        rdist.barrier()
        return path

    def _after_save(self, path: str, step: int) -> None:
        if self.fault_injector is not None:
            # SDC-on-disk simulation (runtime/verify.py): corrupt the
            # checkpoint AFTER its checksums were recorded, so the
            # restore-time integrity gate has something real to catch
            plan = self.fault_injector.fire("bitflip", step, target="disk")
            if plan is not None:
                from .verify import corrupt_checkpoint_tensor

                corrupt_checkpoint_tensor(
                    path, tensor=plan.get("tensor"),
                    bit=plan.get("bit", 6), index=plan.get("index", 3),
                )
        self._write_latest(step)
        self._gc()

    def restore_latest(self, model,
                       elastic: bool = False) -> Optional[RestoreResult]:
        """Restore the newest loadable checkpoint (a corrupt newest one —
        e.g. truncated by a crash landing exactly mid-rename — falls back
        to the next older). Returns None when the directory has none.

        `elastic=True` relaxes the checkpoint-vs-model graph check to
        name-based weight matching (runtime/checkpoint.py), so a
        checkpoint written on a different device topology — whose
        re-searched PCG carries different parallel ops — still restores
        onto the live model."""
        from .. import obs
        from .checkpoint import load_checkpoint_meta, restore_checkpoint

        candidates = None
        if self._leader:
            latest = self.latest_step()
            candidates = [] if latest is None else [latest] + [
                s for s in reversed(self.list_steps()) if s != latest]
        # rank 0's choice on every rank
        for s in rdist.broadcast_object(candidates):
            path = self.step_path(s)
            try:
                err = None
                with obs.span("checkpoint_restore", cat="checkpoint",
                              step=s, path=path, elastic=elastic):
                    try:
                        step = restore_checkpoint(
                            model, path, strict_topology=not elastic)
                    except Exception as e:  # agreed on below
                        err = e
                    if rdist.any_rank(err is not None):
                        raise err or RuntimeError(
                            f"checkpoint {path} failed to restore on "
                            "another rank")
                meta = load_checkpoint_meta(path) or {}
                obs.count("ff_checkpoint_restores_total",
                          help="successful checkpoint restores")
                return RestoreResult(step=step, path=path, meta=meta)
            except Exception as e:  # corrupt/partial — try the next older
                obs.count(
                    "ff_checkpoint_restore_fallbacks_total",
                    help="corrupt/partial checkpoints skipped on restore",
                )
                obs.event("checkpoint_restore_failed", cat="checkpoint",
                          step=s, error=type(e).__name__,
                          detail=str(e)[:500])
                warnings.warn(
                    f"checkpoint {path} failed to restore ({e!r}); "
                    "falling back to an older checkpoint"
                )
        return None

    # -- internals ------------------------------------------------------
    def _write_latest(self, step: int) -> None:
        p = os.path.join(self.directory, _LATEST_FILE)
        tmp = f"{p}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, p)

    def _gc(self) -> None:
        """Prune checkpoints past keep_last_n (newest-by-step kept) —
        but NEVER the step LATEST names: an elastic rollback-resume can
        save a LOWER step than the on-disk history, and pruning it by
        step order would leave the just-written pointer naming a deleted
        checkpoint. Each prune renames the dir and its sidecar to
        ``.tmp-gc-*`` names FIRST and deletes those, so a crash
        mid-prune leaves only tmp litter or an orphan sidecar — both
        swept by clean_stale_tmp on the next boot — never a
        half-deleted checkpoint that restore would trust."""
        steps = self.list_steps()
        keep = set(steps[-self.keep_last_n:])
        latest = self.latest_step()
        if latest is not None:
            keep.add(latest)
        for s in steps:
            if s in keep:
                continue
            path = self.step_path(s)
            tmp = f"{path}.tmp-gc-{os.getpid()}"
            try:
                os.replace(path, tmp)
            except OSError:
                continue
            meta_tmp = f"{tmp}.meta.json"
            try:
                os.replace(path + ".meta.json", meta_tmp)
            except OSError:
                meta_tmp = None
            shutil.rmtree(tmp, ignore_errors=True)
            if meta_tmp is not None:
                try:
                    os.remove(meta_tmp)
                except OSError:
                    pass


def restore_latest(model, directory: str,
                   elastic: bool = False) -> Optional[RestoreResult]:
    """Restore the newest loadable checkpoint under `directory` into a
    compiled model. Convenience wrapper over CheckpointManager."""
    return CheckpointManager(directory).restore_latest(model, elastic=elastic)
