"""Static model of the overlapped executor step schedule.

The PyTorch counterpart of flexflow_tpu/analysis/schedule.py.

The overlapped gradient sync (parallel/executor.py MeshExecutor,
``set_overlap_grad_sync``, as the JAX package's) decomposes the
data-parallel step into
per-weight task chains — backward → reduce-scatter(grad) → sharded
optimizer update → all-gather(updated params) — with the collectives
issued asynchronously so they hide behind later backward compute, and
with the old param/optimizer storage DONATED to the new values. That
schedule is correct only because of dataflow edges XLA inserts; a
rewrite that drops one (or a buffer two tasks secretly share, e.g. a
tied weight) turns into a silent read-of-garbage the runtime canary
(runtime/verify.py) only catches probabilistically.

This module makes the schedule a first-class static object:

  * ``ScheduleTask`` — one step task: what it reads, writes, donates,
    what must complete before it, and whether it is an async collective
    (completion unordered unless a dependency edge says otherwise).
  * ``build_overlap_schedule(graph, eligible)`` — reconstructs the
    executor's overlapped step for a PCG: the same per-weight chains
    ``_make_step`` traces, with buffers named by VALUE (weight buffers
    by tensor guid, so tied weights alias).
  * ``PCGExecutor.overlap_schedule()`` — the introspection hook: the
    live executor describes its own schedule through this builder.
  * ``schedule_race_diagnostics(schedule)`` — the FFA502 checker: walks
    the happens-before relation and flags (a) a donated buffer a task
    can still read, (b) an async collective's output read without a
    completion edge, (c) unordered writer/reader pairs on one buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .diagnostics import AnalysisReport, Severity


@dataclasses.dataclass(frozen=True)
class ScheduleTask:
    """One task of the (modelled) executor step.

    Buffers are VALUES, not storage: a task that `donates` a buffer
    consumes its storage while producing a successor value under a new
    name (the all-gather donates ``param:<guid>`` and writes
    ``param_next:<guid>``). ``after`` lists task names that must have
    COMPLETED before this task may start; for an ``async_collective``
    the dependency edge is also the only completion guarantee readers
    of its outputs can rely on.
    """

    name: str
    kind: str  # backward | reduce_scatter | update | all_gather | all_reduce | barrier
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()
    donates: Tuple[str, ...] = ()
    after: Tuple[str, ...] = ()
    async_collective: bool = False
    op_guid: Optional[int] = None
    op_name: str = ""


class OverlapSchedule:
    """An ordered collection of ScheduleTasks (one modelled step)."""

    def __init__(self, tasks: Sequence[ScheduleTask]):
        self.tasks: List[ScheduleTask] = list(tasks)
        self._by_name: Dict[str, ScheduleTask] = {}
        for t in self.tasks:
            if t.name in self._by_name:
                raise ValueError(f"duplicate schedule task {t.name!r}")
            self._by_name[t.name] = t

    def task(self, name: str) -> ScheduleTask:
        return self._by_name[name]

    def replace(self, name: str, **changes) -> "OverlapSchedule":
        """A copy with one task altered — the seeded-defect seam tests
        use to drop a dependency edge or mis-donate a buffer."""
        return OverlapSchedule([
            dataclasses.replace(t, **changes) if t.name == name else t
            for t in self.tasks
        ])

    def without(self, name: str) -> "OverlapSchedule":
        return OverlapSchedule([t for t in self.tasks if t.name != name])

    def __iter__(self):
        return iter(self.tasks)

    def __len__(self):
        return len(self.tasks)

    def __repr__(self):
        return f"OverlapSchedule({len(self.tasks)} task(s))"


@dataclasses.dataclass(frozen=True)
class _OpRef:
    """Minimal op stand-in so AnalysisReport.add can anchor a schedule
    diagnostic to the originating PCG op."""

    guid: Optional[int]
    name: str


def build_overlap_schedule(graph, eligible: Set[Tuple[str, str]],
                           ) -> OverlapSchedule:
    """Reconstruct the overlapped step schedule for `graph`.

    eligible: the (op name, weight name) pairs on the overlapped
    reduce-scatter → sharded-update → all-gather path (the executor's
    ``_overlap_specs()`` keys). Every other weight rides the plain
    all-reduce + full update path. Weight buffers are named by tensor
    guid so weights shared between ops alias to ONE buffer — exactly
    the aliasing the donation-race check exists for.
    """
    topo = graph.topo_order()
    prod = graph.producers()
    consumers: Dict[int, List] = {}
    for op in topo:
        for t in op.inputs:
            p = prod.get(t.guid)
            if p is not None:
                consumers.setdefault(p[0].guid, []).append(op)

    tasks: List[ScheduleTask] = []
    # -- backward pass: op's bwd starts once every consumer's bwd is done
    for op in topo:
        after = tuple(sorted({f"bwd:{c.name}"
                              for c in consumers.get(op.guid, [])}))
        reads = tuple(f"param:{w.guid}" for w in op.weights)
        writes = tuple(f"grad:{op.name}.{wn}" for wn in op.weight_names)
        tasks.append(ScheduleTask(
            name=f"bwd:{op.name}", kind="backward", reads=reads,
            writes=writes, after=after, op_guid=op.guid, op_name=op.name,
        ))
    # -- per-weight gradient sync + update chains
    final: List[str] = []
    for op in topo:
        for wn, w in zip(op.weight_names, op.weights):
            key = f"{op.name}.{wn}"
            if (op.name, wn) in eligible:
                tasks.append(ScheduleTask(
                    name=f"rs:{key}", kind="reduce_scatter",
                    reads=(f"grad:{key}",), writes=(f"gshard:{key}",),
                    after=(f"bwd:{op.name}",), async_collective=True,
                    op_guid=op.guid, op_name=op.name,
                ))
                tasks.append(ScheduleTask(
                    name=f"update:{key}", kind="update",
                    reads=(f"gshard:{key}", f"param:{w.guid}",
                           f"opt:{key}"),
                    writes=(f"pshard:{key}", f"opt_next:{key}"),
                    donates=(f"opt:{key}",),
                    after=(f"rs:{key}",),
                    op_guid=op.guid, op_name=op.name,
                ))
                tasks.append(ScheduleTask(
                    name=f"ag:{key}", kind="all_gather",
                    reads=(f"pshard:{key}",),
                    writes=(f"param_next:{w.guid}",),
                    donates=(f"param:{w.guid}",),
                    after=(f"update:{key}",), async_collective=True,
                    op_guid=op.guid, op_name=op.name,
                ))
                final.append(f"ag:{key}")
            else:
                tasks.append(ScheduleTask(
                    name=f"allreduce:{key}", kind="all_reduce",
                    reads=(f"grad:{key}",), writes=(f"gsync:{key}",),
                    after=(f"bwd:{op.name}",),
                    op_guid=op.guid, op_name=op.name,
                ))
                tasks.append(ScheduleTask(
                    name=f"update:{key}", kind="update",
                    reads=(f"gsync:{key}", f"param:{w.guid}",
                           f"opt:{key}"),
                    writes=(f"param_next:{w.guid}", f"opt_next:{key}"),
                    donates=(f"param:{w.guid}", f"opt:{key}"),
                    after=(f"allreduce:{key}",),
                    op_guid=op.guid, op_name=op.name,
                ))
                final.append(f"update:{key}")
    # -- step barrier: the jitted step's outputs (updated params + opt
    # state) are data-dependent on every chain's last task — the edge
    # that guarantees no collective is still in flight when the next
    # step's forward reads the params
    reads = tuple(sorted(
        b for t in tasks for b in t.writes
        if b.startswith(("param_next:", "opt_next:"))
    ))
    tasks.append(ScheduleTask(
        name="step_end", kind="barrier", reads=reads,
        after=tuple(sorted(final)),
    ))
    return OverlapSchedule(tasks)


def _closure(schedule: OverlapSchedule) -> Tuple[Dict[str, int], List[int]]:
    """name -> index plus reach[i] = bitmask of tasks that must COMPLETE
    before task i starts (transitive closure over `after` edges)."""
    idx = {t.name: i for i, t in enumerate(schedule.tasks)}
    n = len(schedule.tasks)
    reach = [0] * n
    # iterate to a fixed point (schedules are tiny; edges may be listed
    # in any order, so one pass is not enough in general)
    changed = True
    while changed:
        changed = False
        for i, t in enumerate(schedule.tasks):
            m = reach[i]
            for a in t.after:
                j = idx.get(a)
                if j is None:
                    continue
                m |= reach[j] | (1 << j)
            if m != reach[i]:
                reach[i] = m
                changed = True
    return idx, reach


def schedule_race_diagnostics(schedule: OverlapSchedule) -> AnalysisReport:
    """FFA502: static overlap race / aliasing detection over a modelled
    step schedule. Every finding is a schedule that can read freed or
    half-written memory on a real asynchronous runtime — the bug class
    the dynamic SDC canary only catches when the race actually loses.
    """
    rep = AnalysisReport()
    idx, reach = _closure(schedule)

    def before(a: ScheduleTask, b: ScheduleTask) -> bool:
        """a is guaranteed complete before b starts."""
        return bool(reach[idx[b.name]] & (1 << idx[a.name]))

    # dangling dependency edges make every downstream guarantee void
    for t in schedule:
        for a in t.after:
            if a not in idx:
                rep.add(
                    Severity.ERROR, "FFA502",
                    f"task {t.name} depends on unknown task {a!r} — the "
                    "ordering it promises does not exist",
                    op=_OpRef(t.op_guid, t.op_name),
                )

    readers: Dict[str, List[ScheduleTask]] = {}
    writers: Dict[str, List[ScheduleTask]] = {}
    for t in schedule:
        for b in t.reads:
            readers.setdefault(b, []).append(t)
        for b in t.writes:
            writers.setdefault(b, []).append(t)

    for t in schedule:
        # (a) donation race: once t donates buffer B its storage belongs
        # to t's output — every other reader of B must be provably done
        for b in t.donates:
            for r in readers.get(b, []):
                if r.name == t.name:
                    continue  # in-place consume of its own input
                if not before(r, t):
                    rep.add(
                        Severity.ERROR, "FFA502",
                        f"{r.name} ({r.kind}) can read buffer {b!r} "
                        f"while/after {t.name} ({t.kind}) donates its "
                        "storage — the read observes reused memory "
                        "(donation race)",
                        op=_OpRef(t.op_guid, t.op_name or r.op_name),
                        fix_hint=f"order {r.name} before {t.name} (add "
                                 "the dependency edge) or stop donating "
                                 f"{b!r}",
                    )
        # (b) pending-collective read: an async collective's output is
        # complete only past a dependency edge on the collective
        if t.async_collective:
            for b in t.writes:
                for r in readers.get(b, []):
                    if r.name == t.name:
                        continue
                    if not before(t, r):
                        rep.add(
                            Severity.ERROR, "FFA502",
                            f"{r.name} ({r.kind}) reads {b!r} with no "
                            f"completion edge on the pending {t.kind} "
                            f"{t.name} — the collective may still be in "
                            "flight (overlap race)",
                            op=_OpRef(t.op_guid, t.op_name or r.op_name),
                            fix_hint=f"make {r.name} depend on {t.name}",
                        )
    # (c) unordered writer/reader or writer/writer pairs (in-place
    # update vs a concurrent reader of the old value)
    for b, ws in writers.items():
        for w in ws:
            if w.async_collective:
                continue  # rule (b) already covers async writers
            for r in readers.get(b, []):
                if r.name == w.name:
                    continue
                if not before(w, r) and not before(r, w):
                    rep.add(
                        Severity.ERROR, "FFA502",
                        f"{w.name} ({w.kind}) writes {b!r} concurrently "
                        f"with {r.name} ({r.kind}) reading it — the read "
                        "is nondeterministic (in-place update race)",
                        op=_OpRef(w.op_guid, w.op_name or r.op_name),
                        fix_hint=f"order {r.name} and {w.name}",
                    )
        for i in range(len(ws)):
            for j in range(i + 1, len(ws)):
                a, c = ws[i], ws[j]
                if not before(a, c) and not before(c, a):
                    rep.add(
                        Severity.ERROR, "FFA502",
                        f"{a.name} and {c.name} both write {b!r} with no "
                        "ordering between them", op=_OpRef(a.op_guid,
                                                           a.op_name),
                    )
    return rep
