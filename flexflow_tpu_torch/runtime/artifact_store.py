"""Persistent strategy store: a repeated compile as a cache lookup.

The PyTorch counterpart of flexflow_tpu/runtime/artifact_store.py, the
same store, keys, envelope and payload format. A compile re-runs the
Unity search from scratch unless a store holds its winner; this module
keys searched strategies by three fingerprints --

  * **graph**        — the pre-search lowering's identity
                       (``graph_fingerprint``: op names/types/shapes in
                       topological order; the same hex string for the
                       same model in both packages),
  * **topology**     — ``elastic.topology_fingerprint`` of the device the
                       model compiles on (the card's name and count),
  * **calibration**  — the resolved CalibrationStore content
                       (``calibration_fingerprint``; a re-measured machine
                       legitimately changes what the search would find),

-- plus the objective and the live device count (``make_key``), and
stores, per key: the winning strategy (the full post-search PCG and the
mesh axes it lowers onto), provenance, and the tuner's quarantine
fingerprints. The key holds the live device count, not the simulated
machine's (`search_num_workers`), exactly as the JAX package's does: one
store should serve one search machine.

The store is strategy-only. The JAX package also points its persistent
XLA compilation cache into the store where the backend trusts
deserialized executables; PyTorch has nothing to store there (eager
steps, CUDA graphs captured per process), so ``executable_cache=True``
is accepted, logs why it is unavailable and reports False. The port's
kernels are cached by their own build (build/kernels).

Robustness is the design center:

  * every entry is written tmp-then-``os.replace`` (crash-atomic) with a
    schema version and a crc32 over the canonical payload bytes;
  * a truncated/bit-flipped/unparseable entry raises the typed
    :class:`ArtifactCorruptionError` AFTER being moved into
    ``<root>/quarantine/`` and counted — consumers fall back to a fresh
    search, so a poisoned cache is never worse than no cache;
  * concurrent writers racing to populate the same key serialize writes
    through an advisory ``fcntl`` file lock (best-effort no-op where the
    platform lacks fcntl);
  * retention is bounded: ``max_entries`` with LRU eviction (access time
    is refreshed on every hit);
  * FaultInjector sites ``artifact_corruption`` / ``artifact_stale``
    (runtime/resilience.py) force each degradation leg in chaos tests.

Observability: ``ff_artifact_cache_total{event=hit|miss|corrupt|stale|
put|evict}`` plus ``artifact_cache`` events, and the store's own
``counts`` mirror of the counter.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import threading
import zlib
from typing import Any, Dict, Iterable, List, Optional, Set

logger = logging.getLogger("flexflow_tpu_torch.runtime.artifact_store")

# Bump when the on-disk entry envelope changes. Entries declaring a NEWER
# schema are treated as corrupt (we cannot guess fields we've never seen);
# older ones we keep reading.
SCHEMA_VERSION = 1

CACHE_METRIC = "ff_artifact_cache_total"
CACHE_METRIC_HELP = (
    "artifact-store lookups/updates by event "
    "(hit|miss|corrupt|stale|put|evict)"
)


class ArtifactCorruptionError(RuntimeError):
    """An artifact-store entry failed integrity validation (truncated,
    bit-flipped, unparseable, or written by a newer schema). The entry
    has already been quarantined and counted when this is raised —
    consumers fall back to a fresh search."""

    def __init__(self, msg: str, *, path: Optional[str] = None):
        super().__init__(msg)
        self.path = path


# ----------------------------------------------------------------------
# fingerprints
# ----------------------------------------------------------------------
def graph_fingerprint(graph) -> str:
    """Stable identity of a lowered (pre-search) PCG: op names, types
    and output shapes/dtypes in topological order. Machine views and
    parallel degrees are deliberately EXCLUDED — the fingerprint
    identifies the problem the search solved, not its answer, so a
    fresh lowering of the same model hits entries written by any prior
    winner for it. Layer guids are excluded too: they come off a
    process-global counter (a rebuilt model_fn's second instance would
    never hit), while op names are per-model stable and are what replay
    matches by."""
    lines = []
    for op in graph.topo_order():
        outs = ",".join(
            f"{tuple(t.material_shape())}:{t.data_type.name}"
            for t in op.outputs
        )
        lines.append(f"{op.name}|{op.op_type.name}|{outs}")
    return hashlib.sha1("\n".join(lines).encode()).hexdigest()[:16]


def topology_digest(fp: Optional[dict]) -> str:
    """Collapse an ``elastic.topology_fingerprint`` dict to a short
    stable digest (the full dict rides in the entry for mismatch
    rejection)."""
    blob = json.dumps(fp or {}, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def calibration_fingerprint(table: Optional[dict],
                            globals_: Optional[dict]) -> str:
    """Digest of the resolved calibration a compile searched under
    (per-op cost table + cost-model globals). 'none' when the analytic
    roofline stood — re-measuring the machine legitimately changes what
    the search would find, so it must change the cache key."""
    if not table and not globals_:
        return "none"
    blob = repr((sorted((table or {}).items(), key=lambda kv: repr(kv[0])),
                 sorted((globals_ or {}).items(), key=lambda kv: repr(kv[0]))))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def make_key(*, graph: str, topology: str, calibration: str,
             objective: str = "train", num_devices: int = 0) -> Dict[str, Any]:
    """The composite cache key. ``num_devices`` rides separately from
    the topology digest so a shrunk device view (elastic tests)
    and a genuinely different machine both miss cleanly."""
    return {
        "graph": graph,
        "topology": topology,
        "calibration": calibration,
        "objective": objective,
        "num_devices": int(num_devices),
    }


def key_id(key: Dict[str, Any]) -> str:
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def _canonical_payload_bytes(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


# ----------------------------------------------------------------------
# ambient store (consumers that build models through opaque model_fns
# wrap the build in `with store.ambient():` and compile() picks it up
# without plumbing; the JAX package's ReplicaSet warm spares do)
# ----------------------------------------------------------------------
_ambient = threading.local()


def get_ambient() -> Optional["ArtifactStore"]:
    return getattr(_ambient, "store", None)


class ArtifactStore:
    """On-disk, versioned strategy/artifact store. See module docstring.

    Layout::

        <root>/.lock                    advisory writer lock
        <root>/entries/<key_id>.json    one integrity-enveloped entry
        <root>/quarantine/              corrupt/stale entries moved aside
        <root>/quarantine/<scope>.q.json  persisted tuner quarantines
    """

    def __init__(self, root: str, *, max_entries: int = 64,
                 fault_injector=None, executable_cache: Optional[bool] = None):
        self.root = os.path.abspath(root)
        self.max_entries = max(1, int(max_entries))
        self.fault_injector = fault_injector
        self.counts: Dict[str, int] = {}
        self.entries_dir = os.path.join(self.root, "entries")
        self.quarantine_dir = os.path.join(self.root, "quarantine")
        os.makedirs(self.entries_dir, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)
        self._clean_stale_tmp()
        # the serialized-executable leg has no PyTorch counterpart (see
        # the module docstring): the store stays strategy-only
        self.executable_cache_enabled = False
        if executable_cache:
            logger.info(
                "artifact store: no executable cache under PyTorch (eager "
                "steps; CUDA graphs are captured per process); staying "
                "strategy-only")

    # -- integrity envelope ---------------------------------------------
    def _entry_path(self, key: Dict[str, Any]) -> str:
        return os.path.join(self.entries_dir, key_id(key) + ".json")

    def _clean_stale_tmp(self) -> None:
        for d in (self.entries_dir, self.quarantine_dir):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if ".tmp-" in name:
                    try:
                        os.remove(os.path.join(d, name))
                    except OSError:
                        pass

    @contextlib.contextmanager
    def _locked(self):
        """Advisory writer lock so replicas racing to populate the same
        key never interleave a write with an eviction. Platforms without
        fcntl (or read-only stores) degrade to best-effort: writes stay
        individually atomic via os.replace either way."""
        lock_path = os.path.join(self.root, ".lock")
        fd = None
        try:
            try:
                import fcntl

                fd = os.open(lock_path, os.O_RDWR | os.O_CREAT, 0o644)
                fcntl.flock(fd, fcntl.LOCK_EX)
            except (ImportError, OSError):
                fd = None
            yield
        finally:
            if fd is not None:
                try:
                    import fcntl

                    fcntl.flock(fd, fcntl.LOCK_UN)
                except (ImportError, OSError):
                    pass
                os.close(fd)

    def _count(self, event: str, **extra) -> None:
        from .. import obs

        # local mirror of the counter: harnesses read hit/corrupt counts
        # without needing a telemetry session
        self.counts[event] = self.counts.get(event, 0) + 1
        obs.count(CACHE_METRIC, help=CACHE_METRIC_HELP, event=event)
        obs.event("artifact_cache", cat="runtime", event=event, **extra)

    def _quarantine_file(self, path: str, reason: str) -> None:
        """Move a bad entry aside so it can never poison another lookup;
        keep the bytes for postmortem rather than deleting evidence."""
        if not os.path.exists(path):
            return
        dest = os.path.join(
            self.quarantine_dir,
            f"{os.path.basename(path)}.{reason}-{os.getpid()}",
        )
        try:
            os.replace(path, dest)
        except OSError:
            try:
                os.remove(path)
            except OSError:
                pass

    def _read_entry(self, path: str, key: Dict[str, Any]) -> dict:
        """Parse + integrity-check one entry file. Raises
        ArtifactCorruptionError (envelope broken) or returns the payload
        dict; a key mismatch raises _StaleEntry for the caller to count."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
            envelope = json.loads(raw.decode("utf-8"))
        except (OSError, ValueError, UnicodeDecodeError) as e:
            raise ArtifactCorruptionError(
                f"artifact entry {path} is unreadable: {e}", path=path
            ) from e
        if not isinstance(envelope, dict):
            raise ArtifactCorruptionError(
                f"artifact entry {path} is not an object", path=path
            )
        schema = envelope.get("schema")
        if not isinstance(schema, int) or schema > SCHEMA_VERSION:
            raise ArtifactCorruptionError(
                f"artifact entry {path} declares schema {schema!r} "
                f"(supported <= {SCHEMA_VERSION})", path=path
            )
        payload = envelope.get("payload")
        if not isinstance(payload, dict):
            raise ArtifactCorruptionError(
                f"artifact entry {path} has no payload object", path=path
            )
        crc = zlib.crc32(_canonical_payload_bytes(payload)) & 0xFFFFFFFF
        if crc != envelope.get("crc32"):
            raise ArtifactCorruptionError(
                f"artifact entry {path} failed crc32 "
                f"({envelope.get('crc32')!r} recorded, {crc} computed) — "
                "truncated or bit-flipped on disk", path=path
            )
        if envelope.get("key") != key:
            raise _StaleEntry(
                f"artifact entry {path} was written for a different key "
                f"({envelope.get('key')!r} != {key!r})"
            )
        return payload

    # -- lookup / store --------------------------------------------------
    def get(self, key: Dict[str, Any]) -> Optional[dict]:
        """The payload stored under `key`, or None on a (counted) miss.
        Corrupt entries are quarantined, counted and raised as
        ArtifactCorruptionError; fingerprint-mismatched ones are
        quarantined, counted as stale and returned as a miss. A hit
        refreshes the entry's LRU access time."""
        path = self._entry_path(key)
        fi = self.fault_injector
        if fi is not None and os.path.exists(path):
            if fi.fire("artifact_stale", None) is not None:
                self._quarantine_file(path, "stale")
                self._count("stale", key=key_id(key), injected=True)
                return None
            if fi.fire("artifact_corruption", None) is not None:
                self._quarantine_file(path, "corrupt")
                self._count("corrupt", key=key_id(key), injected=True)
                raise ArtifactCorruptionError(
                    f"artifact entry {path}: injected corruption "
                    "(FaultInjector site artifact_corruption)", path=path,
                )
        if not os.path.exists(path):
            self._count("miss", key=key_id(key))
            return None
        try:
            payload = self._read_entry(path, key)
        except _StaleEntry as e:
            logger.warning("%s", e)
            self._quarantine_file(path, "stale")
            self._count("stale", key=key_id(key), detail=str(e)[:300])
            return None
        except ArtifactCorruptionError as e:
            logger.warning("artifact store: quarantining corrupt entry: %s",
                           e)
            self._quarantine_file(path, "corrupt")
            self._count("corrupt", key=key_id(key), detail=str(e)[:300])
            raise
        try:
            os.utime(path)  # LRU access time
        except OSError:
            pass
        self._count("hit", key=key_id(key))
        return payload

    def put(self, key: Dict[str, Any], payload: dict) -> str:
        """Atomically write `payload` under `key` (last writer wins — both
        racers computed a valid strategy for the same key) and evict past
        ``max_entries``, LRU-first."""
        path = self._entry_path(key)
        envelope = {
            "schema": SCHEMA_VERSION,
            "key": key,
            "crc32": zlib.crc32(_canonical_payload_bytes(payload))
            & 0xFFFFFFFF,
            "payload": payload,
        }
        with self._locked():
            tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(envelope, f, indent=1)
            os.replace(tmp, path)
            self._evict_locked()
        self._count("put", key=key_id(key))
        return path

    def note_stale(self, key: Dict[str, Any], reason: str) -> None:
        """A consumer found the entry inapplicable on replay (records
        matched no op, validators failed, mesh axes don't fit): count it
        and quarantine the entry so the next boot goes straight to a
        fresh search instead of re-tripping the same fallback."""
        path = self._entry_path(key)
        self._quarantine_file(path, "stale")
        self._count("stale", key=key_id(key), detail=reason[:300])

    def entries(self) -> List[str]:
        try:
            return sorted(
                n for n in os.listdir(self.entries_dir)
                if n.endswith(".json") and ".tmp-" not in n
            )
        except OSError:
            return []

    def _evict_locked(self) -> None:
        names = self.entries()
        if len(names) <= self.max_entries:
            return
        by_age = []
        for n in names:
            p = os.path.join(self.entries_dir, n)
            try:
                by_age.append((os.path.getmtime(p), p))
            except OSError:
                continue
        by_age.sort()
        for _, p in by_age[: max(0, len(by_age) - self.max_entries)]:
            try:
                os.remove(p)
            except OSError:
                continue
            self._count("evict", entry=os.path.basename(p))

    # -- tuner quarantine persistence ------------------------------------
    def _quarantine_set_path(self, scope: str) -> str:
        return os.path.join(self.quarantine_dir, f"{scope}.q.json")

    def load_quarantine(self, scope: str) -> Set[str]:
        """The persisted strategy-fingerprint quarantine set for `scope`
        (graph+topology digest). A corrupt quarantine file degrades to
        the empty set (counted) — losing quarantines re-proposes a bad
        candidate, which the tuner's own gates then re-reject; crashing
        here would lose the whole run."""
        path = self._quarantine_set_path(scope)
        if not os.path.exists(path):
            return set()
        try:
            payload = self._read_entry(path, {"quarantine_scope": scope})
            fps = payload.get("fingerprints", [])
            return {fp for fp in fps if isinstance(fp, str)}
        except (_StaleEntry, ArtifactCorruptionError) as e:
            logger.warning(
                "artifact store: quarantine set %s unreadable (%s); "
                "starting empty", path, e,
            )
            self._quarantine_file(path, "corrupt")
            self._count("corrupt", scope=scope, kind="quarantine_set")
            return set()

    def add_quarantine(self, scope: str, fingerprints: Iterable[str]) -> None:
        """Merge `fingerprints` into the persisted set for `scope`
        (read-merge-write under the writer lock, so two replicas
        quarantining concurrently lose nothing)."""
        with self._locked():
            merged = self.load_quarantine(scope) | set(fingerprints)
            payload = {"fingerprints": sorted(merged)}
            envelope = {
                "schema": SCHEMA_VERSION,
                "key": {"quarantine_scope": scope},
                "crc32": zlib.crc32(_canonical_payload_bytes(payload))
                & 0xFFFFFFFF,
                "payload": payload,
            }
            path = self._quarantine_set_path(scope)
            tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(envelope, f, indent=1)
            os.replace(tmp, path)

    # -- consumer plumbing ----------------------------------------------
    @contextlib.contextmanager
    def ambient(self):
        """Make this store the thread-ambient one for the duration:
        compile() calls with no explicit ``artifact_store=`` pick it up
        (how the JAX package's ReplicaSet routes opaque model_fns through
        the store)."""
        prev = getattr(_ambient, "store", None)
        _ambient.store = self
        try:
            yield self
        finally:
            _ambient.store = prev


class _StaleEntry(ValueError):
    """Internal: entry envelope is intact but keyed for something else."""


# ----------------------------------------------------------------------
# strategy payloads (the compile()/tuner write-through format)
# ----------------------------------------------------------------------
# Bump when the payload's graph serialization changes. A replay only
# accepts its own version: the payload is a FULL post-search PCG (nodes,
# edges, per-dim sharding state), so a field we didn't write can't be
# guessed and a field we no longer read can't be trusted. Version
# mismatch degrades to stale -> fresh search, never to a wrong replay.
# v4: output records carry compute_dtype/accum_dtype (precision-flow
# annotations, analysis/precision.py) so a cache hit replays with the
# byte accounting and verify tolerances it was searched under.
STRATEGY_PAYLOAD_SCHEMA = 4


def _dim_to_json(d) -> list:
    return [int(d.size), int(d.degree), int(d.parallel_idx),
            1 if d.is_replica_dim else 0, getattr(d, "axis_tag", None)]


def _dim_from_json(rec):
    from ..pcg.parallel_tensor import ParallelDim

    size, degree, pidx, replica, tag = rec
    return ParallelDim(size=int(size), degree=int(degree),
                       parallel_idx=int(pidx),
                       is_replica_dim=bool(replica), axis_tag=tag)


def _param_classes() -> dict:
    from ..parallel.parallel_ops import (
        AllToAllParams,
        CombineParams,
        FusedParallelOpParams,
        ReductionParams,
        RepartitionParams,
        ReplicateParams,
    )
    from ..parallel.weight_sharding import WeightShardParams

    return {
        cls.__name__: cls
        for cls in (RepartitionParams, CombineParams, ReplicateParams,
                    ReductionParams, AllToAllParams, FusedParallelOpParams,
                    WeightShardParams)
    }


def _params_to_json(params) -> Optional[dict]:
    """Serialize a parallel op's frozen params dataclass. Returns None
    when the class isn't in the known parallel-params vocabulary — the
    caller then refuses to serialize the graph (a constructible replay
    needs every inserted op's params)."""
    import dataclasses

    classes = _param_classes()
    cls = type(params).__name__
    if cls not in classes:
        return None
    fields = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if f.name == "stages":  # FusedParallelOpParams: nested records
            v = [_params_to_json(s) for s in v]
            if any(s is None for s in v):
                return None
        fields[f.name] = v
    return {"cls": cls, "fields": fields}


def _params_from_json(rec: dict):
    from .strategy_io import StrategyImportError

    classes = _param_classes()
    cls = classes.get(rec.get("cls"))
    if cls is None:
        raise StrategyImportError(
            f"stored parallel op has unknown params class {rec.get('cls')!r}"
        )
    fields = dict(rec.get("fields") or {})
    if "stages" in fields:
        fields["stages"] = tuple(
            _params_from_json(s) for s in fields["stages"]
        )
    return cls(**fields)


def strategy_payload(graph, views: Optional[dict], *, cost=None,
                     mesh_axes: Dict[str, int],
                     provenance: Optional[dict] = None) -> dict:
    """Serialize a searched winner as a store payload: the FULL
    post-search PCG — every node (including search-inserted
    Repartition/Combine/Reduction/WeightShard ops and their params),
    its edges, and per-dim sharding state (degree, mesh-axis index,
    replica flag, axis tag) — plus the mesh axes the winner lowered
    onto, so a hit rebuilds the exact searched graph and mesh without
    re-deriving anything.

    Op records alone are NOT enough: the search inserts resharding ops
    and retensors outputs (partial-sum replica dims), and the lowering
    maps dims to mesh axes through parallel_idx — replaying just
    name-matched degrees onto a fresh lowering loses all three and
    either fails validation or silently lowers replicated.

    Raises ValueError when the graph isn't serializable (an inserted op
    with params outside the known vocabulary) — callers treat the write
    as best-effort."""
    views = views or {}
    topo = graph.topo_order()
    inputs = graph.input_tensors()
    input_pos = {t.guid: i for i, t in enumerate(inputs)}
    out_ref = {}  # tensor guid -> ("node", producer name, output index)
    for op in topo:
        for i, t in enumerate(op.outputs):
            out_ref[t.guid] = ["node", op.name, i]
    nodes = []
    for op in topo:
        refs = []
        for t in op.inputs:
            if t.guid in out_ref:
                refs.append(out_ref[t.guid])
            elif t.guid in input_pos:
                refs.append(["input", input_pos[t.guid], 0])
            else:
                raise ValueError(
                    f"op {op.name!r} consumes a tensor that is neither a "
                    "graph input nor another op's output"
                )
        params = None
        if op.is_parallel_op:
            params = _params_to_json(op.params)
            if params is None:
                raise ValueError(
                    f"parallel op {op.name!r} carries unserializable "
                    f"params {type(op.params).__name__}"
                )
        view = views.get(op.guid) or getattr(op, "machine_view", None)
        nodes.append({
            "name": op.name,
            "op_type": op.op_type.name,
            "params": params,
            "inputs": refs,
            "outputs": [
                {"dtype": t.data_type.name,
                 "compute_dtype": (t.compute_dtype.name
                                   if t.compute_dtype is not None else None),
                 "accum_dtype": (t.accum_dtype.name
                                 if t.accum_dtype is not None else None),
                 "dims": [_dim_to_json(d) for d in t.dims]}
                for t in op.outputs
            ],
            "weights": [[_dim_to_json(d) for d in w.dims]
                        for w in op.weights],
            "machine_view": (
                {"start_device_id": view.start_device_id,
                 "dim": list(view.dim), "stride": list(view.stride)}
                if view is not None else None
            ),
        })
    return {
        "kind": "strategy",
        "strategy_schema": STRATEGY_PAYLOAD_SCHEMA,
        "cost": cost,
        "mesh_axes": {str(k): int(v) for k, v in (mesh_axes or {}).items()},
        "inputs": [[_dim_to_json(d) for d in t.dims] for t in inputs],
        "nodes": nodes,
        "provenance": provenance or {},
    }


def _check_degrees_feasible(name: str, dim_lists, num_devices: int) -> None:
    from .strategy_io import StrategyImportError

    for dims in dim_lists:
        prod = 1
        for d in dims:
            prod *= int(d[1])
        if prod > 1 and (prod > num_devices or num_devices % prod != 0):
            raise StrategyImportError(
                f"op {name!r}: degree product {prod} does not divide the "
                f"{num_devices} available devices"
            )


def replay_strategy(graph, payload: dict, *, num_devices: int):
    """Rebuild a stored winner around a freshly lowered PCG.

    Compute ops are reused from `graph` by name (they carry the weights,
    initializers and params a payload can't serialize); search-inserted
    parallel ops are reconstructed from their stored params; every
    tensor's sharding state (degrees, mesh-axis indices, replica dims,
    axis tags) and every machine view comes from the payload. Returns
    (rebuilt_graph, views_by_guid, mesh_axes, cost).

    Raises StrategyImportError when the entry cannot be applied soundly —
    wrong payload version, node set that doesn't cover the fresh
    lowering (the winner rewrote compute ops this model doesn't have),
    shapes that don't line up, degrees/views infeasible for the live
    machine, or a rebuilt graph that fails the structural validators.
    Callers treat all of those as a STALE entry and fall back to a fresh
    search; the fresh lowering may have been mutated by a partial replay
    and must be re-lowered. A structurally invalid strategy never
    reaches an executor."""
    from ..ff_types import DataType, OperatorType
    from ..pcg.graph import Graph
    from ..pcg.op import PCGOp
    from ..pcg.parallel_tensor import ParallelTensor
    from ..pcg.machine_view import MachineView
    from .strategy_io import StrategyImportError

    def _prec_of(name, srec):
        """Decode the stored precision annotations (None = unannotated)."""
        out = []
        for key in ("compute_dtype", "accum_dtype"):
            v = srec.get(key)
            if v is None:
                out.append(None)
                continue
            try:
                out.append(DataType[v])
            except KeyError:
                raise StrategyImportError(
                    f"op {name!r}: unknown {key} {v!r}"
                )
        return out

    if payload.get("kind") != "strategy":
        raise StrategyImportError(
            f"artifact payload kind {payload.get('kind')!r} is not a "
            "strategy"
        )
    schema = payload.get("strategy_schema")
    if schema != STRATEGY_PAYLOAD_SCHEMA:
        raise StrategyImportError(
            f"artifact strategy schema {schema!r} != supported "
            f"{STRATEGY_PAYLOAD_SCHEMA} — written by a different build"
        )
    mesh_axes = payload.get("mesh_axes") or {}
    prod = 1
    for v in mesh_axes.values():
        prod *= int(v)
    if prod < 1 or prod > num_devices:
        raise StrategyImportError(
            f"artifact mesh axes {mesh_axes} need {prod} devices, have "
            f"{num_devices}"
        )
    nodes = payload.get("nodes") or []
    if not nodes:
        raise StrategyImportError("artifact strategy carries no nodes")

    fresh_ops = {}
    for op in graph.ops:
        if op.name in fresh_ops:
            raise StrategyImportError(
                f"fresh lowering has duplicate op name {op.name!r}"
            )
        fresh_ops[op.name] = op
    stored_names = {n.get("name") for n in nodes}
    missing = sorted(set(fresh_ops) - stored_names)
    if missing:
        raise StrategyImportError(
            f"{len(missing)} fresh op(s) have no stored node (e.g. "
            f"{missing[:3]}) — the entry was written for a different model"
        )

    # graph inputs: match stored input slots to fresh input tensors by
    # ordinal, falling back to shape+dtype signature (parallel-op
    # insertion can reorder first-consumer positions)
    fresh_inputs = graph.input_tensors()
    stored_inputs = payload.get("inputs") or []
    if len(stored_inputs) != len(fresh_inputs):
        raise StrategyImportError(
            f"stored graph has {len(stored_inputs)} input(s), fresh "
            f"lowering has {len(fresh_inputs)}"
        )
    taken = [False] * len(fresh_inputs)
    input_map = {}
    for i, dims in enumerate(stored_inputs):
        sizes = [int(d[0]) for d in dims if not d[3]]
        cand = None
        if i < len(fresh_inputs) and not taken[i] and \
                [d.size for d in fresh_inputs[i].dims
                 if not d.is_replica_dim] == sizes:
            cand = i
        else:
            for j, t in enumerate(fresh_inputs):
                if not taken[j] and [d.size for d in t.dims
                                     if not d.is_replica_dim] == sizes:
                    cand = j
                    break
        if cand is None:
            raise StrategyImportError(
                f"stored graph input {i} (sizes {sizes}) matches no fresh "
                "input tensor"
            )
        taken[cand] = True
        t = fresh_inputs[cand]
        t.dims = [_dim_from_json(d) for d in dims]
        input_map[i] = t

    g2 = Graph()
    tensors = {}  # ("node", name, idx) -> ParallelTensor
    views = {}
    for node in nodes:
        name = node.get("name")
        try:
            resolved = []
            for kind, a, b in node.get("inputs", []):
                resolved.append(input_map[a] if kind == "input"
                                else tensors[(a, int(b))])
        except KeyError as e:
            raise StrategyImportError(
                f"op {name!r} references undefined tensor {e} — stored "
                "graph is not topologically consistent"
            )
        outs = node.get("outputs") or []
        _check_degrees_feasible(
            name,
            [o["dims"] for o in outs] + list(node.get("weights") or []),
            num_devices,
        )
        op = fresh_ops.get(name)
        if op is not None:
            # reuse the fresh compute op: weights/initializers/params ride
            # along; only wiring + sharding state come from the store
            if op.op_type.name != node.get("op_type"):
                raise StrategyImportError(
                    f"op {name!r} is {op.op_type.name} in the fresh "
                    f"lowering but {node.get('op_type')!r} in the entry"
                )
            if len(resolved) != len(op.inputs):
                raise StrategyImportError(
                    f"op {name!r}: stored input count {len(resolved)} != "
                    f"fresh {len(op.inputs)}"
                )
            op.inputs = resolved
            if len(outs) != len(op.outputs):
                raise StrategyImportError(
                    f"op {name!r}: stored output count {len(outs)} != "
                    f"fresh {len(op.outputs)}"
                )
            for t, srec in zip(op.outputs, outs):
                new_dims = [_dim_from_json(d) for d in srec["dims"]]
                old_n = 1
                for d in t.dims:
                    if not d.is_replica_dim:
                        old_n *= d.size
                new_n = 1
                for d in new_dims:
                    if not d.is_replica_dim:
                        new_n *= d.size
                if old_n != new_n:
                    raise StrategyImportError(
                        f"op {name!r}: stored output volume {new_n} != "
                        f"fresh {old_n}"
                    )
                t.dims = new_dims
                t.compute_dtype, t.accum_dtype = _prec_of(name, srec)
            wrecs = node.get("weights") or []
            if len(wrecs) != len(op.weights):
                raise StrategyImportError(
                    f"op {name!r}: stored weight count {len(wrecs)} != "
                    f"fresh {len(op.weights)}"
                )
            for w, dims in zip(op.weights, wrecs):
                if [d.size for d in w.dims] != [int(d[0]) for d in dims]:
                    raise StrategyImportError(
                        f"op {name!r}: stored weight shape "
                        f"{[int(d[0]) for d in dims]} != fresh "
                        f"{[d.size for d in w.dims]}"
                    )
                w.dims = [_dim_from_json(d) for d in dims]
        else:
            # search-inserted parallel op: reconstruct from stored params
            try:
                op_type = OperatorType[node.get("op_type")]
            except KeyError:
                raise StrategyImportError(
                    f"op {name!r} has unknown op_type "
                    f"{node.get('op_type')!r}"
                )
            if node.get("params") is None:
                raise StrategyImportError(
                    f"op {name!r} matches no fresh op and carries no "
                    "constructible params — the entry was written for a "
                    "different model"
                )
            op = PCGOp(op_type, _params_from_json(node["params"]),
                       resolved, name=name)
            for srec in outs:
                try:
                    dtype = DataType[srec["dtype"]]
                except KeyError:
                    raise StrategyImportError(
                        f"op {name!r}: unknown output dtype "
                        f"{srec.get('dtype')!r}"
                    )
                t = ParallelTensor(
                    dims=[_dim_from_json(d) for d in srec["dims"]],
                    data_type=dtype,
                )
                t.compute_dtype, t.accum_dtype = _prec_of(name, srec)
                t.owner_op = op
                op.outputs.append(t)
        mv = node.get("machine_view")
        if mv is not None:
            last = mv["start_device_id"] + sum(
                (d - 1) * s for d, s in zip(mv["dim"], mv["stride"])
            )
            if last >= num_devices:
                raise StrategyImportError(
                    f"op {name!r}: machine_view addresses device {last} "
                    f"but only {num_devices} devices are available"
                )
            op.machine_view = MachineView(
                start_device_id=mv["start_device_id"],
                dim=tuple(mv["dim"]), stride=tuple(mv["stride"]),
            )
            views[op.guid] = op.machine_view
        for i, t in enumerate(op.outputs):
            tensors[(name, i)] = t
        g2.add_op(op)

    from ..search import run_strategy_validators

    problems = run_strategy_validators(g2, views, num_devices)
    if problems:
        raise StrategyImportError(
            "stored strategy failed structural validation for the live "
            "machine: " + "; ".join(problems[:5])
        )
    return g2, views, {str(k): int(v) for k, v in mesh_axes.items()}, \
        payload.get("cost")
