"""Strategy files: export/import a searched parallelization strategy.

The PyTorch counterpart of flexflow_tpu/runtime/strategy_io.py (the
reference's --export-strategy / --import-strategy files, README.md:76-77,
config.h:141-142; the reference serializes per-op ParallelConfigs to a
protobuf). The file is JSON, per-op machine view + per-tensor degrees
and dtypes, in the JAX package's schema (version 3): a strategy exported
by either package is read by the other.

Imports are validated (schema version, record shape, degree-vs-device
feasibility) and fail with a typed StrategyImportError instead of a bare
KeyError deep in the apply loop.
"""
from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional

from ..ff_types import DataType
from ..pcg.graph import Graph
from ..pcg.machine_view import MachineView

logger = logging.getLogger("flexflow_tpu_torch.runtime.strategy_io")

# Bump when the on-disk record shape changes. Files declaring a NEWER
# version than we know are rejected (we can't guess fields we've never
# seen); older versions we still read.
# v2: records carry a per-op "weight_shard" field ({axis, degree} or
# null) for FSDP/ZeRO weight sharding (parallel/weight_sharding.py). A
# version-1 file that nonetheless contains sharded state (an
# OP_WEIGHT_SHARD record, or a weight_shard entry with degree > 1) is
# rejected — a pre-FSDP reader applying it would silently replicate
# state the strategy expects sharded. Replicated-only v1 files load
# unchanged.
# v3: records carry per-tensor dtype state — "output_dtypes" ([{data,
# compute, accum}] name strings, compute/accum null when unannotated)
# and "weight_dtypes" ([data name]) — so a cached strategy replays with
# its precision flow intact (analysis/precision.py annotates
# compute/accum; byte accounting and verify tolerances consume them). A
# pre-v3 file that nonetheless carries a non-default compute/accum
# annotation is rejected the same way sharded v1 state is: a pre-
# precision reader would silently replay a mixed-precision strategy at
# full width, invalidating every byte estimate it was searched under.
SCHEMA_VERSION = 3


class StrategyImportError(ValueError):
    """A strategy file failed schema/feasibility validation on import."""


def _weight_shard_of(op) -> Optional[dict]:
    """The op's weight-shard (FSDP) record: the shard axis/degree for an
    OP_WEIGHT_SHARD node, None for everything else (a target op's sharded
    weight dims already ride in weight_degrees)."""
    if getattr(op, "op_type", None) is not None \
            and op.op_type.name == "OP_WEIGHT_SHARD":
        return {"axis": "fsdp", "degree": int(op.params.shard_degree)}
    return None


def _dtype_record(t) -> dict:
    """Per-tensor dtype triple: declared storage dtype plus the precision
    annotations (analysis/precision.py), null when unannotated."""
    return {
        "data": t.data_type.name,
        "compute": t.compute_dtype.name if t.compute_dtype is not None
        else None,
        "accum": t.accum_dtype.name if t.accum_dtype is not None else None,
    }


def op_strategy_record(op, view: Optional[MachineView]) -> dict:
    """The per-op strategy record (shared by export_strategy and the
    checkpoint sidecar's topology fingerprint)."""
    return {
        "name": op.name,
        "op_type": op.op_type.name,
        "layer_guid": op.layer_guid,
        "weight_shard": _weight_shard_of(op),
        "machine_view": (
            {
                "start_device_id": view.start_device_id,
                "dim": list(view.dim),
                "stride": list(view.stride),
            }
            if view is not None
            else None
        ),
        "output_degrees": [
            [d.degree for d in t.dims] for t in op.outputs
        ],
        "weight_degrees": [
            [d.degree for d in t.dims] for t in op.weights
        ],
        "output_dtypes": [_dtype_record(t) for t in op.outputs],
        # weights keep master storage at their declared width (precision
        # annotations never touch them — see annotate_graph_precision),
        # so only the data dtype rides along
        "weight_dtypes": [w.data_type.name for w in op.weights],
    }


def export_strategy(graph: Graph, result, path: str) -> None:
    ops = []
    for op in graph.topo_order():
        view = result.views.get(op.guid) if result is not None else None
        ops.append(op_strategy_record(op, view))
    blob = {
        "version": SCHEMA_VERSION,
        "cost": getattr(result, "cost", None),
        "ops": ops,
    }
    with open(path, "w") as f:
        json.dump(blob, f, indent=1)


def _validate_record(rec, idx: int) -> None:
    if not isinstance(rec, dict):
        raise StrategyImportError(f"ops[{idx}] is not an object: {rec!r}")
    name = rec.get("name")
    if not isinstance(name, str) or not name:
        raise StrategyImportError(f"ops[{idx}] has no 'name' string")
    mv = rec.get("machine_view")
    if mv is not None:
        if not isinstance(mv, dict) or not all(
            k in mv for k in ("start_device_id", "dim", "stride")
        ):
            raise StrategyImportError(
                f"op {name!r}: machine_view must carry "
                "start_device_id/dim/stride"
            )
        if len(mv["dim"]) != len(mv["stride"]):
            raise StrategyImportError(
                f"op {name!r}: machine_view dim/stride length mismatch"
            )
    for key in ("output_degrees", "weight_degrees"):
        degs = rec.get(key, [])
        if not isinstance(degs, list) or not all(
            isinstance(t, list) and all(
                isinstance(d, int) and d >= 1 for d in t
            )
            for t in degs
        ):
            raise StrategyImportError(
                f"op {name!r}: {key} must be lists of positive ints"
            )
    ws = rec.get("weight_shard")
    if ws is not None:
        if not isinstance(ws, dict) or not isinstance(ws.get("degree"), int) \
                or ws["degree"] < 1 or not isinstance(ws.get("axis"), str):
            raise StrategyImportError(
                f"op {name!r}: weight_shard must be null or "
                "{{axis: str, degree: int >= 1}}"
            )
    for dt in rec.get("output_dtypes", []):
        if not isinstance(dt, dict) or "data" not in dt:
            raise StrategyImportError(
                f"op {name!r}: output_dtypes entries must be objects "
                "with a 'data' dtype name"
            )
        for key in ("data", "compute", "accum"):
            v = dt.get(key)
            if v is None and key != "data":
                continue
            if not isinstance(v, str) or v not in DataType.__members__:
                raise StrategyImportError(
                    f"op {name!r}: output_dtypes {key}={v!r} is not a "
                    "DataType name"
                )
    for v in rec.get("weight_dtypes", []):
        if not isinstance(v, str) or v not in DataType.__members__:
            raise StrategyImportError(
                f"op {name!r}: weight_dtypes entry {v!r} is not a "
                "DataType name"
            )


def import_strategy(path: str) -> Dict[str, dict]:
    """Load and validate a strategy file. Returns op name -> record.

    Raises StrategyImportError on malformed JSON, an unknown (newer)
    schema version, or records missing/mistyping required fields —
    instead of dying later with a bare KeyError mid-apply."""
    try:
        with open(path) as f:
            blob = json.load(f)
    except json.JSONDecodeError as e:
        raise StrategyImportError(f"{path}: not valid JSON ({e})") from e
    if not isinstance(blob, dict) or "ops" not in blob:
        raise StrategyImportError(f"{path}: missing top-level 'ops' list")
    version = blob.get("version")
    if not isinstance(version, int):
        raise StrategyImportError(f"{path}: missing integer 'version'")
    if version > SCHEMA_VERSION:
        raise StrategyImportError(
            f"{path}: schema version {version} is newer than the supported "
            f"{SCHEMA_VERSION} — produced by a newer build?"
        )
    if not isinstance(blob["ops"], list):
        raise StrategyImportError(f"{path}: 'ops' is not a list")
    out: Dict[str, dict] = {}
    for i, rec in enumerate(blob["ops"]):
        _validate_record(rec, i)
        if version < 2 and _record_has_sharded_state(rec):
            # a pre-v2 file has no schema slot for weight sharding, so a
            # sharded-state record in one is either hand-edited or written
            # by a broken exporter — applying it under v1 semantics would
            # silently replicate state the strategy expects sharded
            raise StrategyImportError(
                f"{path}: schema version {version} predates weight "
                f"sharding but op {rec.get('name')!r} carries sharded "
                "state (an OP_WEIGHT_SHARD record or a weight_shard "
                "degree > 1) — re-export the strategy with this build "
                f"(schema {SCHEMA_VERSION})"
            )
        if version < 3 and _record_has_precision_state(rec):
            raise StrategyImportError(
                f"{path}: schema version {version} predates precision "
                f"flow but op {rec.get('name')!r} carries a compute/accum "
                "dtype annotation — re-export the strategy with this "
                f"build (schema {SCHEMA_VERSION})"
            )
        if rec["name"] in out:
            logger.warning("strategy %s: duplicate op record %r (last wins)",
                           path, rec["name"])
        out[rec["name"]] = rec
    return out


def _record_has_sharded_state(rec: dict) -> bool:
    """Whether a record describes FSDP-sharded parameters/optimizer
    state: an OP_WEIGHT_SHARD op, or a weight_shard entry of degree > 1."""
    if rec.get("op_type") == "OP_WEIGHT_SHARD":
        return True
    ws = rec.get("weight_shard")
    return isinstance(ws, dict) and ws.get("degree", 1) > 1


def _record_has_precision_state(rec: dict) -> bool:
    """Whether a record carries a non-default precision annotation (a
    compute or accum dtype on any output)."""
    return any(
        isinstance(dt, dict)
        and (dt.get("compute") is not None or dt.get("accum") is not None)
        for dt in rec.get("output_dtypes", [])
    )


def _check_feasible(rec: dict, num_devices: int) -> None:
    """A record is only applicable when its degrees/view fit the live
    machine: every tensor's degree product must divide the device count,
    and the machine view must address existing devices."""
    name = rec["name"]
    for key in ("output_degrees", "weight_degrees"):
        for degs in rec.get(key, []):
            prod = 1
            for d in degs:
                prod *= d
            if prod > 1 and (prod > num_devices or num_devices % prod != 0):
                raise StrategyImportError(
                    f"op {name!r}: {key} product {prod} does not divide the "
                    f"{num_devices} available devices — the strategy was "
                    "searched for a different machine (re-search or import "
                    "a matching file)"
                )
    ws = rec.get("weight_shard")
    if ws and ws.get("degree", 1) > 1:
        deg = ws["degree"]
        if deg > num_devices or num_devices % deg != 0:
            raise StrategyImportError(
                f"op {name!r}: weight_shard degree {deg} does not divide "
                f"the {num_devices} available devices — the sharded "
                "optimizer state cannot be laid out (re-search or import "
                "a matching file)"
            )
    mv = rec.get("machine_view")
    if mv:
        last = mv["start_device_id"] + sum(
            (d - 1) * s for d, s in zip(mv["dim"], mv["stride"])
        )
        if last >= num_devices:
            raise StrategyImportError(
                f"op {name!r}: machine_view addresses device {last} but only "
                f"{num_devices} devices are available"
            )


def apply_imported_strategy(
    graph: Graph,
    strategy: Dict[str, dict],
    num_devices: Optional[int] = None,
) -> List[str]:
    """Re-apply degrees/views from an imported strategy to a freshly lowered
    PCG (ops matched by name, like the reference's config-file import).

    When `num_devices` is given, each record is validated against the live
    machine (degree products must divide it, views must address existing
    devices) before anything is mutated. Returns the list of strategy
    record names that matched NO op in the graph (also logged), so a
    renamed/partial import is visible instead of silently ignored."""
    graph_names = {op.name for op in graph.ops}
    unmatched = [name for name in strategy if name not in graph_names]
    if unmatched:
        logger.warning(
            "imported strategy: %d record(s) match no op in the graph and "
            "were skipped: %s", len(unmatched), ", ".join(sorted(unmatched))
        )
    uncovered = sorted(graph_names - set(strategy))
    if uncovered:
        logger.info(
            "imported strategy: %d graph op(s) have no record and keep "
            "their current degrees: %s", len(uncovered), ", ".join(uncovered)
        )
    if num_devices is not None:
        for name, rec in strategy.items():
            if name in graph_names:
                _check_feasible(rec, num_devices)
    for op in graph.ops:
        rec = strategy.get(op.name)
        if rec is None:
            continue
        mv = rec.get("machine_view")
        if mv:
            op.machine_view = MachineView(
                start_device_id=mv["start_device_id"],
                dim=tuple(mv["dim"]),
                stride=tuple(mv["stride"]),
            )
        for t, degs in zip(op.outputs, rec.get("output_degrees", [])):
            for d, deg in zip(t.dims, degs):
                d.degree = deg
        for w, degs in zip(op.weights, rec.get("weight_degrees", [])):
            for d, deg in zip(w.dims, degs):
                d.degree = deg
        for t, dt in zip(op.outputs, rec.get("output_dtypes", [])):
            t.data_type = DataType[dt["data"]]
            t.compute_dtype = (DataType[dt["compute"]]
                               if dt.get("compute") is not None else None)
            t.accum_dtype = (DataType[dt["accum"]]
                             if dt.get("accum") is not None else None)
        for w, name in zip(op.weights, rec.get("weight_dtypes", [])):
            w.data_type = DataType[name]
    return unmatched
