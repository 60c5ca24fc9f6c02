"""Checkpoint / resume.

The PyTorch counterpart of flexflow_tpu/runtime/checkpoint.py, in the
port's own format (the JAX package writes Orbax): full training state --
params, optimizer state, step, the stateful ops' buffers and the step
guard's counters -- copied to host tensors and stored with `torch.save`
as ``<path>/state.pt``, read back with ``torch.load(weights_only=True)``.
The state tree and the sidecar ``<path>.meta.json`` (schema version 3:
the ops' strategy records, the device topology, per-tensor crc32 of the
host bytes, and the caller's `extra_meta`, e.g. fit's resume cursor) are
the JAX package's.

A restore writes into the live tensors with ``copy_`` under no_grad and
replaces none of them: the addresses that captured CUDA graphs read (the
train scan's graph is keyed by them, and the decode step's) stay valid,
and the weights' version counters move, so the serving weight cache
(ops/common.py) refreshes its compute-dtype copies.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import List, Optional, Tuple

import torch

logger = logging.getLogger("flexflow_tpu_torch.runtime.checkpoint")

_STATE_FILE = "state.pt"


def _to_host(tree):
    """A copy of a nest of dicts, lists and tuples with every tensor
    copied to the host (a copy even for a host tensor: training updates
    the weights in place, and the checkpoint must hold this step's
    bytes)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _host_bytes(tree) -> int:
    from .verify import _leaves_with_path

    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in _leaves_with_path(tree)
               if isinstance(leaf, torch.Tensor))


def _write_state(tree, path: str) -> None:
    torch.save(tree, os.path.join(path, _STATE_FILE))


def _restore_to_host(path: str):
    """Read a checkpoint's state tree into host tensors."""
    return torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)


def save_checkpoint(model, path: str, *, step: Optional[int] = None,
                    extra_meta: Optional[dict] = None,
                    _pre_rename_hook=None) -> str:
    """Save a model's full training state. `model` is a compiled FFModel.

    Atomic: the state tree and its meta sidecar are written under tmp
    names and renamed into place last, so a crash (or an injected IOError
    — `_pre_rename_hook` is the resilience test seam, called after the
    tmp write and before the rename) never leaves a partial checkpoint at
    `path`; the half-written tmp is cleaned up on the way out.
    `extra_meta` (e.g. fit's data-loader cursor) rides in the sidecar."""
    from .. import obs
    from .elastic import topology_fingerprint
    from .strategy_io import op_strategy_record
    from .verify import CHECKSUM_ALGO, NotCompiledError, tensor_checksums

    if model.state is None:
        raise NotCompiledError(
            "save_checkpoint: model has no training state — call "
            "compile() (and restore/fit) before saving"
        )
    path = os.path.abspath(path)
    state = {
        "params": model.state.params,
        "opt_state": model.state.opt_state if model.state.opt_state
        is not None else {},
        "step": torch.tensor(step if step is not None else model.state.step,
                             dtype=torch.int64),
    }
    if model.state.net_state:
        # cross-batch buffers (BN running stats, Cache) are part of the
        # trained state — dropping them silently reverts eval behavior
        state["net_state"] = model.state.net_state
    guard = model.state.guard
    if guard is not None:
        # loss-scale / skip counters survive restarts, or a resumed run
        # would re-probe the scale it already backed off
        state["guard"] = guard.as_dict()
    views = getattr(model, "searched_views", None) or {}
    meta = {
        "version": 3,
        "ops": [
            op_strategy_record(op, views.get(op.guid))
            for op in model.graph.topo_order()
        ],
    }
    if model.executor is not None:
        meta["topology"] = topology_fingerprint(model.executor.device)
    if extra_meta:
        meta.update(extra_meta)
    host_state = _to_host(state)
    # per-tensor content checksums (runtime/verify.py): restore and the
    # offline audit re-hash the bytes, so on-disk corruption is caught by
    # name instead of silently training on garbage weights
    meta["integrity"] = {
        "algo": CHECKSUM_ALGO,
        "tensors": tensor_checksums(host_state),
    }
    tmp = f"{path}.tmp-{os.getpid()}"
    tmp_meta = tmp + ".meta.json"
    try:
        os.makedirs(tmp, exist_ok=True)
        _write_state(host_state, tmp)
        with open(tmp_meta, "w") as f:
            json.dump(meta, f)
        if _pre_rename_hook is not None:
            _pre_rename_hook()
        # swap in: unique-per-step manager paths never pre-exist; direct
        # overwrites move the old version aside so readers never see a
        # mix of the two
        old = None
        if os.path.isdir(path):
            old = f"{path}.tmp-old-{os.getpid()}"
            os.rename(path, old)
        os.rename(tmp, path)
        os.replace(tmp_meta, path + ".meta.json")
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        obs.gauge_set(
            "ff_checkpoint_bytes", _host_bytes(host_state),
            help="serialized size of the last checkpoint's state tree",
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if os.path.exists(tmp_meta):
            try:
                os.remove(tmp_meta)
            except OSError:
                pass
        raise
    return path


def load_checkpoint_meta(path: str) -> Optional[dict]:
    """The checkpoint's sidecar metadata (topology + any extra_meta the
    writer attached, e.g. fit's resume cursor), or None when absent."""
    meta_path = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)


def restore_checkpoint(model, path: str, *,
                       strict_topology: bool = True) -> int:
    """Restore the params and opt_state (and the stateful ops' buffers
    and the step guard's counters, where saved) into a compiled FFModel,
    in place. Returns the step.

    `strict_topology=False` drops the exact op-list equality check and
    matches weights by (op name, weight name) instead, keeping the fresh
    initialization for anything unmatched. The per-weight outcome lands
    in ``model._restore_report`` ({"unmatched_model",
    "unmatched_checkpoint", "replicated"}; one device replicates
    nothing). Every check runs before the first tensor is written, so a
    refused checkpoint leaves the model as it was."""
    from ..parallel.executor import GuardState
    from .verify import NotCompiledError, verify_checksums

    if model.state is None:
        raise NotCompiledError(
            "restore_checkpoint: compile() the model before restoring"
        )
    path = os.path.abspath(path)
    meta = load_checkpoint_meta(path)
    if meta is not None:
        ours = [op.name for op in model.graph.topo_order()]
        theirs = [o["name"] for o in meta["ops"]]
        if ours != theirs:
            if strict_topology:
                raise ValueError(
                    "checkpoint topology mismatch: "
                    f"checkpoint has {len(theirs)} ops, model has "
                    f"{len(ours)}; pass elastic=True to restore across a "
                    "re-searched strategy"
                )
            logger.info(
                "elastic restore: checkpoint graph (%d ops) differs from "
                "the live graph (%d ops); matching weights by name",
                len(theirs), len(ours),
            )
    report = {"unmatched_model": [], "unmatched_checkpoint": [],
              "replicated": []}
    restored = _restore_to_host(path)
    if meta is not None and meta.get("integrity"):
        # bytes-level integrity gate (runtime/verify.py): a corrupt
        # tensor raises CheckpointCorruptionError naming it, which
        # CheckpointManager.restore_latest treats like any other
        # unloadable checkpoint — fall back to the previous intact one
        verify_checksums(restored, meta["integrity"], path=path)
    params = restored["params"]
    copies: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for op_name, wd in model.state.params.items():
        for w_name, live in wd.items():
            src = params.get(op_name, {}).get(w_name) \
                if not strict_topology else params[op_name][w_name]
            if src is None:
                report["unmatched_model"].append(f"{op_name}/{w_name}")
                continue
            if tuple(src.shape) != tuple(live.shape):
                if strict_topology:
                    raise ValueError(
                        f"checkpoint weight {op_name}/{w_name} has shape "
                        f"{tuple(src.shape)}, model expects "
                        f"{tuple(live.shape)}"
                    )
                report["unmatched_model"].append(f"{op_name}/{w_name}")
                continue
            copies.append((live, src))
    for op_name in params:
        for w_name in params[op_name]:
            if w_name not in model.state.params.get(op_name, {}):
                report["unmatched_checkpoint"].append(f"{op_name}/{w_name}")
    if report["unmatched_model"]:
        logger.warning(
            "elastic restore: %d weight(s) missing from the checkpoint "
            "keep their fresh initialization: %s",
            len(report["unmatched_model"]),
            ", ".join(report["unmatched_model"]),
        )
    copies += _merge_restore(model.state.opt_state,
                             restored.get("opt_state"))
    saved_net = restored.get("net_state") or {}
    for op_name, bufs in model.state.net_state.items():
        for name, live in bufs.items():
            src = saved_net.get(op_name, {}).get(name)
            if src is not None:
                copies.append((live, src))
    guard = model.state.guard
    saved_guard = restored.get("guard")
    if saved_guard is not None:
        if guard is None:
            guard = GuardState.create(1.0, model.executor.device)
        copies += [(getattr(guard, k), saved_guard[k])
                   for k in GuardState.FIELDS]
    with torch.no_grad():
        for live, src in copies:
            live.copy_(src)
    model.state.step = int(restored.get("step", 0))
    model.state.guard = guard
    model._restore_report = report
    return model.state.step


def _leaf_pairs(live, saved, where: str):
    """(live tensor, saved tensor) for every tensor leaf of `live`, or
    ValueError where `saved` has another structure. A None leaf (SGD
    without momentum keeps {"v": None}) stays as it is, and so does a
    live tensor whose saved counterpart is None."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"{where}: keys differ")
        return [p for k in live
                for p in _leaf_pairs(live[k], saved[k], f"{where}/{k}")]
    if isinstance(live, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
            raise ValueError(f"{where}: lengths differ")
        return [p for i, (lv, sv) in enumerate(zip(live, saved))
                for p in _leaf_pairs(lv, sv, f"{where}/{i}")]
    if live is None or saved is None:
        return []
    if not isinstance(saved, torch.Tensor) or saved.shape != live.shape:
        raise ValueError(f"{where}: shape differs")
    return [(live, saved)]


def _merge_restore(live, saved):
    """The (live, saved) pairs of the optimizer state to copy; none, with
    a warning, when the saved structure differs (another optimizer): the
    fresh state stays."""
    if saved is None or live is None:
        return []
    try:
        return _leaf_pairs(live, saved, "opt_state")
    except ValueError as e:
        # structure changed (different optimizer) — keep the fresh state,
        # but say so: a silently-reset momentum surprises a resumed run
        logger.warning(
            "restore: optimizer state structure does not match the "
            "checkpoint's (%s); keeping freshly-initialized optimizer "
            "state", e,
        )
        return []
