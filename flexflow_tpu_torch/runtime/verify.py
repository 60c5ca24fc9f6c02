"""Numerical-trust layer: checkpoint integrity checksums and structural
checks on a searched strategy.

The PyTorch counterpart of the JAX package's runtime/verify.py, two of
its parts:

* **Checkpoint integrity** — `save_checkpoint` writes per-tensor crc32 +
  dtype/shape checksums into the meta sidecar; `restore_checkpoint`
  verifies them and raises a typed `CheckpointCorruptionError` naming the
  corrupt tensor, which makes `CheckpointManager.restore_latest` fall back
  to the previous intact checkpoint. `verify_checkpoint(path)` is the
  offline audit (`python -m flexflow_tpu_torch.runtime.verify <path>`).
  The checksums hash a tensor's host bytes as the JAX package hashes a
  numpy array's, under the same names (``params/<op>/<weight>``,
  ``opt_state/v/<op>/<weight>``), so the same state gives the same
  record in both packages. The FaultInjector site ``bitflip`` with
  ``target="disk"`` corrupts a just-written checkpoint
  (`corrupt_checkpoint_tensor`) so the restore-time gate is exercised.

* **Structural strategy checks** — `validate_searched_strategy` (and
  `validate_machine_views`, which it calls: in the JAX package a
  function of runtime/elastic.py): the one strategy validator the port
  registers (search/__init__.py).

Not ported yet (ROADMAP queue 1 item 5): the differential strategy
verifier (`verify_strategy`, `compare_step_results`) and the SDC /
determinism canary.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


# ----------------------------------------------------------------------
# typed errors
# ----------------------------------------------------------------------
class NotCompiledError(RuntimeError):
    """An API that needs a compiled model (executor + state) was called
    before `FFModel.compile()`."""


class VerificationError(RuntimeError):
    """Base class for numerical-trust failures."""


class CheckpointCorruptionError(VerificationError):
    """A restored tensor's bytes do not match the checksum recorded at
    save time — on-disk corruption (bad storage, truncation, bitrot).
    `tensors` names every mismatching tensor path."""

    def __init__(self, msg: str, *, path: str = "",
                 tensors: Optional[List[str]] = None):
        super().__init__(msg)
        self.path = path
        self.tensors = list(tensors or [])


# ----------------------------------------------------------------------
# checkpoint integrity checksums
# ----------------------------------------------------------------------
CHECKSUM_ALGO = "crc32"


def _leaves_with_path(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf of a nest of dicts, lists and tuples,
    dict keys in sorted order as jax.tree_util flattens them; None is a
    leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def _flat_path(path) -> str:
    """A stable human-readable key for a leaf path:
    ``params/dense_1/kernel``, ``opt_state/v/...``."""
    return "/".join(str(k) for k in path)


def _host_view(leaf) -> Tuple[np.ndarray, str]:
    """(a C-contiguous numpy array holding the leaf's bytes, the leaf's
    dtype name as numpy spells it). bfloat16, which numpy lacks, is
    viewed as int16: the bytes are what is hashed."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, str(arr.dtype)


def _array_crc(arr) -> int:
    return zlib.crc32(_host_view(arr)[0]) & 0xFFFFFFFF


def tensor_checksums(tree) -> Dict[str, dict]:
    """Per-tensor content checksums for a host-side state tree:
    ``{flat_path: {"crc32": int, "dtype": str, "shape": [..]}}``. Only
    array leaves are recorded (None optimizer slots skip)."""
    out: Dict[str, dict] = {}
    for path, leaf in _leaves_with_path(tree):
        if leaf is None:
            continue
        arr, dtype = _host_view(leaf)
        out[_flat_path(path)] = {
            "crc32": _array_crc(arr),
            "dtype": dtype,
            "shape": list(arr.shape),
        }
    return out


def verify_checksums(tree, integrity: dict, *, path: str = "") -> None:
    """Check a restored host tree against the sidecar's ``integrity``
    record. Raises CheckpointCorruptionError naming every tensor whose
    bytes/dtype/shape differ from what was written, or that went missing
    entirely."""
    recorded = integrity.get("tensors", {})
    live = tensor_checksums(tree)
    bad: List[str] = []
    for name, rec in recorded.items():
        got = live.get(name)
        if got is None:
            bad.append(f"{name} (missing from checkpoint)")
        elif (got["crc32"] != rec["crc32"] or got["dtype"] != rec["dtype"]
              or list(got["shape"]) != list(rec["shape"])):
            bad.append(name)
    if bad:
        raise CheckpointCorruptionError(
            f"checkpoint {path or '<tree>'} failed integrity verification: "
            f"{len(bad)} corrupt tensor(s): " + ", ".join(sorted(bad)),
            path=path, tensors=sorted(bad),
        )


def verify_checkpoint(path: str) -> dict:
    """Offline integrity audit of one checkpoint directory. Returns
    ``{"ok", "path", "checked", "corrupt", "has_integrity"}``; checkpoints
    without the integrity sidecar report ``has_integrity=False`` and
    ok=True (nothing to verify against). Runnable standalone:
    ``python -m flexflow_tpu_torch.runtime.verify <path>``."""
    from .checkpoint import _restore_to_host, load_checkpoint_meta

    path = os.path.abspath(path)
    meta = load_checkpoint_meta(path) or {}
    integrity = meta.get("integrity")
    report = {"ok": True, "path": path, "checked": 0, "corrupt": [],
              "has_integrity": integrity is not None}
    if integrity is None:
        return report
    tree = _restore_to_host(path)
    report["checked"] = len(integrity.get("tensors", {}))
    try:
        verify_checksums(tree, integrity, path=path)
    except CheckpointCorruptionError as e:
        report["ok"] = False
        report["corrupt"] = e.tensors
    return report


# ----------------------------------------------------------------------
# bit flips (SDC simulation)
# ----------------------------------------------------------------------
def bitflip_array(arr, *, bit: int = 6, index: int = 3) -> np.ndarray:
    """A host copy of `arr` with one bit flipped in its raw byte stream.
    The default (bit 6 of byte 3) lands in a float32 element's exponent."""
    a = np.array(arr, copy=True)
    if a.nbytes == 0:
        return a
    flat = a.reshape(-1).view(np.uint8)
    flat[index % flat.size] ^= np.uint8(1 << (bit % 8))
    return a


def _bitflip_tensor(t: torch.Tensor, *, bit: int, index: int) -> torch.Tensor:
    """`bitflip_array` for a host tensor of any dtype (bfloat16 too)."""
    out = t.detach().clone().contiguous()
    raw = out.reshape(-1).view(torch.uint8)
    if raw.numel():
        raw[index % raw.numel()] ^= 1 << (bit % 8)
    return out


def corrupt_checkpoint_tensor(path: str, *, tensor: Optional[str] = None,
                              bit: int = 6, index: int = 3) -> str:
    """Flip one bit of one stored tensor in an on-disk checkpoint WITHOUT
    touching its integrity sidecar — the disk-corruption half of the
    ``bitflip`` fault site (``target="disk"``). Re-serializes the loaded
    tree, so the corruption lives at the tensor level. Targets the named
    params path (``<op>/<weight>``), defaulting to the first in sorted
    order. Returns the corrupted tensor's params path."""
    from .checkpoint import _restore_to_host, _write_state

    tree = _restore_to_host(path)
    params = tree.get("params") if isinstance(tree, dict) else None
    if not params:
        raise ValueError(f"checkpoint {path} has no params tree to corrupt")
    if tensor is None:
        target_path, leaf = next(_leaves_with_path(params))
        name = _flat_path(target_path)
    else:
        name = tensor
        leaf = params
        for part in name.split("/"):
            leaf = leaf[part]
    node = params
    parts = name.split("/")
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = _bitflip_tensor(leaf, bit=bit, index=index)
    _write_state(tree, path)
    return "params/" + name


# ----------------------------------------------------------------------
# structural strategy validator (registered with the search hook)
# ----------------------------------------------------------------------
def validate_machine_views(views: Dict, num_devices: int) -> List[str]:
    """Check every searched MachineView addresses only live devices --
    every device each view enumerates, not just its bounding ids (a
    strided view can step over a dead device while its first/last ids
    look fine). Returns violation strings (empty = valid)."""
    bad = []
    for guid, view in (views or {}).items():
        if view is None:
            continue
        try:
            ids = sorted(view.device_ids())
        except Exception:  # malformed view: fall back to bound arithmetic
            last = view.start_device_id + sum(
                (d - 1) * s for d, s in zip(view.dim, view.stride)
            )
            ids = [view.start_device_id, last]
        dead = [d for d in ids if d < 0 or d >= num_devices]
        if not dead:
            continue
        bad.append(
            f"op {guid}: view {view!r} addresses device"
            f"{'s' if len(dead) > 1 else ''} "
            f"{dead if len(dead) > 1 else dead[0]} of {num_devices}"
        )
    return bad


def validate_searched_strategy(graph, views, num_devices: int) -> List[str]:
    """Structural checks on a searched strategy: every MachineView must
    address only live devices, and no tensor's total parallel degree may
    exceed the device count. Registered as the strategy validator
    (search.register_strategy_validator) so compile() flags a search
    result it will demote before it is lowered."""
    problems = list(validate_machine_views(views or {}, num_devices))
    for op in getattr(graph, "ops", []) or []:
        for tensor in op.outputs:
            degree = 1
            for d in getattr(tensor, "dims", ()):
                degree *= max(1, int(getattr(d, "degree", 1)))
            if degree > num_devices:
                problems.append(
                    f"op {op.name}: output degree product {degree} exceeds "
                    f"{num_devices} device(s)"
                )
    return problems


def _main(argv: List[str]) -> int:
    import json as _json

    if not argv:
        print("usage: python -m flexflow_tpu_torch.runtime.verify "
              "<checkpoint-path> [...]")
        return 2
    rc = 0
    for p in argv:
        rep = verify_checkpoint(p)
        print(_json.dumps(rep, indent=2))
        if not rep["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
