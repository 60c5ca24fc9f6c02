"""Numerical-trust layer: strategy-equivalence verification, checkpoint
integrity checksums, an online SDC/determinism canary and structural
checks on a searched strategy.

The PyTorch counterpart of the JAX package's runtime/verify.py. An
auto-searched strategy is supposed to compute what the serial program
computes, and a trained run is supposed to compute what its step says;
a wrong substitution or a flipped bit degrades convergence silently
instead of failing. The defenses:

* **Differential strategy verifier** — `verify_strategy(model, data,
  steps=K)` runs K train steps of the compiled (searched) graph AND of a
  serial reference executor built from the same layer list, from
  identical weights and step seeds, and compares loss, the first step's
  global grad norm and the final weights under per-dtype tolerances. On
  divergence it bisects the graph's matched op prefix (both forwards
  run once, outputs probed) to name the first diverging op. Exposed as
  `fit(verify_strategy="preflight")` and standalone. The model's live
  state is not touched: both sides train copies.

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

* **SDC/determinism canary** — `CanaryConfig(every_n_steps, mode)` makes
  the resilient fit loop periodically re-execute a step on the same
  inputs and step seed from the same pre-step state and compare the two
  results bitwise (``"determinism"``, raw host bytes, bf16 included) or
  within tolerance (``"sdc"``), plus cheap per-step invariants (a
  non-finite loss, param-norm drift, the loss delta). The port's
  optimizers update in place, so the loop snapshots the state before
  every canaried step (`PCGExecutor.snapshot_state`) and restores it for
  the re-execution; JAX keeps its pre-step state alive instead. A
  violation escalates through checkpoint-and-raise
  (`CanaryMismatchError` / `InvariantViolationError`). The FaultInjector
  site ``bitflip`` corrupts one weight tensor of the first execution's
  result (or, with ``target="disk"``, the just-written checkpoint).

* **Structural strategy checks** — `validate_searched_strategy` (and
  `validate_machine_views`, which it calls: in the JAX package a
  function of runtime/elastic.py): the one strategy validator the port
  registers (search/__init__.py).
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .resilience import ResilienceError


# ----------------------------------------------------------------------
# typed errors
# ----------------------------------------------------------------------
class NotCompiledError(RuntimeError):
    """An API that needs a compiled model (executor + state) was called
    before `FFModel.compile()`."""


class ServingConfigError(ValueError):
    """A serving request or configuration the runtime cannot honour:
    a wrong input shape, a batch or beam count over the compiled
    capacity, or a generation length over the decode cap."""


class VerificationError(RuntimeError):
    """Base class for numerical-trust failures."""


class StrategyDivergenceError(VerificationError):
    """The searched strategy's execution diverged from the serial
    reference beyond tolerance. `diverging_op` names the first PCG op
    whose forward output differs (None when only the backward/optimizer
    step diverges); `verdict` carries the full comparison report."""

    def __init__(self, msg: str, *, diverging_op: Optional[str] = None,
                 verdict: Optional["StrategyVerdict"] = None):
        super().__init__(msg)
        self.diverging_op = diverging_op
        self.verdict = verdict


class CheckpointCorruptionError(VerificationError):
    """A restored tensor's bytes do not match the checksum recorded at
    save time — on-disk corruption (bad storage, truncation, bitrot).
    `tensors` names every mismatching tensor path."""

    def __init__(self, msg: str, *, path: str = "",
                 tensors: Optional[List[str]] = None):
        super().__init__(msg)
        self.path = path
        self.tensors = list(tensors or [])


class CanaryMismatchError(VerificationError, ResilienceError):
    """The SDC/determinism canary re-executed a step on identical inputs
    and state and got a different answer — non-deterministic execution or
    silent data corruption. fit() reverts to the pre-step state, flushes
    a checkpoint (checkpoint_path) and raises."""

    def __init__(self, msg: str, *, step: int = 0,
                 mismatches: Optional[List[str]] = None):
        super().__init__(msg)
        self.step = step
        self.mismatches = list(mismatches or [])
        self.checkpoint_path: Optional[str] = None


class InvariantViolationError(VerificationError, ResilienceError):
    """A cheap per-step training invariant failed (param-norm drift over
    the configured ratio, loss delta over the bound, non-finite loss).
    Same checkpoint-and-raise escalation as the canary."""

    def __init__(self, msg: str, *, step: int = 0, invariant: str = ""):
        super().__init__(msg)
        self.step = step
        self.invariant = invariant
        self.checkpoint_path: Optional[str] = None


# ----------------------------------------------------------------------
# per-dtype tolerances
# ----------------------------------------------------------------------
# (rtol, atol) for comparing two executions of the "same" math whose
# reduction/summation orders legally differ (a rewritten graph's sums vs
# the serial one's). The JAX package's table.
DTYPE_TOLERANCES: Dict[str, Tuple[float, float]] = {
    "float64": (1e-12, 1e-12),
    "float32": (2e-4, 1e-5),
    "bfloat16": (5e-2, 5e-2),
    "float16": (5e-3, 5e-3),
}
_DEFAULT_TOL = (2e-4, 1e-5)

# How much of the static FFA705 drift budget (analysis/precision.py) a
# legal reorder is allowed to consume: the verify tolerance is capped at
# this fraction of the budget. At the default budget (0.25) the cap is
# 5e-2 — exactly the bf16 table row — so the table governs until someone
# TIGHTENS the budget, and verification tightens with it (the two knobs
# share FFConfig.precision_drift_budget).
DRIFT_TO_TOLERANCE = 0.2


def _dtype_name(dtype) -> str:
    """numpy's name for a torch or numpy dtype ("bfloat16" for torch's)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def tolerance_for(dtype, rtol: Optional[float] = None,
                  atol: Optional[float] = None) -> Tuple[float, float]:
    """The (rtol, atol) pair for `dtype` (torch or numpy), with explicit
    overrides winning over the per-dtype table."""
    base = DTYPE_TOLERANCES.get(_dtype_name(dtype) if dtype is not None
                                else "float32", _DEFAULT_TOL)
    return (base[0] if rtol is None else rtol,
            base[1] if atol is None else atol)


def tolerance_from_budget(dtype_key: str,
                          drift_budget: Optional[float]) -> Tuple[float,
                                                                  float]:
    """Derive the (rtol, atol) pair for `dtype_key` from the static drift
    budget: the per-dtype table row, capped at DRIFT_TO_TOLERANCE of the
    budget. None uses the analyzer's default budget."""
    from ..analysis.precision import DEFAULT_DRIFT_BUDGET

    base = DTYPE_TOLERANCES.get(dtype_key, _DEFAULT_TOL)
    budget = DEFAULT_DRIFT_BUDGET if drift_budget is None else drift_budget
    cap = max(budget, 0.0) * DRIFT_TO_TOLERANCE
    return (min(base[0], cap), min(base[1], cap))


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


def bitflip_params(params, *, op: Optional[str] = None,
                   weight: Optional[str] = None, bit: int = 6,
                   index: int = 3):
    """Corrupt ONE weight tensor in a params tree (the FaultInjector
    ``bitflip`` site's live-state consumer). Returns (new_params,
    "op/weight"): a new tree whose one flipped tensor is a new tensor on
    the original's device, the rest shared. Targets the named op/weight,
    defaulting to the first in sorted order."""
    op_names = sorted(params)
    if not op_names:
        raise ValueError("bitflip_params: empty params tree")
    opn = op if op is not None else op_names[0]
    wd = params[opn]
    wn = weight if weight is not None else sorted(wd)[0]
    new_params = dict(params)
    new_params[opn] = dict(wd)
    new_params[opn][wn] = _bitflip_tensor(wd[wn], bit=bit, index=index)
    return new_params, f"{opn}/{wn}"


# ----------------------------------------------------------------------
# SDC / determinism canary
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CanaryConfig:
    """Online execution-integrity canary for the resilient fit loop.

    Every `every_n_steps` optimizer steps, the step is re-executed on the
    SAME inputs and step seed from the SAME pre-step state and the two
    results compared:

    * ``mode="determinism"`` — bitwise equality of the host bytes. Any
      difference means the step is non-deterministic (or a core corrupted
      one run). The flash kernels and cuBLAS GEMMs on one stream are
      deterministic; scatter-adds (`index_add_`, the embedding bags'
      backward) are not, so models with them belong in "sdc" mode.
    * ``mode="sdc"`` — per-dtype tolerance comparison (`rtol`/`atol`
      override the table). Catches large corruptions while tolerating
      benign non-determinism (e.g. non-deterministic scatter orders).

    `check_invariants` additionally enables cheap per-step sanity bounds:
    a non-finite loss, a global param norm growing more than
    `max_param_norm_ratio`x in one step, or (when set) a loss delta over
    `max_loss_delta`, each raise InvariantViolationError through
    checkpoint-and-raise. Overhead: a snapshot of the state before every
    step (the optimizers update in place), one norm and a loss fetch per
    step, and at the cadence one re-executed step plus two state copies."""

    every_n_steps: int = 100
    mode: str = "determinism"  # or "sdc"
    rtol: Optional[float] = None
    atol: Optional[float] = None
    check_invariants: bool = True
    max_param_norm_ratio: float = 50.0
    max_loss_delta: Optional[float] = None

    def __post_init__(self):
        if self.mode not in ("determinism", "sdc"):
            raise ValueError(
                f"CanaryConfig.mode must be 'determinism' or 'sdc', "
                f"got {self.mode!r}"
            )


def _as_f64(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        from ..parallel.mesh import full

        # a mesh value whole (every rank joins the gather)
        return full(leaf).detach().to("cpu", torch.float64).numpy()
    return np.asarray(leaf).astype(np.float64)


def _max_abs_diff(a, b) -> float:
    try:
        d = np.abs(_as_f64(a) - _as_f64(b))
        return float(np.nanmax(d)) if d.size else 0.0
    except (TypeError, ValueError, RuntimeError):
        return float("nan")


def _allclose(a, b, rtol: float, atol: float) -> bool:
    return bool(np.allclose(_as_f64(a), _as_f64(b), rtol=rtol, atol=atol,
                            equal_nan=True))


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same_bytes(a, b) -> bool:
    """Whether two leaves hold the same raw bytes (bf16 included). Two
    tensors on one device are compared there, viewed as integers of their
    width (the same bits, without copying both to the host: a canary
    check of the flagship's weights would otherwise move 604 MB across
    PCIe); anything else as host bytes."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.device == b.device and a.dtype == b.dtype \
            and a.element_size() in _BITS:
        if a.shape != b.shape:
            return False
        bits = _BITS[a.element_size()]
        return torch.equal(a.detach().contiguous().view(bits),
                           b.detach().contiguous().view(bits))
    return _host_view(a)[0].tobytes() == _host_view(b)[0].tobytes()


def compare_step_results(a, b, *, mode: str = "determinism",
                         rtol: Optional[float] = None,
                         atol: Optional[float] = None,
                         max_report: int = 5) -> List[str]:
    """Compare two executions' result trees (params and/or metric
    partials: nests of dicts, lists and tensors, walked as the JAX
    package's tree_util walks them, under the same path names). Returns
    mismatch descriptions (empty = consistent). Determinism mode compares
    raw bytes (bf16 included; `_same_bytes`); sdc mode uses per-dtype
    tolerances."""
    bad: List[str] = []
    for (pa, la), (_pb, lb) in zip(_leaves_with_path(a),
                                   _leaves_with_path(b)):
        if la is None or lb is None:
            continue
        name = _flat_path(pa)
        if mode == "determinism":
            if not _same_bytes(la, lb):
                bad.append(f"{name} (bitwise, max|Δ|="
                           f"{_max_abs_diff(la, lb):.3g})")
        else:
            dtype = la.dtype if isinstance(la, torch.Tensor) \
                else np.asarray(la).dtype
            r, t = tolerance_for(dtype, rtol, atol)
            if not _allclose(la, lb, r, t):
                bad.append(f"{name} (max|Δ|={_max_abs_diff(la, lb):.3g} "
                           f"> rtol={r:g}/atol={t:g})")
        if len(bad) >= max_report:
            bad.append("...")
            break
    return bad


# ----------------------------------------------------------------------
# differential strategy verifier
# ----------------------------------------------------------------------
@dataclasses.dataclass
class StrategyVerdict:
    """Result of a differential strategy verification run."""

    ok: bool
    steps: int
    loss_diffs: List[float] = dataclasses.field(default_factory=list)
    grad_norm_diff: float = 0.0
    max_param_diff: float = 0.0
    param_mismatches: List[str] = dataclasses.field(default_factory=list)
    unmatched_weights: List[str] = dataclasses.field(default_factory=list)
    diverging_op: Optional[str] = None
    validator_problems: List[str] = dataclasses.field(default_factory=list)
    rtol: float = 0.0
    atol: float = 0.0

    def summary(self) -> str:
        head = ("strategy VERIFIED" if self.ok
                else "strategy DIVERGED from serial reference")
        lines = [
            f"{head}: {self.steps} step(s), "
            f"max loss diff {max(self.loss_diffs) if self.loss_diffs else 0.0:.3g}, "
            f"grad-norm diff {self.grad_norm_diff:.3g}, "
            f"max param diff {self.max_param_diff:.3g} "
            f"(rtol={self.rtol:g}, atol={self.atol:g})"
        ]
        if self.diverging_op:
            lines.append(f"first diverging op: {self.diverging_op}")
        if self.param_mismatches:
            lines.append("param mismatches: "
                         + ", ".join(self.param_mismatches[:5]))
        if self.unmatched_weights:
            lines.append(f"{len(self.unmatched_weights)} weight(s) had no "
                         "name match between the searched and serial graphs "
                         "(substitution renamed/merged them) and were "
                         "excluded: "
                         + ", ".join(self.unmatched_weights[:5]))
        if self.validator_problems:
            lines.append("structural validator: "
                         + "; ".join(self.validator_problems[:5]))
        return "\n".join(lines)


def build_reference_executor(model):
    """A serial executor for `model`'s layer list on the model's device —
    the ground truth the searched strategy is checked against. Re-lowers
    the layers to a fresh PCG (no search, no parallel ops, degree 1
    everywhere; apply_fusion under --fusion) exactly as compile() does
    before the strategy rewrite, so op names line up with the searched
    graph's by construction, with the model's optimizer, loss, metrics,
    compute and gradient dtypes, seed, input order and constants."""
    from ..core.metrics import Metrics
    from ..parallel.executor import PCGExecutor

    if getattr(model, "executor", None) is None:
        raise NotCompiledError("verify_strategy: compile() the model first")
    ex = model.executor
    graph, _ = model._lower_layers()
    inputs = graph.input_tensors()
    ordered = [inputs[i] for i in model._input_positions]
    constants = {
        inputs[i].guid: (inputs[i], v)
        for i, v in model._constant_positions.items()
    }
    return PCGExecutor(
        graph, ex.device, optimizer=model.optimizer,
        loss_type=model.loss_type,
        metrics=Metrics(model.loss_type, model.metrics),
        compute_dtype=ex.compute_dtype, grad_dtype=ex.grad_dtype,
        seed=model.config.seed, input_order=ordered, constants=constants,
    )


def _clone_tree(tree):
    """Detached copies of every tensor of a nest of dicts."""
    return {k: (_clone_tree(v) if isinstance(v, dict)
                else v.detach().clone()) for k, v in tree.items()}


def _copy_named_state(ex, params_src, net_src):
    """A TrainState for executor `ex` whose weights and buffers are
    name-matched copies of the given trees (fresh optimizer state).
    Returns (state, unmatched) — unmatched weights keep their fresh init
    and are excluded from the comparison."""
    from ..parallel.executor import TrainState

    from ..parallel.mesh import full

    params = ex.init_params()
    unmatched: List[str] = []
    for opn, wd in params.items():
        for wn, like in wd.items():
            src = params_src.get(opn, {}).get(wn)
            if src is None or tuple(src.shape) != tuple(like.shape):
                unmatched.append(f"{opn}/{wn}")
                continue
            # a mesh weight whole: the reference runs on one device
            wd[wn] = full(src).detach().to(like.device, like.dtype).clone()
    net = ex.init_net_state()
    for opn, bufs in net.items():
        for bn, like in bufs.items():
            src = (net_src or {}).get(opn, {}).get(bn)
            if src is not None and tuple(src.shape) == tuple(like.shape):
                bufs[bn] = full(src).detach().to(like.device,
                                                 like.dtype).clone()
    return TrainState(params=params,
                      opt_state=ex.optimizer.init_state(params),
                      net_state=net), unmatched


def _matched_compare_params(a, b, skip, rtol, atol):
    """Name-matched param comparison. Returns (max_diff, mismatches)."""
    worst = 0.0
    bad: List[str] = []
    for opn, wd in a.items():
        for wn, va in wd.items():
            key = f"{opn}/{wn}"
            if key in skip:
                continue
            vb = b.get(opn, {}).get(wn)
            if vb is None or tuple(vb.shape) != tuple(va.shape):
                continue
            d = _max_abs_diff(va, vb)
            worst = max(worst, d) if np.isfinite(d) else float("inf")
            if not _allclose(va, vb, rtol, atol):
                bad.append(f"{key} (max|Δ|={d:.3g})")
    return worst, bad


@torch.no_grad()
def find_first_divergence(model, ref_ex, strat_state, ref_state, batch,
                          *, rtol: float, atol: float) -> Optional[str]:
    """Name the first PCG op whose forward output diverges between the
    searched strategy and the serial reference, by bisecting over the
    matched op prefix (both full forwards execute once; the bisection
    probes their kept outputs, so localization costs O(log n)
    comparisons, not n). None when every matched forward output agrees —
    the divergence is then in the backward/optimizer step, or the graph
    runs a generalized pipeline plan, whose stage internals live on their
    own ranks (no op-level probe)."""
    ex = model.executor
    if ex.pipeline_plan is not None:
        return None
    # training=False: localization must not depend on dropout seeds,
    # whose per-op indices differ when a substitution changed the
    # compute-op count
    vals_s = ex.apply(strat_state.params, ex._input_vals(batch[:-1]),
                      training=False, rng=None,
                      net_state=strat_state.net_state)
    vals_r = ref_ex.apply(ref_state.params, ref_ex._input_vals(batch[:-1]),
                          training=False, rng=None,
                          net_state=ref_state.net_state)
    ref_by_name = {}
    for op in ref_ex.topo:
        if not op.is_parallel_op and op.outputs:
            ref_by_name[op.name] = op
    matched = []
    for op in ex.topo:
        if op.is_parallel_op or not op.outputs:
            continue
        rop = ref_by_name.get(op.name)
        if rop is None:
            continue
        if (tuple(op.outputs[0].material_shape())
                != tuple(rop.outputs[0].material_shape())):
            continue
        matched.append((op, rop))
    if not matched:
        return None

    def diverges(i: int) -> bool:
        op, rop = matched[i]
        return not _allclose(vals_s[op.outputs[0].guid],
                             vals_r[rop.outputs[0].guid], rtol, atol)

    lo, hi = 0, len(matched) - 1
    if not diverges(hi):
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if diverges(mid):
            hi = mid
        else:
            lo = mid + 1
    op = matched[lo][0]
    return f"{op.name} ({op.op_type.name})"


def verify_strategy(model, data, *, steps: int = 2,
                    batch_size: Optional[int] = None,
                    rtol: Optional[float] = None,
                    atol: Optional[float] = None,
                    localize: bool = True,
                    raise_on_divergence: bool = False,
                    verbose: bool = False) -> StrategyVerdict:
    """Differential verification of a compiled model's parallelization
    strategy: run `steps` train steps of the compiled (searched) graph
    AND of a serial reference (`build_reference_executor`) from identical
    weights, buffers and step seeds, and compare per-step loss, the first
    step's global grad norm, and the final weights under per-dtype
    tolerances (the model's compute dtype picks the row, capped by
    config.precision_drift_budget; `rtol`/`atol` override).

    `data` is ``(x, y)`` with x an array or list of arrays, exactly as
    `fit` takes them. The model's live state is NOT advanced or mutated:
    both sides train copies, with fresh optimizer state and the step
    guard off. On divergence, `localize=True` bisects the graph's
    matched op prefix to name the first diverging op.
    `raise_on_divergence` turns a failed verdict into
    StrategyDivergenceError — what ``fit(verify_strategy="preflight")``
    uses."""
    from ..core.seeds import step_seed
    from ..parallel.executor import TrainState, global_grad_norm

    if getattr(model, "executor", None) is None or model.state is None:
        raise NotCompiledError("verify_strategy: compile() the model first")
    ex = model.executor
    x, y = data
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    bs = batch_size or model.config.batch_size
    n = xs[0].shape[0]
    if n < bs:
        raise ValueError(
            f"verify_strategy: dataset has {n} samples < batch_size {bs}"
        )
    # tolerance keyed by the model's COMPUTE dtype (mixed-precision math
    # legitimately reorders bf16 roundoff), then capped by the static
    # drift budget
    base = tolerance_from_budget(
        "bfloat16" if ex.compute_dtype is not None else "float32",
        getattr(model.config, "precision_drift_budget", None),
    )
    r = base[0] if rtol is None else rtol
    t = base[1] if atol is None else atol

    problems: List[str] = []
    views = getattr(model, "searched_views", None)
    if views:
        from ..search import run_strategy_validators

        # the machine the strategy was searched for (the port demotes
        # its winner to the one device it runs on)
        cm = getattr(model, "search_cost_model", None) \
            or model._build_cost_model()
        problems = run_strategy_validators(model.graph, views,
                                           cm.machine.num_workers)

    ref_ex = build_reference_executor(model)
    params_copy = _clone_tree(model.state.params)
    net_copy = _clone_tree(model.state.net_state or {})
    strat_state = TrainState(
        params=params_copy,
        opt_state=ex.optimizer.init_state(params_copy),
        net_state=net_copy,
    )
    ref_state, unmatched = _copy_named_state(ref_ex, model.state.params,
                                             model.state.net_state)
    skip = set(unmatched)
    # pre-step copies for divergence localization: the forward probe must
    # run from IDENTICAL weights — after K steps both sides have trained
    # through different gradients, and every op downstream of a weight
    # would look "diverged"
    init_strat = TrainState(params=_clone_tree(strat_state.params),
                            opt_state=None,
                            net_state=_clone_tree(strat_state.net_state))
    init_ref = TrainState(params=_clone_tree(ref_state.params),
                          opt_state=None,
                          net_state=_clone_tree(ref_state.net_state))
    ref_step = ref_ex.build_train_step()

    def batches():
        for i in range(n // bs):
            yield [a[i * bs:(i + 1) * bs] for a in list(xs) + [y]]

    verdict = StrategyVerdict(ok=True, steps=0, rtol=r, atol=t,
                              unmatched_weights=unmatched,
                              validator_problems=problems)
    gen = torch.Generator().manual_seed(model.config.seed + 7919)
    first_batch = None
    gnorm_diff = 0.0
    it = batches()
    saved_guard = ex.step_guard
    ex.set_step_guard(None)  # the guard-free step (JAX: _guard_free_step)
    try:
        strat_step = ex.build_train_step()
        for k in range(steps):
            try:
                batch = next(it)
            except StopIteration:
                it = batches()
                batch = next(it)
            if first_batch is None:
                first_batch = batch
            seed = step_seed(gen)
            if k == 0:
                # first-step global grad norms (one extra pass per side)
                g_s = ex.build_grad_step()(strat_state.params, batch[:-1],
                                           batch[-1], strat_state.net_state)
                g_r = ref_ex.build_grad_step()(ref_state.params,
                                               batch[:-1], batch[-1],
                                               ref_state.net_state)
                n_s = float(global_grad_norm(g_s))
                n_r = float(global_grad_norm(g_r))
                del g_s, g_r
                gnorm_diff = abs(n_s - n_r)
                if not np.isclose(n_s, n_r, rtol=r,
                                  atol=max(t, r * abs(n_r))):
                    verdict.ok = False
            strat_state, p_s = strat_step(strat_state, batch[:-1],
                                          batch[-1], seed)
            ref_state, p_r = ref_step(ref_state, batch[:-1], batch[-1],
                                      seed)
            loss_s, loss_r = float(p_s["loss"]), float(p_r["loss"])
            verdict.loss_diffs.append(abs(loss_s - loss_r))
            verdict.steps = k + 1
            if not np.isclose(loss_s, loss_r, rtol=r,
                              atol=max(t, r * abs(loss_r))):
                verdict.ok = False
    finally:
        ex.set_step_guard(saved_guard)
    verdict.grad_norm_diff = gnorm_diff
    verdict.max_param_diff, verdict.param_mismatches = \
        _matched_compare_params(strat_state.params, ref_state.params, skip,
                                r, t)
    if verdict.param_mismatches:
        verdict.ok = False
    if not verdict.ok and localize and first_batch is not None:
        verdict.diverging_op = find_first_divergence(
            model, ref_ex, init_strat, init_ref, first_batch,
            rtol=r, atol=t,
        )
    if verbose:
        from .. import obs

        obs.progress(
            "[verify] " + verdict.summary().replace("\n", "\n[verify] "),
            name="verify_verdict", cat="runtime", ok=verdict.ok,
            diverging_op=verdict.diverging_op,
        )
    if raise_on_divergence and not verdict.ok:
        raise StrategyDivergenceError(
            "searched strategy is NOT equivalent to the serial reference:\n"
            + verdict.summary(),
            diverging_op=verdict.diverging_op, verdict=verdict,
        )
    return verdict


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
