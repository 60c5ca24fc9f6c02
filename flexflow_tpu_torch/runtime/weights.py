"""Carry weights into a compiled model from numpy.

The JAX package keeps a model's weights as ``{op_name: {weight_name:
array}}`` (executor.init_params); this package uses the same names, since
both build op names the same way. `params_from_numpy` loads such a dict --
for example the JAX package's params converted with ``np.asarray`` -- into
a compiled model of this package, after checking that the two name sets
and every shape agree. `net_state_from_numpy` does the same for the
stateful ops' buffers (BatchNorm's running mean and variance,
`TrainState.net_state`), so both packages can start from one state.
`train_state_from_numpy` carries a whole training state across: the
weights, the optimizer state (momentum, Adam's moments and beta_t), the
buffers, the step guard's counters and the step, so both packages can
start mid-run.

A fused op (pcg/fusion.py, --fusion) keeps its chain's weights as
`step<i>/<name>`, as the JAX package's fused graph does, so JAX's fused
params carry over as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _check(want, params, what: str) -> None:
    """Raise ValueError unless `params` has `want`'s op names, names of
    `what` (weights, buffers) and shapes ({op: {name: shape}})."""
    got = {op: set(ws) for op, ws in params.items()}
    if set(want) != set(got):
        raise ValueError(
            f"op names differ: missing {sorted(set(want) - set(got))}, "
            f"unexpected {sorted(set(got) - set(want))}")
    problems = []
    for op, ws in want.items():
        if set(ws) != got[op]:
            problems.append(f"{op}: {what} {sorted(got[op])} != "
                            f"{sorted(ws)}")
            continue
        for n, want_shape in ws.items():
            shape = tuple(np.shape(params[op][n]))
            if shape != want_shape:
                problems.append(f"{op}.{n}: shape {shape} != {want_shape}")
    if problems:
        raise ValueError(f"{what} do not match the model: "
                         + "; ".join(problems))


def params_from_numpy(model, params: Mapping[str, Mapping[str, np.ndarray]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Replace `model.params` with `params`, each weight cast to the dtype
    the model declares and placed on its device. Raises ValueError on any
    difference in op names, weight names or shapes. Returns the new
    params."""
    if model.executor is None:
        raise RuntimeError("compile() the model first")
    want = {op.name: {n: wpt for n, wpt in zip(op.weight_names, op.weights)}
            for op in model.executor.topo if op.weights}
    _check({op: {n: tuple(wpt.material_shape()) for n, wpt in ws.items()}
            for op, ws in want.items()}, params, "weights")
    model.params = {
        op: {n: torch.as_tensor(np.array(params[op][n]),
                                dtype=wpt.data_type.torch_dtype,
                                device=model.device)
             for n, wpt in ws.items()}
        for op, ws in want.items()}
    return model.params


def net_state_from_numpy(model, net_state: Mapping[str, Mapping[str,
                                                               np.ndarray]]
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copy `net_state` ({op: {buffer: array}}, e.g. the JAX package's
    `state.net_state` through ``np.asarray``) into the model's stateful
    buffers, in place and in their dtype, so a captured train scan keeps
    reading them. Raises ValueError on any difference in op names, buffer
    names or shapes. Returns `model.state.net_state`."""
    if model.state is None:
        raise RuntimeError("compile() the model first")
    mine = model.state.net_state
    _check({op: {n: tuple(b.shape) for n, b in bufs.items()}
            for op, bufs in mine.items()}, net_state, "buffers")
    with torch.no_grad():
        for op, bufs in mine.items():
            for n, b in bufs.items():
                b.copy_(torch.as_tensor(np.array(net_state[op][n])))
    return mine


def _as_tensors(tree):
    """A nest of dicts of arrays as the same nest of host tensors."""
    if isinstance(tree, Mapping):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return None if tree is None else torch.as_tensor(np.array(tree))


def train_state_from_numpy(model, params: Mapping[str, Mapping[str,
                                                              np.ndarray]],
                           opt_state: Optional[Any] = None,
                           net_state: Optional[Mapping] = None,
                           guard: Optional[Mapping[str, Any]] = None,
                           step: int = 0):
    """Turn a JAX package TrainState, given as numpy arrays, into this
    model's: `params` through `params_from_numpy`, then `opt_state` (the
    optimizer's nest, e.g. ``{"v": {op: {weight: array}}}`` or Adam's
    ``{"m", "v", "beta1_t", "beta2_t"}``), `net_state` and the step
    guard's counters (``{"loss_scale", "good_steps",
    "consecutive_skips", "total_skips"}``) copied in place, and the
    step. A guard given to a model that has none gets a fresh
    GuardState on its device. Raises ValueError where a structure or
    shape differs. Returns `model.state`."""
    from ..parallel.executor import GuardState
    from .checkpoint import _leaf_pairs

    if model.state is None:
        raise RuntimeError("compile() the model first")
    params_from_numpy(model, params)
    pairs = []
    if opt_state is not None:
        pairs += _leaf_pairs(model.state.opt_state, _as_tensors(opt_state),
                             "opt_state")
    if guard is not None:
        if model.state.guard is None:
            model.state.guard = GuardState.create(1.0, model.device)
        pairs += _leaf_pairs(model.state.guard.as_dict(), _as_tensors(guard),
                             "guard")
    if net_state is not None:
        net_state_from_numpy(model, net_state)
    with torch.no_grad():
        for live, src in pairs:
            live.copy_(src)
    model.state.step = int(step)
    return model.state
