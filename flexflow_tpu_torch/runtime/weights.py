"""Carry weights into a compiled model from numpy.

The JAX package keeps a model's weights as ``{op_name: {weight_name:
array}}`` (executor.init_params); this package uses the same names, since
both build op names the same way. `params_from_numpy` loads such a dict --
for example the JAX package's params converted with ``np.asarray`` -- into
a compiled model of this package, after checking that the two name sets
and every shape agree. `net_state_from_numpy` does the same for the
stateful ops' buffers (BatchNorm's running mean and variance,
`TrainState.net_state`), so both packages can start from one state.

A fused op (pcg/fusion.py, --fusion) keeps its chain's weights as
`step<i>/<name>`, as the JAX package's fused graph does, so JAX's fused
params carry over as they are.
"""
from __future__ import annotations

from typing import Dict, Mapping

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
