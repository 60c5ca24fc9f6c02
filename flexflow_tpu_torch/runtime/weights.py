"""Carry weights into a compiled model from numpy.

The JAX package keeps a model's weights as ``{op_name: {weight_name:
array}}`` (executor.init_params); this package uses the same names, since
both build op names the same way. `params_from_numpy` loads such a dict --
for example the JAX package's params converted with ``np.asarray`` -- into
a compiled model of this package, after checking that the two name sets
and every shape agree.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
    got = {op: set(ws) for op, ws in params.items()}
    if set(want) != set(got):
        raise ValueError(
            f"op names differ: missing {sorted(set(want) - set(got))}, "
            f"unexpected {sorted(set(got) - set(want))}")
    problems = []
    for op, ws in want.items():
        if set(ws) != got[op]:
            problems.append(f"{op}: weights {sorted(got[op])} != "
                            f"{sorted(ws)}")
            continue
        for n, wpt in ws.items():
            shape = tuple(np.shape(params[op][n]))
            if shape != tuple(wpt.material_shape()):
                problems.append(f"{op}.{n}: shape {shape} != "
                                f"{tuple(wpt.material_shape())}")
    if problems:
        raise ValueError("weights do not match the model: "
                         + "; ".join(problems))
    model.params = {
        op: {n: torch.as_tensor(np.array(params[op][n]),
                                dtype=wpt.data_type.torch_dtype,
                                device=model.device)
             for n, wpt in ws.items()}
        for op, ws in want.items()}
    return model.params
