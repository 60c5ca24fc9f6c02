"""Python wrapper over the native task-graph simulator + MCMC core.

The PyTorch counterpart of the JAX package's native/simulator.py, the
same flattening: a PCG + candidate views into the array form
src/simulator.cc consumes, and simulate()/mcmc() mirroring
search/mcmc.py (which remains the pure-Python fallback and the
semantics oracle for tests).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import get_lib


class NativeSimulator:
    def __init__(self, graph, cost_model, views_per_op: Dict[int, List]):
        """views_per_op: op guid -> list of MachineView candidates."""
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable (g++ missing or "
                               "the build failed)")
        self._lib = lib
        machine = cost_model.machine
        ops = graph.topo_order()
        self.ops = ops
        idx_of = {op.guid: i for i, op in enumerate(ops)}
        prod = graph.producers()

        in_off, in_src, in_bytes = [0], [], []
        for op in ops:
            for t in op.inputs:
                p = prod.get(t.guid)
                if p is not None and p[0].guid in idx_of:
                    in_src.append(idx_of[p[0].guid])
                    nbytes = 1
                    for s in t.material_shape():
                        nbytes *= int(s)
                    in_bytes.append(nbytes * t.data_type.size)
            in_off.append(len(in_src))

        # global view table + per-op candidate lists + times
        view_key_to_id: Dict[int, int] = {}
        vfirst, vparts, vstride = [], [], []
        view_off, view_ids = [0], []
        fwd, bwd, sync = [], [], []
        self.views_per_op = []
        for op in ops:
            cands = views_per_op[op.guid]
            self.views_per_op.append(cands)
            for v in cands:
                h = v.hash()
                if h not in view_key_to_id:
                    view_key_to_id[h] = len(vfirst)
                    vfirst.append(v.start_device_id)
                    vparts.append(v.num_parts())
                    vstride.append(v.stride[0] if v.stride else 1)
                view_ids.append(view_key_to_id[h])
                cm = cost_model.measure_operator_cost(op, v)
                extra = cost_model.parallel_op_cost(op) if op.is_parallel_op else 0.0
                fwd.append(cm.forward_time + extra)
                bwd.append(cm.backward_time + extra)
                # exposed sync only: under the cost model's overlap
                # discount the hidden share rides behind backward
                # compute, so the native annealer must not re-charge it
                sync.append(max(0.0, cm.sync_time - cm.hidden_sync_time))
            view_off.append(len(view_ids))

        def arr_i64(x):
            return np.asarray(x, np.int64)

        self._arrays = dict(
            in_off=arr_i64(in_off), in_src=arr_i64(in_src),
            in_bytes=arr_i64(in_bytes), view_off=arr_i64(view_off),
            view_ids=arr_i64(view_ids), vfirst=arr_i64(vfirst),
            vparts=arr_i64(vparts), vstride=arr_i64(vstride),
            fwd=np.asarray(fwd), bwd=np.asarray(bwd), sync=np.asarray(sync),
        )
        a = self._arrays
        I64P = ctypes.POINTER(ctypes.c_int64)
        DP = ctypes.POINTER(ctypes.c_double)
        self._handle = lib.ffsim_create(
            len(ops),
            machine.num_workers,
            a["in_off"].ctypes.data_as(I64P),
            a["in_src"].ctypes.data_as(I64P),
            a["in_bytes"].ctypes.data_as(I64P),
            len(in_src),
            a["view_off"].ctypes.data_as(I64P),
            a["view_ids"].ctypes.data_as(I64P),
            len(view_ids),
            a["vfirst"].ctypes.data_as(I64P),
            a["vparts"].ctypes.data_as(I64P),
            a["vstride"].ctypes.data_as(I64P),
            len(vfirst),
            a["fwd"].ctypes.data_as(DP),
            a["bwd"].ctypes.data_as(DP),
            a["sync"].ctypes.data_as(DP),
            machine.ici_bandwidth,
            machine.ici_latency,
        )
        if not self._handle:
            raise RuntimeError("ffsim_create failed")

    def simulate(self, slots: List[int]) -> float:
        s = np.asarray(slots, np.int64)
        return self._lib.ffsim_simulate(
            self._handle, s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )

    def mcmc(self, slots: List[int], budget: int, alpha: float = 0.05,
             seed: int = 0) -> Tuple[Dict[int, object], float]:
        """Runs annealing; returns (op guid -> view, best cost)."""
        s = np.asarray(slots, np.int64)
        cost = self._lib.ffsim_mcmc(
            self._handle, s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            budget, alpha, seed,
        )
        views = {
            op.guid: self.views_per_op[i][int(s[i])]
            for i, op in enumerate(self.ops)
        }
        return views, float(cost)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ffsim_destroy(self._handle)
                self._handle = None
        except Exception:  # best-effort destructor at interpreter exit
            pass
