"""CUDA graphs: the port's counterpart of a compiled XLA program.

The JAX package jits its train scan and its decode step, so one host
dispatch runs a whole program. PyTorch runs eagerly, one host dispatch
per operator; a `torch.cuda.CUDAGraph` records the launches of one run
and replays them with one call. `CapturedGraph` adds what the port needs
around it: a warm-up on a side stream before capture (the PyTorch graph
docs ask for it; it also keeps lazy module loading, cuBLAS workspaces,
`cudaFuncSetAttribute` and any nvcc build out of the capture), launch
counts that include replays (kernels/build.py), and a capture that fails
raises: nothing falls back to eager steps.

A replay reads and writes the addresses the capture saw. Inputs go into
static buffers (`copy_` before `replay`), outputs are buffers the next
replay overwrites, and every tensor the graph reads from outside (weights,
optimizer state, KV caches, the seed table) must stay where it was.
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

from ..kernels import build


def warm_up(fn: Callable):
    """Run `fn` once on a side stream, ordered after and before the
    current stream's work, and return its result."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


class CapturedGraph:
    """One CUDA graph and the kernel launches its capture recorded."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: dict = {}
        self.outputs = None

    def capture(self, fn: Callable, *,
                capture_error_mode: str = "global"):
        """Record `fn()` (nothing runs) and keep its result, the static
        outputs each replay overwrites. Raises what the capture raises.

        Python's cycle collector is run first and held off during the
        capture: an executor and its graphs form a reference cycle, so a
        dropped model's graphs die only when the collector runs, and a
        graph destroyed while a capture is open (its cudaGraphExecDestroy)
        invalidates that capture. torch.cuda.graph no longer collects on
        entry by default."""
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with build.captured_launches(self.launches):
                with torch.cuda.graph(self.graph,
                                      capture_error_mode=capture_error_mode):
                    self.outputs = fn()
        finally:
            if was_enabled:
                gc.enable()
        return self.outputs

    def replay(self):
        """Run the recorded launches on the current stream; returns the
        static outputs."""
        self.graph.replay()
        build.add_launches(self.launches)
        return self.outputs
