"""Shared helpers for op forwards."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..ff_types import ActiMode
from ..parallel.mesh import version as _version


def apply_activation(mode: ActiMode, x: torch.Tensor) -> torch.Tensor:
    """Fused activations, as flexflow_tpu/ops/common.py applies them
    (jax.nn.gelu's default is the tanh approximation)."""
    if mode == ActiMode.AC_MODE_NONE:
        return x
    if mode == ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if mode == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if mode == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if mode == ActiMode.AC_MODE_GELU:
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {mode}")


class WeightCache:
    """Compute-dtype copies of weights for the inference paths.

    Under mixed precision every op casts its f32 weights to bf16 on every
    call; serving (the executor's `build_forward` and decode step) hands
    its ops this cache instead, so each weight is cast once. A copy lives
    as long as its weight and remembers the weight's version when it was
    taken (parallel/mesh.py `version`: a DTensor's counts its wrapper and
    its local tensor): training and restores update the same tensors in
    place, and when the version has moved the copy is refreshed IN PLACE
    (`copy_`), so its address stays valid inside a captured CUDA graph.
    A graph replay runs no ATen dispatch, so it moves no version: the
    train scan bumps its weights' versions after each replay
    (parallel/executor.py), and whoever replays a graph that reads
    copies calls `refresh()` first.
    The training path never uses the cache: its weights are fresh
    autograd leaves."""

    def __init__(self):
        # weight -> [copy, the weight's version when copied]
        self._entries = WeakIdKeyDictionary()

    def get(self, w: torch.Tensor, dtype) -> torch.Tensor:
        if dtype is None or w.dtype == dtype:
            return w
        try:
            version = _version(w)
        except RuntimeError:  # an inference tensor tracks no version
            return w.to(dtype)
        entry = self._entries.get(w)
        if entry is None:
            with torch.inference_mode(False), torch.no_grad():
                entry = self._entries[w] = [w.detach().to(dtype), version]
        elif entry[0].dtype != dtype:  # one cached dtype per weight
            return w.to(dtype)
        elif entry[1] != version:
            self._copy(entry, w)
        return entry[0]

    @staticmethod
    def _copy(entry, w) -> None:
        with torch.inference_mode(False), torch.no_grad():
            entry[0].copy_(w)
        entry[1] = _version(w)

    def refresh(self) -> None:
        """Bring every copy whose weight moved up to date, in place."""
        for w, entry in list(self._entries.items()):
            if _version(w) != entry[1]:
                self._copy(entry, w)


def cast_weight(ctx, w: torch.Tensor, dtype) -> torch.Tensor:
    """`w` in `dtype`: the serving cache's copy where the context carries
    one, else a fresh cast (a no-op when the dtype already matches)."""
    if ctx is not None and ctx.weight_cache is not None:
        return ctx.weight_cache.get(w, dtype)
    return w if dtype is None else w.to(dtype)
