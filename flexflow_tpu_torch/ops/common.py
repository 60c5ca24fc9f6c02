"""Shared helpers for op forwards."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ff_types import ActiMode


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
