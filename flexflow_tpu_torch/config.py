"""Runtime configuration.

The PyTorch counterpart of flexflow_tpu/config.py, with the fields this
package reads, under the JAX package's names. Device counts come from
`torch.cuda`.

The dataclass has slots, so a field the port does not read (a JAX
field not ported yet) cannot be set: `cfg.unported = 1` raises
AttributeError instead of being ignored.

`device` names where a compiled model lives: "cuda" (the default, the
first card) or "cuda:N", and "cpu" only when the caller asks for it. A
config that asks for a card on a machine without one raises at
construction: the port never continues on the CPU by itself.
"""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(name: str) -> torch.device:
    """The torch device a config names. Raises when it names a card and
    this process sees none."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"device {name!r}: expected 'cuda', 'cuda:N' or 'cpu'")
    return dev


@dataclasses.dataclass(slots=True)
class FFConfig:
    """Global run configuration (reference: config.h:92-160)."""

    # fit()'s default number of passes over the data
    epochs: int = 1
    batch_size: int = 64
    # devices; 0 = all visible cards. One by default: compile() runs on
    # one device and refuses more until multi-device execution is ported
    workersPerNode: int = 1
    # strategy search (>= 0) is not ported yet: compile() refuses it;
    # -1 = the manual lowering
    search_budget: int = -1
    # bf16 compute (and KV cache) over f32 master weights
    allow_mixed_precision: bool = False
    seed: int = 0
    device: str = "cuda"
    # recompute each attention op's internals in the backward instead of
    # saving them (torch.utils.checkpoint; JAX: jax.checkpoint)
    remat: bool = False
    # train steps fit() runs as one dispatch: on a card, N steps captured
    # in one CUDA graph and replayed (JAX: one lax.scan program). 1 = one
    # eager step per batch
    iterations_per_dispatch: int = 1

    def __post_init__(self):
        dev = resolve_device(self.device)
        if self.workersPerNode == 0:
            self.workersPerNode = (torch.cuda.device_count()
                                   if dev.type == "cuda" else 1)

    @property
    def torch_device(self) -> torch.device:
        return resolve_device(self.device)
